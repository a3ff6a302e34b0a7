"""repro_torch's megakernels over a problem axis against the JAX package, on
the CPU: the stacked plans' ``make_block_step`` (one launch for all P
problems on the card, the plain batched twin here) against ``jax.vmap``
of the JAX plan's block step (its Pallas megakernel in interpret mode, the
problems a leading grid axis); the plain batched twins against P calls of
the 2-D twin; ``BatchedSinkhorn(inner_steps=8)`` against the JAX package's
``BatchedSinkhorn(use_pallas=True, inner_steps=8)``; and a NaN lane that
leaves the other lanes' results unchanged.

The same numpy inputs go to both packages (``JAX_PLATFORMS=cpu``). Bars:
the block step within 1e-6 + 1e-6 |value| in the log domain (f, g, t)
and within 1e-6 of max |value| on the scaling carries, what the
reference's block step meets against its own unfused steps; at
momentum 1.3 the scaling carries within 3e-6 of max |value|: eight
over-relaxed geometric means (two float32 powers each) put the two
packages up to 1.9e-6 apart there, and 3.7e-7 at momentum 1. The
block-end errors, L1 distances between unit-mass marginals whose float32
floor is about m ulps of 1/m, within 1e-6 absolute. The twins within 1e-6
of max |value| (the same arithmetic, the products batched); the engine's
lanes with ``n_iter`` equal and cost 1e-6 relative in float32, 1e-5 under
``precision="bf16"``. The CUDA kernels themselves are held against these
twins on the card by chip_smoke.py (phase 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.geometry import FactoredPositive as JFactored
from repro.kernels.ops import geometry_ops as j_geometry_ops
from repro_torch.core import BatchedSinkhorn
from repro_torch.kernels import ref
from repro_torch.kernels.ops import stacked_ops

EPS = 0.5
P, N, M, R = 3, 40, 32, 12
INNER = 4
MODES = {"scaling": "factored", "log": "log_factored"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at these sizes
    the port is op-overhead bound, and torch's pool otherwise contends
    with XLA's on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32)).contiguous()


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _inputs(seed=0, p=P, n=N, m=M, r=R):
    """Stacked log-factors (log U(0.05, 1)) and uniform weights, problem 1
    with three dead atoms a side."""
    rng = np.random.default_rng(seed)
    lxi = np.log(rng.uniform(0.05, 1.0, (p, n, r))).astype(np.float32)
    lzt = np.log(rng.uniform(0.05, 1.0, (p, m, r))).astype(np.float32)
    a = np.full((p, n), 1.0, np.float32)
    b = np.full((p, m), 1.0, np.float32)
    a[1, 5:8] = 0.0
    b[1, 2:5] = 0.0
    a /= a.sum(1, keepdims=True)
    b /= b.sum(1, keepdims=True)
    return lxi, lzt, a, b


def _start(mode, a, b):
    """The cold start both block steps lift into their carry: u = 1 (0 on
    dead atoms), v = 1 in scaling space; f = 0 (-inf on dead atoms), g = 0
    in the log domain."""
    if mode == "scaling":
        return np.where(a > 0, 1.0, 0.0).astype(np.float32), \
            np.ones_like(b)
    return np.where(a > 0, 0.0, -np.inf).astype(np.float32), \
        np.zeros_like(b)


def _close(got, want, atol=0.0, rtol=0.0, rel_to_max=0.0):
    """Non-finite entries equal; finite ones within ``atol + rtol |want|
    + rel_to_max max |want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    if fin.any():
        w = want[fin]
        err = np.abs(got[fin] - w)
        bar = atol + rtol * np.abs(w) + rel_to_max * np.abs(w).max()
        assert np.all(err <= bar), (err.max(), bar.max())


@pytest.mark.parametrize("momentum", [1.0, 1.3])
@pytest.mark.parametrize("mode", ["scaling", "log"])
def test_stacked_block_step_matches_vmapped_jax(mode, momentum):
    """Two block steps of 4 iterations from the cold start, all P problems
    at once, against ``jax.vmap`` of the JAX plan's block step."""
    lxi, lzt, a, b = _inputs()
    kind = MODES[mode]
    if mode == "scaling":
        fx, fz = np.exp(lxi), np.exp(lzt)
        spec = {"kind": kind, "xi": _t(fx), "zeta": _t(fz)}
    else:
        fx, fz = lxi, lzt
        spec = {"kind": kind, "log_xi": _t(fx), "log_zeta": _t(fz)}
    z0, z1 = _start(mode, a, b)

    def one(x, z, a_, b_, c0, c1):
        geom = (JFactored(xi=x, zeta=z, eps=EPS) if mode == "scaling"
                else JFactored(log_xi=x, log_zeta=z, eps=EPS))
        plan = j_geometry_ops(geom, mode=mode, backend="interpret")
        step, init = plan.make_block_step(a_, b_, inner_steps=INNER,
                                          momentum=momentum)
        carry = init(c0, c1)
        errs = []
        for _ in range(2):
            carry, err = step(carry)
            errs.append(err)
        return carry, jnp.stack(errs)

    jcarry, jerrs = jax.jit(jax.vmap(one))(_j(fx), _j(fz), _j(a), _j(b),
                                           _j(z0), _j(z1))
    plan = stacked_ops(spec, problems=P, eps=EPS, mode=mode)
    assert plan.block_admits(N, M, P)
    step, init = plan.make_block_step(_t(a), _t(b), inner_steps=INNER,
                                      momentum=momentum)
    carry = init(_t(z0), _t(z1))
    errs = []
    for _ in range(2):
        carry, err = step(carry)
        assert tuple(err.shape) == (P,)
        errs.append(err)
    kw = (dict(rel_to_max=1e-6 if momentum == 1.0 else 3e-6)
          if mode == "scaling" else dict(atol=1e-6, rtol=1e-6))
    for got, want in zip(carry, jcarry):
        want = np.asarray(want)
        got = got.numpy().reshape(want.shape)
        for p in range(P):
            _close(got[p], want[p], **kw)
    _close(torch.stack(errs, 1).numpy(), np.asarray(jerrs), atol=1e-6)


@pytest.mark.parametrize("momentum", [1.0, 1.3])
@pytest.mark.parametrize("mode", ["scaling", "log"])
def test_batched_twins_are_the_2d_twin_a_problem(mode, momentum):
    """``sinkhorn_block_ref`` / ``log_sinkhorn_block_ref`` on (P, ...)
    operands against P calls of the same function on (n, r) operands: the
    carries within 1e-6 of max |value|, one error a problem within 1e-6
    absolute."""
    lxi, lzt, a, b = (_t(v) for v in _inputs(seed=1))
    a, b = a[..., None], b[..., None]
    if mode == "scaling":
        xi, zeta = lxi.exp(), lzt.exp()
        u0 = torch.where(a > 0, 1.0, 0.0)
        v0 = torch.ones_like(b)
        s0 = ref.feature_matvec_ref(zeta, ref.feature_contract_ref(xi, u0))
        args = (xi, zeta, a, b, u0, v0, s0)
        block = ref.sinkhorn_block_ref
        kw = dict(inner_steps=INNER, momentum=momentum)
    else:
        loga, logb = torch.log(a), torch.log(b)
        f0 = torch.where(a > 0, 0.0, -torch.inf)
        g0 = torch.where(b > 0, 0.0, -torch.inf)
        t0 = ref.log_feature_contract_ref(lxi, f0 / EPS)
        args = (lxi, lzt, loga, logb, b, f0, g0, t0)
        block = ref.log_sinkhorn_block_ref
        kw = dict(inner_steps=INNER, eps=EPS, momentum=momentum)
    got = block(*args, **kw)
    assert tuple(got[3].shape) == (P,)
    for p in range(P):
        want = block(*(x[p] for x in args), **kw)
        assert want[3].dim() == 0
        for g_, w_ in zip(got[:3], want[:3]):
            _close(g_[p].numpy(), w_.numpy(), rel_to_max=1e-6)
        _close(got[3][p].numpy(), want[3].numpy(), atol=1e-6)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("method", ["factored", "log_factored"])
def test_engine_block_cadence_matches_reference(method, precision):
    """``BatchedSinkhorn(inner_steps=8)`` takes the batched block step on
    every lane; each lane stops where the JAX engine's lane stops."""
    lxi, lzt, a, b = _inputs(seed=2)
    ka, kb = (np.exp(lxi), np.exp(lzt)) if method == "factored" \
        else (lxi, lzt)
    kw = dict(eps=EPS, method=method, tol=1e-6, max_iter=2000,
              precision=precision)
    want = japi.BatchedSinkhorn(use_pallas=True, inner_steps=8, **kw) \
        .solve_stacked(_j(ka), _j(kb), _j(a), _j(b))
    got = BatchedSinkhorn(inner_steps=8, **kw).solve_stacked(
        _t(ka), _t(kb), _t(a), _t(b))
    rtol = 1e-6 if precision == "highest" else 1e-5
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    assert np.all(got.n_iter.numpy() % 8 == 0)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=rtol)


@pytest.mark.parametrize("method", ["factored", "log_factored"])
def test_nan_lane_leaves_other_lanes_unchanged(method):
    """A problem whose factor holds a NaN row stops at its first check and
    changes no bit of the other lanes' results."""
    lxi, lzt, a, b = _inputs(seed=3)
    ka, kb = (np.exp(lxi), np.exp(lzt)) if method == "factored" \
        else (lxi, lzt)
    eng = BatchedSinkhorn(eps=EPS, method=method, tol=1e-6, max_iter=2000,
                          inner_steps=8)
    clean = eng.solve_stacked(_t(ka), _t(kb), _t(a), _t(b))
    bad = ka.copy()
    bad[1, 4] = np.nan
    poisoned = eng.solve_stacked(_t(bad), _t(kb), _t(a), _t(b))
    assert int(poisoned.n_iter[1]) == 8
    assert not bool(torch.isfinite(poisoned.cost[1]))
    for field in ("cost", "n_iter", "f", "g"):
        x, y = getattr(clean, field), getattr(poisoned, field)
        for p in (0, 2):
            assert torch.equal(x[p], y[p]), field
