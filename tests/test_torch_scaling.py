"""repro_torch's scaling-space slice (Algorithm 1) against the JAX package,
on the CPU.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode, its fused plan with ``use_pallas=True``) and through the
port with ``device="cpu"``, where every kernel runs its plain PyTorch
version. The CUDA kernels themselves are held against those plain versions
on the card by chip_smoke.py. Tolerances: kernels and the megakernel's
carries within 1e-5 of their max |value| (summation order differs), its
block-end error rtol 1e-5; the plan's iterates within 1e-5 of max |value|
and its marginal error (an L1 distance between unit-mass marginals) within
1e-5; solves cost rtol 1e-5, u and v within 1e-5 of max |value|, |d n_iter|
<= 1 (slice 1's bounds, ``tests/test_torch_solve.py``); values rtol 1e-5
(a divergence within 1e-5 of its largest term) and gradients within 1e-5
of max |grad|. bf16 factors are rounded once in torch and handed to both
packages as the same bf16 values.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.divergence import (
    sinkhorn_divergence_features as j_div_features,
    sinkhorn_divergence_gaussian as j_div_gaussian,
)
from repro.core.features import GaussianFeatureMap as JFeatureMap
from repro.core.features import gaussian_log_features as j_log_features
from repro.core.geometry import FactoredPositive as JFactored
from repro.core.geometry import GaussianPointCloud as JGaussian
from repro.core.grad import rot_factored as j_rot_factored
from repro.core.objective import ExecutionPolicy as JPolicy
from repro.core.objective import OTObjective as JObjective
from repro.core.sinkhorn import sinkhorn_geometry as j_sinkhorn_geometry
from repro.kernels.fused_loop import sinkhorn_block_pallas
from repro.kernels.kermatvec import (
    feature_contract_pallas,
    feature_matvec_pallas,
    sinkhorn_halfstep_pallas,
)
from repro.kernels.ops import geometry_ops as j_geometry_ops
from repro_torch import convert
from repro_torch.core import (
    EpsSchedule,
    OTObjective,
    OTProblem,
    rot_factored,
    sinkhorn_divergence_features,
    sinkhorn_divergence_gaussian,
    sinkhorn_factored,
    sinkhorn_geometry,
    solve,
    solve_annealed,
)
from repro_torch.core.features import gaussian_q
from repro_torch.kernels import (
    feature_contract,
    feature_matvec,
    ref,
    sinkhorn_block,
    sinkhorn_halfstep,
)
from repro_torch.kernels.fused_loop import block_plan_fits
from repro_torch.kernels.ops import geometry_ops, observe_plan_selection

REL = 1e-5


def _bf16_values(arr):
    """``arr`` rounded to bfloat16 once, as float32 numpy."""
    return torch.as_tensor(arr).to(torch.bfloat16).float().numpy()


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype).contiguous()


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _close_to_max(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    scale = float(np.max(np.abs(want[fin]))) if fin.any() else 0.0
    err = float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0
    assert err <= rel * scale, (err, scale)


def _features(seed, n, r, dtype=torch.float32):
    """Positive features U(0, 1) + 0.05, at the storage precision."""
    x = (np.random.default_rng(seed).uniform(size=(n, r)) + 0.05).astype(
        np.float32)
    return _bf16_values(x) if dtype == torch.bfloat16 else x


DTYPES = [torch.float32, torch.bfloat16]
KERNEL_SHAPES = [(1001, 3, 1), (1001, 129, 3), (33, 3, 3), (33, 129, 1)]


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


# ---------------------------------------------------------------------------
# The three kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,r,B", KERNEL_SHAPES)
def test_feature_contract_matches_pallas(n, r, B, dtype):
    xi = _features(n + r, n, r, dtype)
    u = np.random.default_rng(B).uniform(size=(n, B)).astype(np.float32)
    u[n // 3] = 0.0                          # a dead atom's scaling
    got = feature_contract(_t(xi, dtype), _t(u)).numpy()
    assert got.shape == (r, B)
    for split in (False, True):
        want = feature_contract_pallas(_j(xi, _jdt(dtype)), _j(u),
                                       interpret=True, split_reduce=split)
        _close_to_max(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,r,B", KERNEL_SHAPES)
def test_sinkhorn_halfstep_matches_pallas(n, r, B, dtype):
    xi = _features(n * 3 + r, n, r, dtype)
    rng = np.random.default_rng(n + B)
    t = rng.uniform(size=(r, B)).astype(np.float32)
    marg = np.full((n, B), 1.0 / n, np.float32)
    marg[n // 2] = 0.0                       # a zero-weight atom
    got = sinkhorn_halfstep(_t(xi, dtype), _t(t), _t(marg)).numpy()
    want = np.asarray(sinkhorn_halfstep_pallas(_j(xi, _jdt(dtype)), _j(t),
                                               _j(marg), interpret=True))
    assert got.shape == (n, B) and np.all(got[n // 2] == 0.0)
    _close_to_max(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n,r,B", KERNEL_SHAPES)
def test_feature_matvec_matches_pallas(n, r, B, dtype):
    xi = _features(n * 5 + r, n, r, dtype)
    t = np.random.default_rng(r + B).uniform(size=(r, B)).astype(np.float32)
    got = feature_matvec(_t(xi, dtype), _t(t)).numpy()
    want = feature_matvec_pallas(_j(xi, _jdt(dtype)), _j(t), interpret=True)
    assert got.shape == (n, B)
    _close_to_max(got, want)


def test_halfstep_divide_is_float32():
    """An all-zero row gives inf over a positive marginal and NaN over a
    zero one, as float32 does; a zero weight on a positive row gives 0."""
    xi = np.ones((4, 3), np.float32)
    xi[1] = 0.0
    xi[2] = 0.0
    marg = np.array([[0.5], [0.25], [0.0], [0.0]], np.float32)
    got = sinkhorn_halfstep(_t(xi), _t(np.ones((3, 1))), _t(marg)).numpy()
    assert got[0, 0] == np.float32(0.5) / np.float32(3.0)
    assert got[1, 0] == np.inf and np.isnan(got[2, 0]) and got[3, 0] == 0.0


# ---------------------------------------------------------------------------
# The scaling megakernel
# ---------------------------------------------------------------------------


def _block_inputs(n, m, r, dtype, dead, seed=0):
    """Features exp(1.5 N(0, 1)) (a wide range, so a few iterations stay
    far from convergence), weights with ``dead`` zero-weight atoms a side,
    and the carry at u = v = 1."""
    rng = np.random.default_rng(seed)
    xi, zt = (np.exp(1.5 * rng.standard_normal(shape)).astype(np.float32)
              for shape in ((n, r), (m, r)))
    if dtype == torch.bfloat16:
        xi, zt = _bf16_values(xi), _bf16_values(zt)
    a = np.ones((n, 1), np.float32)
    b = np.ones((m, 1), np.float32)
    if dead:
        a[[1, n // 2][:dead]] = 0.0
        b[[0, m - 1][:dead]] = 0.0
    a, b = a / a.sum(), b / b.sum()
    u0 = np.ones((n, 1), np.float32)
    v0 = np.ones((m, 1), np.float32)
    s0 = (zt @ (xi.T @ u0)).astype(np.float32)
    return xi, zt, a, b, u0, v0, s0


@pytest.mark.parametrize("momentum", [1.0, 1.3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_sinkhorn_block_matches_pallas(dtype, momentum):
    """Two iterations keep the block-end error (an L1 norm of v s - b) far
    above the float32 cancellation floor it reaches near convergence,
    where a relative bound would measure rounding; the plan test below
    runs the megakernel for 12 iterations."""
    args = _block_inputs(37, 53, 13, dtype, dead=2)
    want = sinkhorn_block_pallas(
        *(_j(x, _jdt(dtype)) if i < 2 else _j(x) for i, x in enumerate(args)),
        inner_steps=2, momentum=momentum, interpret=True)
    got = sinkhorn_block(
        *(_t(x, dtype) if i < 2 else _t(x) for i, x in enumerate(args)),
        inner_steps=2, momentum=momentum)
    for g, w in zip(got[:3], want[:3]):
        _close_to_max(g.numpy(), w)
    assert np.all(got[0].numpy()[[1, 18]] == 0.0)      # dead atoms stay 0
    assert float(got[3]) == pytest.approx(float(want[3]), rel=REL)


def test_sinkhorn_block_is_the_plain_loop():
    """One block of k iterations is k plain steps of the carry."""
    xi, zt, a, b, u, v, s = (_t(x) for x in _block_inputs(20, 24, 7,
                                                           torch.float32, 1))
    u1, v1, s1, err = ref.sinkhorn_block_ref(xi, zt, a, b, u, v, s,
                                             inner_steps=3, momentum=1.3)
    for _ in range(3):
        u, v, s, _ = ref.sinkhorn_block_ref(xi, zt, a, b, u, v, s,
                                            inner_steps=1, momentum=1.3)
    assert torch.equal(u1, u) and torch.equal(v1, v) and torch.equal(s1, s)
    assert float(err) == float(torch.sum(torch.abs(v * s - b)))


@pytest.mark.parametrize("n,m,r,dtype,admitted", [
    (256, 256, 128, torch.float32, False),     # 262,144 B of factors
    (256, 256, 128, torch.bfloat16, True),     # 139,264 B by the JAX count
    (176, 176, 128, torch.float32, True),
    (2048, 2048, 128, torch.bfloat16, False),
])
def test_scaling_block_admission_is_the_jax_budget(n, m, r, dtype, admitted):
    from repro.kernels.backend import resolve_backend
    from repro.kernels.fused_loop import block_plan_fits as j_fits
    assert block_plan_fits(n, m, r, 1, dtype) is admitted
    assert j_fits(n, m, r, 1, _jdt(dtype),
                  backend=resolve_backend("gpu-triton")) is admitted


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def _clouds(seed, n, m, d, r, eps):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 1.0).astype(np.float32)
    y = (math.sqrt(0.1) * rng.standard_normal((m, d))).astype(np.float32)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    fm = JFeatureMap(r=r, d=d, eps=eps, R=R)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((r, d))).astype(
        np.float32)
    return x, y, u, R


def _geometries(kind, eps=1.0):
    n, m, r = 70, 50, 24
    if kind == "gaussian":
        x, y, u, R = _clouds(0, n, m, 3, r, eps)
        return (JGaussian.build(_j(x), _j(y), _j(u), eps=eps, R=R),
                convert.gaussian_point_cloud(x, y, u, eps=eps, R=R,
                                             device="cpu"))
    xi, zt = _features(5, n, r), _features(6, m, r)
    if kind == "factored":
        return (JFactored(xi=_j(xi), zeta=_j(zt), eps=eps),
                convert.factored_positive(xi=xi, zeta=zt, eps=eps,
                                          device="cpu"))
    lxi, lzt = np.log(xi), np.log(zt)
    return (JFactored(log_xi=_j(lxi), log_zeta=_j(lzt), eps=eps),
            convert.factored_positive(log_xi=lxi, log_zeta=lzt, eps=eps,
                                      device="cpu"))


@pytest.mark.parametrize("step_kind,momentum", [("step", 1.0), ("step", 1.3),
                                                ("block", 1.3)])
@pytest.mark.parametrize("kind", ["gaussian", "factored", "log_factored"])
def test_scaling_plan_iterates_match_jax(kind, step_kind, momentum):
    jgeom, tgeom = _geometries(kind)
    jplan = j_geometry_ops(jgeom, mode="scaling", backend="interpret")
    tplan = geometry_ops(tgeom, mode="scaling")
    assert (tplan.mode, tplan.kind) == ("scaling", kind)
    n, m = tgeom.shape
    a = np.full(n, 1.0 / n, np.float32)
    a[3] = 0.0
    a /= a.sum()
    b = np.full(m, 1.0 / m, np.float32)
    if step_kind == "step":
        jstep, jinit = jplan.make_step(_j(a), _j(b), momentum=momentum)
        tstep, tinit = tplan.make_step(_t(a), _t(b), momentum=momentum)
    else:
        jstep, jinit = jplan.make_block_step(_j(a), _j(b), inner_steps=4,
                                             momentum=momentum)
        tstep, tinit = tplan.make_block_step(_t(a), _t(b), inner_steps=4,
                                             momentum=momentum)
    jc = jinit(jnp.ones(n), jnp.ones(m))
    tc = tinit(torch.ones(n), torch.ones(m))
    for _ in range(3):
        jc, jerr = jstep(jc)
        tc, terr = tstep(tc)
        for got, want in zip(tc, jc):
            _close_to_max(got.numpy(), want)
        # the error is an L1 distance between unit-mass marginals: it moves
        # by about the iterates' own difference, so it is held absolutely
        assert abs(float(terr) - float(jerr)) <= REL


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _assert_solve_match(tres, jres):
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=REL)
    assert abs(int(tres.n_iter) - int(jres.n_iter)) <= 1
    _close_to_max(tres.u.numpy(), jres.u)
    _close_to_max(tres.v.numpy(), jres.v)


SOLVE_CASES = {
    "features": dict(),
    "momentum": dict(momentum=1.3),
    "dead_atoms": dict(dead=True),
    "dead_atoms_momentum": dict(dead=True, momentum=1.3),
    "bf16": dict(precision="bf16"),
    "inner_steps": dict(inner_steps=4),
}


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_factored_solve_matches_jax(case):
    kw = dict(SOLVE_CASES[case])
    dead = kw.pop("dead", False)
    n, m, r, eps = 90, 70, 24, 0.5
    xi, zt = _features(11, n, r), _features(12, m, r)
    a = np.full(n, 1.0, np.float32)
    b = np.full(m, 1.0, np.float32)
    if dead:
        a[[0, 40]] = 0.0
        b[[9]] = 0.0
    a, b = a / a.sum(), b / b.sum()
    jres = j_sinkhorn_geometry(JFactored(xi=_j(xi), zeta=_j(zt), eps=eps),
                               _j(a), _j(b), tol=1e-5, use_pallas=True, **kw)
    prob = convert.ot_problem(
        convert.factored_positive(xi=xi, zeta=zt, eps=eps, device="cpu"),
        a, b, device="cpu")
    with observe_plan_selection() as events:
        res = solve(prob, method="factored", tol=1e-5, **kw)
    assert [e["mode"] for e in events] == ["scaling"]
    _assert_solve_match(res, jres)
    assert np.all(res.u.numpy()[a == 0] == 0.0)
    assert not bool(res.diverged)


def test_dead_atom_on_a_zero_kernel_row_is_reference_undefined():
    """A dead atom (b_j = 0) whose kernel row is all zero: the plain
    operators pin v_j = 0 (``make_scaling_step``), while the fused plan
    divides b / s = 0 / 0, in the JAX package as in the port, and the solve
    diverges at once. The reference leaves the case undefined; both plans
    give the same divergence and both plain paths the same finite cost."""
    xi, zt = _features(71, 30, 6), _features(72, 20, 6)
    zt[4] = 0.0
    a = np.full(30, 1 / 30, np.float32)
    b = np.full(20, 1.0, np.float32)
    b[4] = 0.0
    b /= b.sum()
    jgeom = JFactored(xi=_j(xi), zeta=_j(zt), eps=0.5)
    geom = convert.factored_positive(xi=xi, zeta=zt, eps=0.5, device="cpu")
    for use_pallas in (True, False):
        jres = j_sinkhorn_geometry(jgeom, _j(a), _j(b), tol=1e-5,
                                   use_pallas=use_pallas)
        res = sinkhorn_geometry(geom, _t(a), _t(b), tol=1e-5,
                                use_pallas=use_pallas)
        assert bool(res.diverged) is bool(jres.diverged) is use_pallas
        assert res.n_iter == int(jres.n_iter)
        if not use_pallas:
            _assert_solve_match(res, jres)


def test_auto_method_on_linear_features_is_the_scaling_plan():
    n, m, r, eps = 80, 60, 16, 0.7
    xi, zt = _features(21, n, r), _features(22, m, r)
    with pytest.warns(DeprecationWarning):
        jres = japi.solve(japi.OTProblem.from_features(_j(xi), _j(zt),
                                                       eps=eps),
                          use_pallas=True, tol=1e-5)
    prob = OTProblem.from_features(xi, zt, eps=eps, device="cpu")
    with observe_plan_selection() as events:
        res = solve(prob, tol=1e-5)
    assert events == [{"geometry": "FactoredPositive", "mode": "scaling",
                       "kind": "factored", "precision": "highest"}]
    _assert_solve_match(res, jres)


@pytest.mark.parametrize("momentum", [1.0, 1.3])
def test_gaussian_clouds_factored_solve_matches_jax(momentum):
    x, y, u, R = _clouds(3, 120, 100, 3, 32, 1.0)
    jgeom = JGaussian.build(_j(x), _j(y), _j(u), eps=1.0, R=R)
    jres = j_sinkhorn_geometry(jgeom, jnp.full(120, 1 / 120),
                               jnp.full(100, 1 / 100), tol=1e-5,
                               momentum=momentum, use_pallas=True)
    geom = convert.gaussian_point_cloud(x, y, u, eps=1.0, R=R, device="cpu")
    res = solve(convert.ot_problem(geom, device="cpu"), method="factored",
                tol=1e-5, momentum=momentum)
    _assert_solve_match(res, jres)
    log = solve(convert.ot_problem(geom, device="cpu"), method="log_factored",
                tol=1e-5)
    assert float(res.cost) == pytest.approx(float(log.cost), rel=1e-4)


def test_annealed_factored_solve_matches_jax():
    x, y, u, R = _clouds(4, 100, 90, 2, 24, 1.0)
    schedule = dict(eps_init=4.0, decay=0.5)
    jprob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=1.0,
                                             R=R)
    jann = japi.solve_annealed(jprob, method="factored", tol=1e-5,
                               schedule=japi.EpsSchedule(**schedule),
                               use_pallas=True)
    geom = convert.gaussian_point_cloud(x, y, u, eps=1.0, R=R, device="cpu")
    ann = solve_annealed(convert.ot_problem(geom, device="cpu"),
                         method="factored", tol=1e-5,
                         schedule=EpsSchedule(**schedule))
    assert ann.stage_eps == tuple(jann.stage_eps) == (4.0, 2.0, 1.0)
    assert all(abs(p - int(q)) <= 1
               for p, q in zip(ann.stage_iters, np.asarray(jann.stage_iters)))
    _assert_solve_match(ann.result, jann.result)


def test_objective_solve_matches_jax():
    n, m, r, eps = 64, 48, 16, 0.5
    xi, zt = _features(31, n, r), _features(32, m, r)
    jobj = JObjective(eps=eps, tol=0.0, max_iter=12,
                      policy=JPolicy(use_pallas=True))
    jgeom = JFactored(xi=_j(xi), zeta=_j(zt), eps=eps)
    want = jobj.solve(jgeom, *jobj.uniform_weights(jgeom))
    obj = OTObjective(eps=eps, tol=0.0, max_iter=12)
    geom = convert.factored_positive(xi=xi, zeta=zt, eps=eps, device="cpu")
    with observe_plan_selection() as events:
        got = obj.solve(geom, *obj.uniform_weights(geom))
    assert [e["mode"] for e in events] == ["scaling"]
    assert got.n_iter == int(want.n_iter) == 12
    _assert_solve_match(got, want)


def test_sinkhorn_factored_is_the_geometry_solve():
    xi, zt = _features(41, 30, 8), _features(42, 20, 8)
    a, b = torch.full((30,), 1 / 30), torch.full((20,), 1 / 20)
    got = sinkhorn_factored(_t(xi), _t(zt), a, b, eps=0.5, tol=1e-5)
    geom = convert.factored_positive(xi=xi, zeta=zt, eps=0.5, device="cpu")
    want = sinkhorn_geometry(geom, a, b, tol=1e-5)
    assert float(got.cost) == float(want.cost) and got.n_iter == want.n_iter


# ---------------------------------------------------------------------------
# Gradients and divergences
# ---------------------------------------------------------------------------


def _grads_close(got, want, rel=REL):
    for g, w in zip(got, want):
        _close_to_max(g.numpy(), w, rel)


def _divergence_close(got, want, xi, zt, a, b, eps):
    """W̄ is a difference of three costs, each held at rtol 1e-5 by the
    solve tests, so it is held within 1e-5 of the largest term: one float32
    ulp of a term is about 1e-4 of W̄ between nearby measures."""
    terms = [float(j_rot_factored(p, q, w1, w2, eps, 1e-5))
             for p, q, w1, w2 in ((xi, zt, a, b), (xi, xi, a, a),
                                  (zt, zt, b, b))]
    assert abs(float(got) - float(want)) <= REL * max(map(abs, terms))


def test_rot_factored_value_and_gradients_match_jax():
    n, m, r, eps = 50, 40, 12, 0.5
    xi, zt = _features(51, n, r), _features(52, m, r)
    a = np.random.default_rng(5).uniform(0.5, 1.5, n).astype(np.float32)
    b = np.random.default_rng(6).uniform(0.5, 1.5, m).astype(np.float32)
    a, b = a / a.sum(), b / b.sum()
    args = (_j(xi), _j(zt), _j(a), _j(b))
    want = j_rot_factored(*args, eps, 1e-5)
    jgrads = jax.grad(lambda *z: j_rot_factored(*z, eps, 1e-5),
                      argnums=(0, 1, 2, 3))(*args)
    leaves = [_t(x).requires_grad_(True) for x in (xi, zt, a, b)]
    got = rot_factored(*leaves, eps, 1e-5)
    assert float(got.detach()) == pytest.approx(float(want), rel=REL)
    _grads_close(torch.autograd.grad(got, leaves), jgrads)


def test_scaling_divergence_features_matches_jax():
    n, m, r, eps = 50, 40, 12, 0.5
    xi, zt = _features(61, n, r), _features(62, m, r)
    a, b = np.full(n, 1 / n, np.float32), np.full(m, 1 / m, np.float32)
    args = (_j(xi), _j(zt), _j(a), _j(b))

    def jfun(*z):
        return j_div_features(*z, eps=eps, tol=1e-5)

    want = jfun(*args)
    jgrads = jax.grad(jfun, argnums=(0, 1, 2, 3))(*args)
    leaves = [_t(x).requires_grad_(True) for x in (xi, zt, a, b)]
    got = sinkhorn_divergence_features(*leaves, eps=eps, tol=1e-5)
    _divergence_close(got.detach(), want, *args, eps)
    _grads_close(torch.autograd.grad(got, leaves), jgrads)


@pytest.mark.parametrize("log_domain", [False, True])
def test_gaussian_divergence_matches_jax(log_domain):
    x, y, u, R = _clouds(7, 40, 30, 2, 16, 1.0)
    q = gaussian_q(R, 1.0, 2)
    args = (_j(x), _j(y), _j(u))

    def jfun(*z):
        return j_div_gaussian(*z, eps=1.0, q=q, tol=1e-5,
                              log_domain=log_domain)

    want = jfun(*args)
    jgrads = jax.grad(jfun, argnums=(0, 1, 2))(*args)
    leaves = [_t(v).requires_grad_(True) for v in (x, y, u)]
    got = sinkhorn_divergence_gaussian(*leaves, eps=1.0, q=q, tol=1e-5,
                                       log_domain=log_domain)
    xi, zt = (jnp.exp(j_log_features(p, args[2], eps=1.0, q=q))
              for p in args[:2])
    _divergence_close(got.detach(), want, xi, zt, jnp.full(40, 1 / 40),
                      jnp.full(30, 1 / 30), 1.0)
    _grads_close(torch.autograd.grad(got, leaves), jgrads)
