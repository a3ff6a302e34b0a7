"""repro_torch's streaming slice against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (its paged Pallas
kernels and ``log_matvec`` in interpret mode, its ``StreamingSolver`` with
``use_pallas=True``) and through the port with ``device="cpu"``, where
every kernel runs its plain PyTorch version. The CUDA kernels themselves
are held against those plain versions on the card by chip_smoke.py.
Tolerances: the kernels rtol 1e-5 + atol 1e-5 (summation order differs),
dead pages exactly 0; streamed solves cost rtol 1e-5, potentials on live
slots atol 1e-5, |d n_iter| <= 1, and equal resilience counters. bf16
factors are rounded once in torch and handed to both packages as the
same bf16 values.
"""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paged import PagedFactored as JPaged
from repro.core.sinkhorn import sinkhorn_geometry as j_sinkhorn_geometry
from repro.kernels.ops import log_matvec as j_log_matvec
from repro.kernels.paged import (
    paged_feature_contract_pallas,
    paged_feature_matvec_pallas,
    paged_halfstep_pallas,
)
from repro.serving.streaming import StreamingOTService as JService
from repro.streaming import StreamingDistribution as JDist
from repro.streaming import StreamingSolver as JSolver
from repro_torch import convert
from repro_torch.core import PagedFactored, sinkhorn_geometry
from repro_torch.core.sinkhorn import _resolve_cadence
from repro_torch.kernels import (
    log_matvec,
    paged_feature_contract,
    paged_feature_matvec,
    paged_halfstep,
)
from repro_torch.kernels.ops import geometry_ops, observe_plan_selection
from repro_torch.serving import StreamingOTService
from repro_torch.streaming import StreamingSolver

RTOL = ATOL = 1e-5
EPS = 0.4
TOL = 1e-6
DTYPES = [torch.float32, torch.bfloat16]


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _both(arr, dtype=torch.float32):
    """One numpy array as a torch tensor at ``dtype`` and the same values
    as a JAX array (bf16 rounded once, in torch)."""
    t = torch.as_tensor(np.asarray(arr, np.float32)).to(dtype).contiguous()
    return t, jnp.asarray(t.float().numpy()).astype(_jdt(dtype))


def _feats(rng, n, r):
    return (np.abs(rng.normal(size=(n, r))) + 0.1).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# The paged kernels and log_matvec
# ---------------------------------------------------------------------------

# (C, r, B, page_size, live counts): mixed live and dead pages, partly live
# pages (dead slots inside a live page), an all-dead buffer
PAGED_CASES = [
    (192, 8, 4, 64, (64, 0, 64)),
    (256, 16, 1, 64, (0, 17, 64, 0)),
    (96, 5, 3, 8, (8, 0, 3, 0, 8, 8, 0, 1, 0, 0, 8, 2)),
    (128, 16, 1, 128, (0,)),
]


def _paged_inputs(C, r, B, ps, live, dtype, seed):
    rng = np.random.default_rng(seed)
    xi_t, xi_j = _both(_feats(rng, C, r), dtype)
    u = np.abs(rng.normal(size=(C, B))).astype(np.float32)
    mask = np.repeat(np.asarray(live) > 0, ps)
    u[~mask] = 1e6                       # garbage on every dead page
    t = (np.abs(rng.normal(size=(r, B))) + 0.1).astype(np.float32)
    marg = np.abs(rng.normal(size=(C, B))).astype(np.float32)
    marg[~mask] = 0.0
    live = np.asarray(live, np.int32)
    return (xi_t, xi_j, u, t, marg, live, mask)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"C{c[0]}-r{c[1]}-B{c[2]}-ps{c[3]}"
                              for c in PAGED_CASES])
def test_paged_kernels_match_pallas(case, dtype):
    """The three paged kernels' plain versions against the Pallas kernels
    in interpret mode: the 1e6 garbage on dead pages never reaches the
    contract, and the row kernels write exact zeros there."""
    C, r, B, ps, live = case
    xi_t, xi_j, u, t, marg, live, mask = _paged_inputs(
        C, r, B, ps, live, dtype, C + r + B)
    lt, lj = torch.as_tensor(live), jnp.asarray(live)
    got = paged_feature_contract(xi_t, torch.as_tensor(u), lt, page_size=ps)
    want = paged_feature_contract_pallas(xi_j, jnp.asarray(u), lj,
                                         page_size=ps, interpret=True)
    _close(got, want)
    assert float(got.abs().max()) < 1e5       # no garbage leaked
    got = paged_halfstep(xi_t, torch.as_tensor(t), torch.as_tensor(marg), lt,
                         page_size=ps)
    want = paged_halfstep_pallas(xi_j, jnp.asarray(t), jnp.asarray(marg), lj,
                                 page_size=ps, interpret=True)
    _close(got, want)
    assert bool((got[torch.as_tensor(~mask)] == 0).all())
    got = paged_feature_matvec(xi_t, torch.as_tensor(t), lt, page_size=ps)
    want = paged_feature_matvec_pallas(xi_j, jnp.asarray(t), lj,
                                       page_size=ps, interpret=True)
    _close(got, want)
    assert bool((got[torch.as_tensor(~mask)] == 0).all())


def test_paged_kernels_refuse_a_ragged_page_table():
    xi = torch.ones((128, 4))
    u = torch.ones((128, 1))
    with pytest.raises(ValueError, match="multiple of the f32 sublane"):
        paged_feature_contract(xi, u, torch.ones(4, dtype=torch.int32),
                               page_size=32 + 4)
    with pytest.raises(ValueError, match="capacity 128"):
        paged_feature_matvec(xi, torch.ones((4, 1)),
                             torch.ones(3, dtype=torch.int32), page_size=64)
    with pytest.raises(TypeError, match="int32"):
        paged_feature_contract(xi, u, torch.ones(2), page_size=64)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("m,r", [(16, 8), (500, 64), (1023, 300)])
def test_log_matvec_matches_pallas(m, r, dtype):
    """``log_matvec`` against the JAX kernel at its own test's shapes, with
    ``-inf`` entries, an all ``-inf`` row (gives ``-inf``) and ``-inf`` in
    ``t``."""
    rng = np.random.default_rng(m * 3 + r)
    log_m = (3.0 * rng.standard_normal((m, r))).astype(np.float32)
    t = (2.0 * rng.standard_normal(r)).astype(np.float32)
    log_m[m // 2] = -np.inf
    log_m[:, r // 3] = -np.inf
    log_m[1, 0] = -np.inf
    t[r - 1] = -np.inf
    lt, lj = _both(log_m, dtype)
    got = log_matvec(lt, torch.as_tensor(t))
    want = j_log_matvec(lj, jnp.asarray(t), backend="interpret")
    assert got.shape == (m,) and got.dtype == torch.float32
    assert math.isinf(float(got[m // 2])) and float(got[m // 2]) < 0
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    _close(got.numpy()[fin], np.asarray(want)[fin])


# ---------------------------------------------------------------------------
# The streaming solver against the JAX package
# ---------------------------------------------------------------------------


def _store_args(dist):
    st = dist.store
    return (np.asarray(st._feats), st._weights, st._live, st._slot,
            st._page_live, st._alloc_order)


def _port_dist(jdist):
    st = jdist.store
    return convert.streaming_distribution(
        *_store_args(jdist), page_size=st.page_size, eps=jdist.eps,
        device="cpu")


def _pairs(method, n=50, m=40, r=8, seed=0, precision="highest",
           momentum=1.0, tol=TOL):
    """The same seeded pair in both packages: a JAX solver with the paged
    Pallas plan and the port's, over stores holding the same slots."""
    rng = np.random.default_rng(seed)
    xi, zeta = _feats(rng, n, r), _feats(rng, m, r)
    wa = rng.uniform(0.5, 1.5, n).astype(np.float32)
    wb = rng.uniform(0.5, 1.5, m).astype(np.float32)
    jx = JDist.from_features([("x", i) for i in range(n)], xi, wa, eps=EPS)
    jy = JDist.from_features([("y", j) for j in range(m)], zeta, wb, eps=EPS)
    kw = dict(method=method, tol=tol, momentum=momentum,
              precision=precision)
    jsol = JSolver(use_pallas=True, **kw)
    psol = StreamingSolver(**kw)
    jpair = jsol.register("p", jx, jy)
    ppair = psol.register("p", _port_dist(jx), _port_dist(jy))
    return jsol, jpair, psol, ppair, rng


def _agree(jres, pres, jpair, ppair, jsol, psol):
    assert abs(int(jres.n_iter) - pres.n_iter) <= 1
    np.testing.assert_allclose(float(pres.cost), float(jres.cost),
                               rtol=RTOL, atol=0)
    for side, jf, pf in (("x", jres.f, pres.f), ("y", jres.g, pres.g)):
        live = getattr(jpair, side).live_mask()
        np.testing.assert_array_equal(live, getattr(ppair, side).live_mask())
        _close(pf.numpy()[live], np.asarray(jf)[live], rtol=0, atol=ATOL)
        assert np.all(np.isneginf(pf.numpy()[~live]))
    for key in ("diverged", "cold_fallbacks", "state_resets", "warm_resets"):
        assert getattr(psol, key) == getattr(jsol, key), key
    assert ppair.n_warm == jpair.n_warm and ppair.n_solves == jpair.n_solves


def _mutate(pair, rng, k, r, tag):
    """Evict ``k`` live ids of each side and insert ``k`` new rows on x."""
    drop_x = sorted(pair.x.store.ids(), key=str)[:k]
    drop_y = sorted(pair.y.store.ids(), key=str)[-k:]
    return dict(remove_x=drop_x, remove_y=drop_y,
                add_x=dict(ids=[(tag, i) for i in range(k)],
                           feats=_feats(rng, k, r),
                           weights=rng.uniform(0.5, 1.5, k).astype(
                               np.float32)))


@pytest.mark.parametrize("method", ["scaling", "log"])
def test_streamed_solves_match_jax(method):
    """Cold, warm after inserts and evictions, and across a bucket crossing
    (the saved potentials remapped through the slot permutation): the
    port's solver against the JAX solver on the same stores."""
    jsol, jpair, psol, ppair, rng = _pairs(method)
    with observe_plan_selection() as events:
        pres = psol.cold_solve(ppair)
    jres = jsol.cold_solve(jpair)
    _agree(jres, pres, jpair, ppair, jsol, psol)
    assert [(e["mode"], e["kind"]) for e in events] == [(method, "paged")]
    mut = _mutate(jpair, np.random.default_rng(1), 6, 8, "n")
    jres = jsol.update(jpair, **mut)
    pres = psol.update(ppair, **mut)
    _agree(jres, pres, jpair, ppair, jsol, psol)
    assert ppair.n_warm == 1 and bool(pres.converged)
    cap0 = jpair.x.capacity
    k = cap0 - jpair.x.n_live + 5               # forces the crossing
    rng = np.random.default_rng(2)
    add = dict(ids=[("big", i) for i in range(k)], feats=_feats(rng, k, 8),
               weights=rng.uniform(0.5, 1.5, k).astype(np.float32))
    jres = jsol.update(jpair, add_x=add)
    pres = psol.update(ppair, add_x=add)
    assert ppair.x.capacity == jpair.x.capacity > cap0
    _agree(jres, pres, jpair, ppair, jsol, psol)


def test_paged_plan_momentum_matches_jax():
    """The paged scaling plan's relaxed step (momentum 1.3, the masked
    ``a / kv``) at a tolerance the solve reaches (ROADMAP §C)."""
    jsol, jpair, psol, ppair, _ = _pairs("scaling", momentum=1.3, tol=1e-5)
    _agree(jsol.cold_solve(jpair), psol.cold_solve(ppair), jpair, ppair,
           jsol, psol)


def test_bf16_streamed_solve_matches_jax():
    jsol, jpair, psol, ppair, _ = _pairs("scaling", precision="bf16")
    _agree(jsol.cold_solve(jpair), psol.cold_solve(ppair), jpair, ppair,
           jsol, psol)


def test_bf16_scaling_solves_read_bf16_device_buffers():
    """A bf16 scaling solver asks the stores for bf16 device buffers (no
    per-solve cast of the whole buffer) and agrees with the JAX solver at
    precision "bf16", cold and warm; a float32 solver on the same stores
    gets float32 buffers again, uploaded from the host rows, not widened
    from bf16."""
    jsol, jpair, psol, ppair, _ = _pairs("scaling", precision="bf16")
    _agree(jsol.cold_solve(jpair), psol.cold_solve(ppair), jpair, ppair,
           jsol, psol)
    assert ppair.x.store._dev_feats.dtype == torch.bfloat16
    mut = _mutate(jpair, np.random.default_rng(3), 4, 8, "b")
    _agree(jsol.update(jpair, **mut), psol.update(ppair, **mut), jpair,
           ppair, jsol, psol)
    assert ppair.x.store._dev_feats.dtype == torch.bfloat16
    f32 = StreamingSolver(tol=TOL)
    f32.cold_solve(f32.register("q", ppair.x, ppair.y))
    np.testing.assert_array_equal(ppair.x.store._dev_feats.numpy(),
                                  ppair.x.store._feats)
    log_bf16 = StreamingSolver(method="log", tol=TOL, precision="bf16")
    log_bf16.cold_solve(log_bf16.register("r", ppair.x, ppair.y))
    assert ppair.x.store._dev_feats.dtype == torch.float32


def test_warm_updates_start_from_the_saved_potentials():
    """Evict / insert / re-solve cycles after warmup, on Gaussian-featured
    clouds whose cold solve takes tens of iterations: each update is a
    warm solve from the previous potentials that lands on the cold solve's
    cost of the same state, in fewer iterations over the run."""
    from repro_torch.streaming import StreamingDistribution
    rng = np.random.default_rng(0)
    n, d, r, eps = 60, 2, 16, 0.5
    anchors = rng.normal(size=(r, d)).astype(np.float32)
    sides = [StreamingDistribution.from_points(
        list(range(n)), rng.normal(size=(n, d)).astype(np.float32) * 0.5
        + shift, np.ones(n, np.float32), anchors, eps=eps, device="cpu")
        for shift in (0.0, 0.3)]
    psol = StreamingSolver(tol=TOL)
    ppair = psol.register("p", *sides)
    psol.warmup(ppair)
    assert psol.cold_solve(ppair).n_iter >= 20
    warm_iters = cold_iters = 0
    for k in range(3):
        warm = psol.update(ppair, remove_x=[k], add_x=dict(
            ids=[("n", k)], points=rng.normal(size=(1, d)).astype(
                np.float32) * 0.5, weights=np.ones(1, np.float32)))
        cold = psol.cold_solve(ppair)
        assert bool(warm.converged) and bool(cold.converged)
        np.testing.assert_allclose(float(warm.cost), float(cold.cost),
                                   rtol=RTOL)
        warm_iters += warm.n_iter
        cold_iters += cold.n_iter
    assert warm_iters < cold_iters
    assert ppair.n_warm == 3 and psol.warmups == 1


def test_paged_geometry_validation_and_plan():
    xi = torch.ones((128, 4))
    live = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one factor pair"):
        PagedFactored(xi=xi, zeta=xi, log_xi=xi, log_zeta=xi,
                      page_live_x=live, page_live_y=live, eps=0.1)
    with pytest.raises(ValueError, match="page_live"):
        PagedFactored(xi=xi, zeta=xi, eps=0.1)
    geom = PagedFactored(xi=xi, zeta=xi, page_live_x=live,
                         page_live_y=live, eps=0.1)
    plan = geometry_ops(geom, mode="scaling")
    assert (plan.mode, plan.kind, plan.make_block_step) == (
        "scaling", "paged", None)
    assert (geometry_ops(geom, mode="log").mode, geometry_ops(
        geom, mode="log").kind) == ("log", "paged")
    # with no megakernel the card's auto cadence checks every iteration,
    # as the JAX package's does
    card_plan = types.SimpleNamespace(
        features=(types.SimpleNamespace(is_cuda=True),),
        make_block_step=None)
    assert _resolve_cadence(card_plan, None, None) == (1, 1, True)


def test_paged_plan_takes_explicit_inner_steps_without_a_megakernel():
    """``inner_steps=8`` on a plan with no megakernel runs the
    per-iteration step and checks every 8 iterations, as the JAX package
    does, instead of calling a missing block step."""
    rng = np.random.default_rng(3)
    C, n, r = 128, 70, 6
    xi, zeta = _feats(rng, C, r), _feats(rng, C, r)
    a = np.zeros(C, np.float32)
    a[:n] = 1.0 / n
    live = np.array([64, 6], np.int32)
    kw = dict(tol=TOL, inner_steps=8)
    pg = convert.paged_factored(xi=xi, zeta=zeta, page_live_x=live,
                                page_live_y=live, eps=EPS, device="cpu")
    pres = sinkhorn_geometry(pg, torch.as_tensor(a), torch.as_tensor(a),
                             **kw)
    jg = JPaged(xi=jnp.asarray(xi), zeta=jnp.asarray(zeta),
                page_live_x=jnp.asarray(live), page_live_y=jnp.asarray(live),
                eps=EPS)
    jres = j_sinkhorn_geometry(jg, jnp.asarray(a), jnp.asarray(a),
                               use_pallas=True, **kw)
    assert pres.n_iter == int(jres.n_iter) and pres.n_iter % 8 == 0
    np.testing.assert_allclose(float(pres.cost), float(jres.cost), rtol=RTOL)


# ---------------------------------------------------------------------------
# Store bookkeeping and the service
# ---------------------------------------------------------------------------


def _store_ops(dist, rng_seed):
    """A fixed mix of store operations; returns what each flush wrote."""
    rng = np.random.default_rng(rng_seed)
    st = dist.store
    flushed = [st.flush()]
    st.add(list(range(70)), _feats(rng, 70, 4), np.ones(70, np.float32))
    flushed.append(st.flush())
    st.remove(list(range(63)))
    st.add([1000], _feats(rng, 1, 4), np.ones(1, np.float32))
    st.add([1000], _feats(rng, 1, 4), np.ones(1, np.float32))
    st.add([2, 200], _feats(rng, 2, 4), np.ones(2, np.float32))
    flushed.append(st.flush())
    flushed.append(st.flush())
    dist.add(list(range(300, 500)), feats=_feats(rng, 200, 4),
             weights=np.ones(200, np.float32))       # a bucket crossing
    flushed.append(st.flush())
    return flushed, dist.take_remap()


def test_store_bookkeeping_matches_jax():
    jd = JDist.from_features([], np.ones((0, 4), np.float32),
                             np.ones(0, np.float32), eps=EPS, capacity=256)
    pd = convert.streaming_distribution(*_store_args(jd), page_size=64,
                                        eps=EPS, device="cpu")
    jflush, jperm = _store_ops(jd, 5)
    pflush, pperm = _store_ops(pd, 5)
    assert pflush == jflush
    np.testing.assert_array_equal(pperm, jperm)
    js, ps = jd.store, pd.store
    for name in ("page_live", "page_indices", "page_indptr"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(js, name))
    assert ps.last_page_len == js.last_page_len
    assert {i: ps.slot_of(i) for i in ps.ids()} == \
        {i: js.slot_of(i) for i in js.ids()}
    np.testing.assert_array_equal(pd.device_features().numpy(),
                                  np.asarray(jd.device_features()))
    assert ps.stats() == js.stats()


def test_store_from_points_featurizes_on_its_device():
    rng = np.random.default_rng(4)
    anchors = rng.normal(size=(16, 3)).astype(np.float32)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    w = np.ones(20, np.float32)
    jd = JDist.from_points(list(range(20)), pts, w, anchors, eps=1.0)
    from repro_torch.streaming import StreamingDistribution
    pd = StreamingDistribution.from_points(list(range(20)), pts, w, anchors,
                                           eps=1.0, device="cpu")
    _close(pd.device_features().numpy(), np.asarray(jd.device_features()),
           rtol=1e-6, atol=0)
    assert pd.device.type == "cpu"


def test_service_coalesces_like_jax():
    """Three mutations, one flush, one warm re-solve, the same result for
    every ticket, in both packages; an unknown pair raises."""
    rng = np.random.default_rng(6)
    n, r = 30, 8
    xi, zeta = _feats(rng, n, r), _feats(rng, n, r)
    ones = np.ones(n, np.float32)
    jx = JDist.from_features(list(range(n)), xi, ones, eps=EPS)
    jy = JDist.from_features(list(range(n)), zeta, ones, eps=EPS)
    px, py = _port_dist(jx), _port_dist(jy)
    clock = {"t": 0.0}
    new_row = _feats(rng, 1, r)
    services = []
    for svc_cls, solver, (dx, dy) in (
            (JService, JSolver(tol=TOL, use_pallas=True), (jx, jy)),
            (StreamingOTService, StreamingSolver(tol=TOL), (px, py))):
        svc = svc_cls(solver=solver, max_batch=8, max_wait=1.0,
                      clock=lambda: clock["t"])
        svc.register("p", dx, dy)
        clock["t"] = 0.0
        tickets = [svc.submit_update("p", remove_x=[0]),
                   svc.submit_update("p", add_x=dict(
                       ids=[900], feats=new_row,
                       weights=np.ones(1, np.float32))),
                   svc.submit_update("p", remove_y=[5])]
        assert svc.pump() == 0
        clock["t"] = 2.0
        assert svc.pump() == 3
        assert tickets[0].result is tickets[1].result is tickets[2].result
        services.append((svc, tickets))
        with pytest.raises(KeyError):
            svc.submit_update("nope", remove_x=[0])
    (jsvc, jt), (psvc, pt) = services
    for key in ("solves", "dispatched", "coalesce_ratio", "flushed_aged",
                "pending"):
        assert psvc.stats()[key] == jsvc.stats()[key], key
    assert psvc.solves == 1
    np.testing.assert_allclose(float(pt[0].result.cost),
                               float(jt[0].result.cost), rtol=RTOL)
    assert pt[0].health.verdict == jt[0].health.verdict == "ok"
    assert pt[0].latency == jt[0].latency == 2.0
