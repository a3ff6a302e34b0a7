"""The paper's other cost families and baselines in the port, against the
JAX package on the CPU.

The same numpy arrays go to the JAX function (``JAX_PLATFORMS=cpu``; its
plain XLA operators, and the fused arc-cosine plan in interpret mode with
``use_pallas=True``, as the JAX package's own tests run it; each reference
call under one ``jax.jit``, which compiles it once) and to the
port (``device="cpu"``, through ``repro_torch.convert``). Families: Lemma-3
arc-cosine features and ``ArcCosinePointCloud``, ``NystromLowRank``,
``GridSeparable``; methods: ``accelerated`` and barycenters; the front
end's dispatch, refusals and ``rank=`` / ``key=``. Tolerances: features
atol 1e-6; costs 1e-5 relative with |d n_iter| <= 1; gradients 1e-4 of
max |grad|; Nystrom's L @ Rt 1e-4 of max (eps >= 0.1 only, where the
reference is defined); barycenter weights 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.accelerated as j_acc
import repro.core.barycenter as j_bary
from repro.core import api as japi
from repro.core import geometry as jg
from repro.core.divergence import sinkhorn_divergence_geometry as j_div
from repro.core.features import GaussianFeatureMap as JGaussianFeatureMap
from repro.core.features import arccos_features as j_arccos_features
from repro.core.features import gaussian_log_features as j_glf
from repro.core.sinkhorn import sinkhorn_log_factored as j_log_factored
from repro.core.sinkhorn import sinkhorn_log_geometry as j_log_solve
from repro.core.sinkhorn import sinkhorn_log_quadratic as j_log_quadratic
from repro_torch import convert
from repro_torch.core import (
    ArcCosineFeatureMap,
    ArcCosinePointCloud,
    DenseCost,
    GridSeparable,
    NystromFactors,
    NystromLowRank,
    OTProblem,
    accelerated_sinkhorn_log_factored,
    arccos_features,
    as_geometry,
    barycenter_geometry,
    barycenter_log_factored,
    gibbs_kernel,
    neglog_kernel_cost,
    nystrom_factors,
    sinkhorn_divergence_geometry,
    sinkhorn_log_factored,
    sinkhorn_log_geometry,
    sinkhorn_log_quadratic,
    sinkhorn_nystrom,
    sinkhorn_quadratic,
    solve,
)
from repro_torch.core import api as tapi
from repro_torch.core.accelerated import dual_gradients
from repro_torch.examples import sphere_barycenter
from repro_torch.kernels.ops import geometry_ops, observe_plan_selection

EPS = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at these sizes
    the port is op-overhead bound, and torch's pool otherwise contends
    with XLA's, and with the other test processes', on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _cost_match(t, j, rtol=1e-5):
    assert math.isfinite(float(t.cost))
    assert float(t.cost) == pytest.approx(float(j.cost), rel=rtol)
    assert abs(int(t.n_iter) - int(j.n_iter)) <= 1


def _arccos_arrays(case, n=48, m=40, d=3, r=31, seed=0):
    """Clouds and anchors 1.5 N(0, I). ``dead_column``: clouds in the
    positive orthant and anchor 0 in the negative one, so its feature
    column is 0 on both sides (an all -inf log column)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = 0.5 * rng.standard_normal((m, d)) + 0.3
    u = 1.5 * rng.standard_normal((r, d))
    if case == "dead_column":
        x, y = np.abs(x) + 0.1, np.abs(y) + 0.1
        u[0] = -1.5
    return (x.astype(np.float32), y.astype(np.float32),
            u.astype(np.float32))


def _unit_ball_clouds(n=60, m=50, d=2, seed=27):
    """bench_tradeoff's Nystrom problem: clouds scaled into the unit ball."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((n, d)), -2, 2)
    y = np.clip(0.7 * rng.standard_normal((m, d)) + 0.2, -2, 2)
    R = max(np.linalg.norm(x, axis=1).max(), np.linalg.norm(y, axis=1).max())
    return (x / R).astype(np.float32), (y / R).astype(np.float32)


def _log_features(n=80, m=70, d=2, r=128, eps=EPS, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (0.6 * rng.standard_normal((m, d)) + 0.4).astype(np.float32)
    fm = JGaussianFeatureMap(r=r, d=d, eps=eps, R=3.5)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((r, d))).astype(
        np.float32)
    lxi = np.array(j_glf(_j(x), _j(u), eps=eps, q=fm.q))
    lzt = np.array(j_glf(_j(y), _j(u), eps=eps, q=fm.q))
    return lxi, lzt


def _grid_axes(n1=6, n2=5, m1=4, m2=7):
    ax = (np.linspace(0.0, 1.0, n1), np.linspace(0.0, 1.0, n2))
    ay = (np.linspace(0.0, 1.2, m1), np.linspace(0.1, 1.1, m2))
    return ([a.astype(np.float32) for a in ax],
            [a.astype(np.float32) for a in ay])


def _blob_weights(shape, center, seed):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, s) for s in shape],
                             indexing="ij"), -1)
    w = np.exp(-np.sum((g - np.asarray(center)) ** 2, -1) / 0.1)
    w = w + 0.05 * rng.random(shape)
    return (w / w.sum()).reshape(-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Lemma 3: arc-cosine features and ArcCosinePointCloud
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [0, 1, 2])
def test_arccos_features_match_jax(s):
    x, _, u = _arccos_arrays("random")
    want = np.asarray(j_arccos_features(_j(x), _j(u), s=s, sigma=1.5,
                                        kappa=1e-3))
    got = arccos_features(_t(x), _t(u), s=s, sigma=1.5, kappa=1e-3).numpy()
    assert got.shape == (x.shape[0], u.shape[0] + 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.all(got[:, -1] == want[:, -1])


def test_arccos_feature_map_init_is_one_draw_on_every_device():
    fm = ArcCosineFeatureMap(r=9, d=3, sigma=1.4)
    a = fm.init(torch.Generator().manual_seed(4), device="cpu")
    b = fm.init(torch.Generator().manual_seed(4),
                device=torch.device("cpu"))
    assert a.shape == (9, 3) and torch.equal(a, b)
    want = 1.4 * torch.randn((9, 3), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, want, rtol=0, atol=0)


def test_arccos_geometry_refuses_kappa_zero_and_is_pinned():
    x, y, u = _arccos_arrays("random")
    with pytest.raises(ValueError, match="kappa > 0"):
        convert.arccos_point_cloud(x, y, u, eps=EPS, kappa=0.0, device="cpu")
    geom = convert.arccos_point_cloud(x, y, u, eps=EPS, device="cpu")
    assert not geom.anneal_capable and geom.rebuild_at(EPS) is geom
    with pytest.raises(ValueError, match="pins the kernel"):
        geom.rebuild_at(EPS / 2)
    assert geom.xx().shape == (48, 48) and geom.yy().shape == (40, 40)
    spec = geom.pallas_ops()
    assert spec["kind"] == "factored" and spec["xi"].shape == (48, 32)


@pytest.mark.parametrize("case", ["random", "dead_column"])
def test_arccos_solve_matches_jax(case):
    """The plain XLA solve, JAX's fused plan in interpret mode, the port's
    fused log plan (the kernels' plain versions) and its plain operators
    agree; with a dead anchor the plan's log factors hold a whole -inf
    column, which stays -inf and never NaN."""
    x, y, u = _arccos_arrays(case)
    n, m = x.shape[0], y.shape[0]

    @jax.jit
    def j_solves(x, y, u):
        jgeom = jg.ArcCosinePointCloud(x, y, u, eps=EPS)
        a, b = jnp.full((n,), 1.0 / n), jnp.full((m,), 1.0 / m)
        return (japi.solve(japi.OTProblem.from_geometry(jgeom),
                           method="arccos"),
                j_log_solve(jgeom, a, b, use_pallas=True))

    jres, jfused = j_solves(_j(x), _j(y), _j(u))
    prob = convert.ot_problem(
        convert.arccos_point_cloud(x, y, u, eps=EPS, device="cpu"),
        device="cpu")
    plan = geometry_ops(prob.geometry, mode="log")
    dead = torch.all(plan.features[0] == -torch.inf, dim=0)
    assert bool(dead[0]) == (case == "dead_column")
    with observe_plan_selection() as events:
        fused = solve(prob)
    assert events == [{"geometry": "ArcCosinePointCloud", "mode": "log",
                       "kind": "factored", "precision": "highest"}]
    plain = solve(prob, method="arccos", use_pallas=False)
    for res in (fused, plain):
        _cost_match(res, jres)
        _cost_match(res, jfused)
        assert bool(res.converged) and not bool(res.diverged)
        assert torch.isfinite(res.f).all() and torch.isfinite(res.g).all()
        np.testing.assert_allclose(res.f.numpy(), np.asarray(jres.f),
                                   atol=1e-5, rtol=0)


def test_arccos_factored_scaling_plan_matches_jax():
    """``method="factored"`` on the arc-cosine geometry runs the scaling
    plan on features with zero entries and a zero column."""
    x, y, u = _arccos_arrays("dead_column")
    jres = jax.jit(lambda x, y, u: japi.solve(
        japi.OTProblem.from_geometry(jg.ArcCosinePointCloud(x, y, u,
                                                            eps=EPS)),
        method="factored"))(_j(x), _j(y), _j(u))
    prob = convert.ot_problem(
        convert.arccos_point_cloud(x, y, u, eps=EPS, device="cpu"),
        device="cpu")
    with observe_plan_selection() as events:
        res = solve(prob, method="factored")
    assert events[0]["mode"] == "scaling" and events[0]["kind"] == "factored"
    _cost_match(res, jres)


def test_arccos_megakernel_admission_at_the_trainer_shape():
    """n = m = 256 and r + 1 = 128 is admitted to the log megakernel in
    bf16 and refused in float32 (then the per-iteration plan runs)."""
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal((2, 256, 8)).astype(np.float32)
    u = (1.5 * rng.standard_normal((127, 8))).astype(np.float32)
    geom = convert.arccos_point_cloud(x, y, u, eps=EPS, device="cpu")
    bf16 = geometry_ops(geom, mode="log", precision="bf16")
    f32 = geometry_ops(geom, mode="log")
    assert bf16.features[0].shape == (256, 128)
    assert bf16.block_admits(256, 256) and not f32.block_admits(256, 256)


def test_arccos_matches_dense_oracle():
    """The arc-cosine solve against the dense log-domain solve on the cost
    it induces (one fixed point), as the JAX package's own test holds."""
    x, y, u = _arccos_arrays("random", n=36, m=30, d=2, r=120, seed=21)
    geom = convert.arccos_point_cloud(x, y, u, eps=EPS, sigma=1.4,
                                      kappa=5e-3, device="cpu")
    res = solve(convert.ot_problem(geom, device="cpu"), tol=1e-6,
                max_iter=8000)
    xi, zeta = geom.features()
    K = xi @ zeta.T
    assert float(K.min()) >= 5e-3 - 1e-6
    oracle = solve(OTProblem.from_cost(-EPS * torch.log(K), eps=EPS,
                                       device="cpu"),
                   method="log_quadratic", tol=1e-6, max_iter=8000)
    assert bool(res.converged)
    assert float(res.cost) == pytest.approx(float(oracle.cost), rel=1e-5)


@pytest.mark.parametrize("case", ["random", "dead_column"])
def test_arccos_divergence_and_gradients_match_jax(case):
    """The envelope VJP differentiates through the masked log of ReLU
    features: finite where features are exactly 0 (a whole dead column
    included), and equal to jax.grad in x and in the anchors."""
    x, y, u = _arccos_arrays(case, n=28, m=28, r=23)

    def j_fn(xx, uu):
        return j_div(jg.ArcCosinePointCloud(xx, _j(y), uu, eps=EPS))

    jval, (jgx, jgu) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        _j(x), _j(u))
    xt = _t(x).requires_grad_(True)
    ut = _t(u).requires_grad_(True)
    val = sinkhorn_divergence_geometry(
        ArcCosinePointCloud(xt, _t(y), ut, eps=EPS))
    gx, gu = torch.autograd.grad(val, [xt, ut])
    # the divergence cancels three O(1) costs: 1e-5 of their scale
    assert abs(float(val) - float(jval)) <= 1e-5
    for got, want in ((gx, jgx), (gu, jgu)):
        want = np.asarray(want)
        assert torch.isfinite(got).all() and np.isfinite(want).all()
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# Nystrom
# ---------------------------------------------------------------------------


def _jax_nystrom(x, y, eps, rank, seed):
    """The JAX geometry and the landmarks its key draws."""
    key = jax.random.PRNGKey(seed)
    geom = jax.jit(lambda x, y, key: jg.NystromLowRank.from_point_clouds(
        x, y, eps=eps, rank=rank, key=key))(_j(x), _j(y), key)
    pool = np.concatenate([x, y])
    idx = np.asarray(jax.random.choice(key, pool.shape[0], (rank,),
                                       replace=False))
    return geom, pool[idx]


def _nystrom_truth(x, y, z, eps):
    """L @ Rt of the same landmarks in float64 (the reference's float32
    eigendecomposition and truncation, done exactly)."""
    x, y, z = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, z))

    def gibbs(p, q):
        return torch.exp(-torch.cdist(p, q) ** 2 / eps)

    w, Q = torch.linalg.eigh(gibbs(z, z))
    keep = w > 1e-5 * w.max()
    inv = (Q[:, keep] / w[keep]) @ Q[:, keep].T
    return (gibbs(x, z) @ inv @ gibbs(z, y)).numpy()


@pytest.mark.parametrize("eps, rank, tight", [(0.1, 12, True),
                                              (0.1, 24, False),
                                              (0.5, 24, False)])
def test_nystrom_factors_from_the_same_landmarks_match_jax(eps, rank, tight):
    """L @ Rt of JAX's landmarks. Where K_zz is well conditioned (eps 0.1,
    12 landmarks: both packages within 1e-5 of max of the float64 truth)
    the port is within 1e-4 of max of JAX's. With more landmarks the
    float32 pseudo-inverse of either package is ~1e-3 of max off the
    truth (2.2e-4 to 1.4e-3 for JAX here), so there both are held to the
    truth within 2e-3 of max."""
    x, y = _unit_ball_clouds()
    jgeom, z = _jax_nystrom(x, y, eps, rank, 7)
    geom = NystromLowRank.from_landmarks(_t(x), _t(y), _t(z), eps=eps)
    want = np.asarray(jgeom.L @ jgeom.Rt)
    got = geom.dense_kernel().numpy()
    truth = _nystrom_truth(x, y, z, eps)
    scale = np.abs(truth).max()
    assert geom.rank == rank and geom.shape == (60, 50)
    assert np.abs(want - truth).max() <= 2e-3 * scale
    assert np.abs(got - truth).max() <= 2e-3 * scale
    if tight:
        assert np.abs(want - truth).max() <= 1e-5 * scale
        assert np.abs(got - want).max() <= 1e-4 * scale


def test_nystrom_landmarks_come_from_a_cpu_generator():
    x, y = _unit_ball_clouds()
    g1 = NystromLowRank.from_point_clouds(
        _t(x), _t(y), eps=0.5, rank=16,
        generator=torch.Generator().manual_seed(3))
    idx = torch.randperm(110, generator=torch.Generator().manual_seed(3))[:16]
    z = torch.cat([_t(x), _t(y)])[idx]
    g2 = NystromLowRank.from_landmarks(_t(x), _t(y), z, eps=0.5)
    assert torch.equal(g1.L, g2.L) and torch.equal(g1.Rt, g2.Rt)
    f = nystrom_factors(_t(x), _t(y), eps=0.5, rank=16,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(f.L, g1.L)


def test_nystrom_solve_matches_jax_and_reports_divergence():
    """At eps 0.5 the port's factors from JAX's landmarks solve to JAX's
    cost (and JAX's own factors, carried over, to the same iterates); at
    eps 0.02, the reference's documented failure, both report
    ``diverged`` through the flag, not an exception."""
    x, y = _unit_ball_clouds()
    jgeom, z = _jax_nystrom(x, y, 0.5, 24, 7)
    jres = jax.jit(lambda g: japi.solve(japi.OTProblem.from_geometry(g),
                                        tol=1e-5))(jgeom)
    assert not bool(jres.diverged)
    carried = convert.nystrom_low_rank(np.asarray(jgeom.L),
                                       np.asarray(jgeom.Rt), eps=0.5,
                                       device="cpu")
    with observe_plan_selection() as events:
        res_c = solve(convert.ot_problem(carried, device="cpu"), tol=1e-5)
    assert events == []                      # no fused plan: plain matmuls
    _cost_match(res_c, jres)
    own = NystromLowRank.from_landmarks(_t(x), _t(y), _t(z), eps=0.5)
    res_o = sinkhorn_nystrom(NystromFactors(own.L, own.Rt),
                             torch.full((60,), 1 / 60),
                             torch.full((50,), 1 / 50), eps=0.5, tol=1e-5)
    assert not bool(res_o.diverged)
    assert float(res_o.cost) == pytest.approx(float(jres.cost), rel=1e-4)

    jbad, zbad = _jax_nystrom(x, y, 0.02, 48, 9)
    jres = jax.jit(lambda g: japi.solve(japi.OTProblem.from_geometry(g)))(
        jbad)
    bad = NystromLowRank.from_landmarks(_t(x), _t(y), _t(zbad), eps=0.02)
    res = solve(convert.ot_problem(bad, device="cpu"))
    assert bool(jres.diverged) and not bool(jres.converged)
    assert bool(res.diverged) == bool(jres.diverged)
    assert not bool(res.converged)


def test_nystrom_refuses_log_cost_and_features():
    x, y = _unit_ball_clouds()
    geom = NystromLowRank.from_point_clouds(
        _t(x), _t(y), eps=0.5, rank=8, generator=torch.Generator())
    log_k, _ = geom.log_operators()
    with pytest.raises(ValueError, match="log-domain"):
        log_k(torch.zeros(50))
    with pytest.raises(ValueError, match="signed"):
        geom.cost_matrix()
    with pytest.raises(ValueError, match="no factored kernel"):
        geom.features()
    assert geom.pallas_ops() is None and not geom.anneal_capable
    with pytest.raises(ValueError, match="log-domain"):
        solve(convert.ot_problem(geom, device="cpu"), method="log_factored")


# ---------------------------------------------------------------------------
# Separable grids
# ---------------------------------------------------------------------------


def test_grid_operators_and_cost_match_jax_and_dense():
    ax, ay = _grid_axes()
    geom = convert.grid_separable(ax, ay, eps=0.3, device="cpu")
    assert geom.shape == (30, 28)
    assert geom.device == torch.device("cpu")
    assert len(geom.tensors()) == 4
    rng = np.random.default_rng(2)
    v, w = rng.random(28).astype(np.float32), rng.random(30).astype(np.float32)
    g, f = rng.standard_normal(28).astype(np.float32), \
        rng.standard_normal(30).astype(np.float32)
    @jax.jit
    def j_views(ax, ay, v, w, g, f):
        jgeom = jg.GridSeparable.build(ax, ay, eps=0.3)
        return (jgeom.apply_k(v), jgeom.apply_kt(w), jgeom.log_apply_k(g),
                jgeom.log_apply_kt(f), jgeom.cost_matrix())

    want = j_views([_j(t) for t in ax], [_j(t) for t in ay], _j(v), _j(w),
                   _j(g), _j(f))
    for got, want in zip((geom.apply_k(_t(v)), geom.apply_kt(_t(w)),
                          geom.log_apply_k(_t(g)), geom.log_apply_kt(_t(f)),
                          geom.cost_matrix()), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    K = geom.dense_kernel()
    torch.testing.assert_close(geom.apply_k(_t(v)), K @ _t(v), rtol=1e-5,
                               atol=1e-7)
    # the log operators take a (k, m) batch as k single calls
    G = torch.stack([_t(g), 2 * _t(g)])
    torch.testing.assert_close(geom.log_apply_k(G)[1],
                               geom.log_apply_k(2 * _t(g)))
    assert geom.anneal_capable and geom.rebuild_at(0.2).eps == 0.2
    assert geom.xx().shape == (30, 30) and geom.yy().shape == (28, 28)


def test_grid_solve_matches_jax_and_the_dense_oracle():
    ax = [np.linspace(0, 1, 8).astype(np.float32)] * 2
    a = _blob_weights((8, 8), (0.3, 0.3), 0)
    b = _blob_weights((8, 8), (0.7, 0.6), 1)
    jres = jax.jit(lambda ax, a, b: japi.solve(
        japi.OTProblem.from_grid(ax, a=a, b=b, eps=0.2), tol=1e-6,
        max_iter=6000))([_j(t) for t in ax], _j(a), _j(b))
    prob = OTProblem.from_grid(ax, a=a, b=b, eps=0.2, device="cpu")
    assert tapi._auto_method(prob) == "log_factored"
    res = solve(prob, tol=1e-6, max_iter=6000)
    oracle = solve(OTProblem.from_cost(prob.geometry.cost_matrix(), a, b,
                                       eps=0.2, device="cpu"),
                   method="log_quadratic", tol=1e-6, max_iter=6000)
    assert bool(res.converged) and bool(oracle.converged)
    _cost_match(res, jres)
    assert float(res.cost) == pytest.approx(float(oracle.cost), rel=1e-5)


def test_grid_divergence_differentiates_the_axes_like_jax():
    """The envelope VJP reaches a grid's axes, tensors held in tuple
    fields, as jax.grad reaches the geometry pytree's leaves."""
    ax, ay = _grid_axes(5, 4, 5, 4)

    def j_fn(axes_x, axes_y):
        return j_div(jg.GridSeparable(tuple(axes_x), tuple(axes_y), eps=0.3))

    jval, (jgx, jgy) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        [_j(t) for t in ax], [_j(t) for t in ay])
    tx = [_t(t).requires_grad_(True) for t in ax]
    ty = [_t(t).requires_grad_(True) for t in ay]
    val = sinkhorn_divergence_geometry(
        GridSeparable(tuple(tx), tuple(ty), eps=0.3))
    grads = torch.autograd.grad(val, tx + ty)
    assert abs(float(val) - float(jval)) <= 1e-5
    want = [np.asarray(w) for w in list(jgx) + list(jgy)]
    scale = max(np.abs(w).max() for w in want)
    assert scale > 0
    for got, w in zip(grads, want):
        assert torch.isfinite(got).all()
        assert np.abs(got.numpy() - w).max() <= 1e-4 * scale


def test_tuple_fields_leave_the_other_families_unchanged():
    x, y, u = _arccos_arrays("random")
    geom = convert.gaussian_point_cloud(x, y, u, eps=EPS, device="cpu")
    assert [t.shape for t in geom.tensors()] == [(48, 3), (40, 3), (31, 3)]
    grid = GridSeparable.build([np.linspace(0, 1, 3)], eps=0.5,
                               device="cpu")
    assert grid.device == torch.device("cpu") and len(grid.tensors()) == 2
    moved = GridSeparable.build([torch.linspace(0, 1, 3)], eps=0.5)
    assert moved.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# convert: the JAX objects' arrays carried into the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["arccos", "nystrom", "grid"])
def test_convert_round_trips_match_jax_operators(family):
    """Each converter builds, from the JAX geometry's arrays, a port
    geometry whose operators (and log operators, where the family has
    them) equal the JAX object's on the same vectors."""
    if family == "arccos":
        x, y, u = _arccos_arrays("dead_column", n=20, m=18, r=11)
        arrays = (x, y, u)

        def j_build(x, y, u):
            return jg.ArcCosinePointCloud(x, y, u, eps=EPS, s=2, sigma=1.4,
                                          kappa=5e-3)

        geom = convert.arccos_point_cloud(x, y, u, eps=EPS, s=2, sigma=1.4,
                                          kappa=5e-3, device="cpu")
    elif family == "nystrom":
        x, y = _unit_ball_clouds(20, 18)
        jgeom, _ = _jax_nystrom(x, y, EPS, 8, 3)
        arrays = (np.array(jgeom.L), np.array(jgeom.Rt))

        def j_build(L, Rt):
            return jg.NystromLowRank(L=L, Rt=Rt, eps=EPS)

        geom = convert.nystrom_low_rank(*arrays, eps=EPS, device="cpu")
    else:
        ax, ay = _grid_axes(5, 4, 3, 6)
        arrays = (ax, ay)

        def j_build(ax, ay):
            return jg.GridSeparable(tuple(ax), tuple(ay), eps=EPS)

        geom = convert.grid_separable(ax, ay, eps=EPS, device="cpu")
    n, m = geom.shape
    rng = np.random.default_rng(6)
    v, w = rng.random(m).astype(np.float32), rng.random(n).astype(np.float32)
    logs = family != "nystrom"

    @jax.jit
    def j_ops(arrays, v, w):
        g = j_build(*arrays)
        out = [g.apply_k(v), g.apply_kt(w)]
        if logs:
            out += [g.log_apply_k(v), g.log_apply_kt(w)]
        return out

    jarrays = tuple([_j(t) for t in a] if isinstance(a, list) else _j(a)
                    for a in arrays)
    want = j_ops(jarrays, _j(v), _j(w))
    got = [geom.apply_k(_t(v)), geom.apply_kt(_t(w))]
    if logs:
        got += [geom.log_apply_k(_t(v)), geom.log_apply_kt(_t(w))]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Thin solvers and free functions
# ---------------------------------------------------------------------------


def test_thin_solvers_match_jax():
    lxi, lzt = _log_features(n=40, m=36, r=64)
    n, m = lxi.shape[0], lzt.shape[0]
    a, b = np.full(n, 1 / n, np.float32), np.full(m, 1 / m, np.float32)
    with observe_plan_selection() as events:
        fused = sinkhorn_log_factored(_t(lxi), _t(lzt), _t(a), _t(b),
                                      eps=EPS)
    assert events[0]["mode"] == "log"
    _cost_match(fused, jax.jit(lambda *w: j_log_factored(*w, eps=EPS))(
        _j(lxi), _j(lzt), _j(a), _j(b)))
    C = -EPS * np.log(np.exp(lxi) @ np.exp(lzt).T).astype(np.float32)
    _cost_match(sinkhorn_log_quadratic(_t(C), _t(a), _t(b), eps=EPS),
                jax.jit(lambda *w: j_log_quadratic(*w, eps=EPS))(
                    _j(C), _j(a), _j(b)))
    K = np.exp(-C / EPS).astype(np.float32)
    prob = OTProblem.from_cost(C, a, b, eps=EPS, device="cpu")
    quad = sinkhorn_quadratic(_t(K), _t(a), _t(b), eps=EPS)
    ref = solve(prob, method="quadratic")
    assert quad.n_iter == ref.n_iter
    assert float(quad.cost) == pytest.approx(float(ref.cost), rel=1e-6)


def test_free_functions_match_jax():
    C = np.random.default_rng(4).random((5, 4)).astype(np.float32)
    K = gibbs_kernel(_t(C), 0.3)
    np.testing.assert_allclose(K.numpy(), np.asarray(jg.gibbs_kernel(
        _j(C), 0.3)), rtol=1e-6)
    np.testing.assert_allclose(neglog_kernel_cost(K, 0.3).numpy(), C,
                               rtol=1e-5, atol=1e-6)
    geom = as_geometry(C, eps=0.3, device="cpu")
    assert isinstance(geom, DenseCost) and geom.eps == 0.3
    assert as_geometry(geom) is geom and as_geometry(geom, eps=0.1).eps == 0.1
    with pytest.raises(ValueError, match="requires eps"):
        as_geometry(_t(C))
    with pytest.raises(TypeError, match="Geometry"):
        as_geometry(_t(C[0]), eps=0.3)


# ---------------------------------------------------------------------------
# Accelerated Sinkhorn
# ---------------------------------------------------------------------------


def test_accelerated_dual_gradients_match_jax_grad():
    lxi, lzt = _log_features(n=30, m=24, r=32)
    rng = np.random.default_rng(5)
    f = (0.1 * rng.standard_normal(30)).astype(np.float32)
    g = (0.1 * rng.standard_normal(24)).astype(np.float32)
    a, b = np.full(30, 1 / 30, np.float32), np.full(24, 1 / 24, np.float32)
    jgeom = jg.FactoredPositive(log_xi=_j(lxi), log_zeta=_j(lzt), eps=EPS)
    log_K, _ = jgeom.log_operators()

    def neg_F(ff, gg):
        logZ = jax.scipy.special.logsumexp(log_K(gg) + ff / EPS)
        return EPS * logZ - jnp.vdot(ff, _j(a)) - jnp.vdot(gg, _j(b))

    jgf, jgg = jax.jit(jax.grad(neg_F, argnums=(0, 1)))(_j(f), _j(g))
    geom = convert.factored_positive(log_xi=lxi, log_zeta=lzt, eps=EPS,
                                     device="cpu")
    tk, tkt = geom.log_operators()
    gf, gg = dual_gradients(tk(_t(g)), tkt(_t(f)), _t(f), _t(g), _t(a),
                            _t(b), EPS)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jgf), atol=1e-6)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgg), atol=1e-6)


def test_accelerated_matches_jax():
    """The port's AGM against the JAX package's (cost 1e-5 relative,
    n_iter +-1, at tol 1e-4) and against the plain log solve (the
    reference's own bound, 2e-3); at a check cadence of 3 it stops on a multiple of 3 (AGM's
    error is not monotone, so not always the first one past the stop
    checked every iteration) and agrees with that solve."""
    lxi, lzt = _log_features()
    n, m = lxi.shape[0], lzt.shape[0]
    a, b = np.full(n, 1 / n, np.float32), np.full(m, 1 / m, np.float32)
    jres = jax.jit(lambda lx, lz, a, b: j_acc.accelerated_sinkhorn_geometry(
        jg.FactoredPositive(log_xi=lx, log_zeta=lz, eps=EPS), a, b, tol=1e-4,
        max_iter=5000))(_j(lxi), _j(lzt), _j(a), _j(b))
    prob = convert.ot_problem(convert.factored_positive(
        log_xi=lxi, log_zeta=lzt, eps=EPS, device="cpu"), device="cpu")
    res = solve(prob, method="accelerated", tol=1e-4, max_iter=5000)
    assert bool(jres.converged) and bool(res.converged)
    _cost_match(res, jres)
    plain = sinkhorn_log_geometry(prob.geometry, prob.a, prob.b, tol=1e-6,
                                  max_iter=5000)
    assert float(res.cost) == pytest.approx(float(plain.cost), rel=2e-3,
                                            abs=1e-4)
    thin = accelerated_sinkhorn_log_factored(_t(lxi), _t(lzt), _t(a), _t(b),
                                             eps=EPS, tol=1e-4,
                                             max_iter=5000)
    assert thin.n_iter == res.n_iter and torch.equal(thin.f, res.f)
    every3 = solve(prob, method="accelerated", tol=1e-4, max_iter=5000,
                   check_every=3)
    assert bool(every3.converged) and every3.n_iter % 3 == 0
    assert float(every3.cost) == pytest.approx(float(res.cost), rel=1e-4)


@pytest.mark.parametrize("kw, match", [
    (dict(momentum=1.3), "momentum"),
    (dict(inner_steps=8), "inner_steps"),
    (dict(precision="bf16"), "bf16"),
])
def test_accelerated_refusals(kw, match):
    lxi, lzt = _log_features(n=10, m=9, r=8)
    prob = convert.ot_problem(convert.factored_positive(
        log_xi=lxi, log_zeta=lzt, eps=EPS, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match=match):
        solve(prob, method="accelerated", **kw)
    jprob = japi.OTProblem.from_log_features(_j(lxi), _j(lzt), eps=EPS)
    with pytest.raises(ValueError, match=match):
        japi.solve(jprob, method="accelerated", **kw)


# ---------------------------------------------------------------------------
# Barycenters
# ---------------------------------------------------------------------------


def _support_features(n=60, d=2, r=256, eps=0.3, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    fm = JGaussianFeatureMap(r=r, d=d, eps=eps, R=3.0)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((r, d))).astype(
        np.float32)
    lxi = np.asarray(j_glf(_j(pts), _j(u), eps=eps, q=fm.q))
    h = rng.random(n).astype(np.float32) + 0.2
    return lxi, (h / h.sum()).astype(np.float32)


def test_barycenter_k_invariance_and_validity():
    """The entropic barycenter of k copies of h does not depend on k and
    is a histogram (tests/test_extensions.py's case)."""
    lxi, h = _support_features()
    r1 = barycenter_log_factored(_t(lxi), _t(h)[None, :], eps=0.3, tol=1e-9,
                                 max_iter=1000)
    r3 = barycenter_log_factored(_t(lxi), _t(np.stack([h, h, h])), eps=0.3,
                                 tol=1e-9, max_iter=1000)
    assert bool(torch.all(r1.weights >= 0)) and bool(torch.all(r3.weights >= 0))
    assert float(r3.weights.sum()) == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_allclose(r1.weights.numpy(), r3.weights.numpy(),
                               atol=1e-4)


def test_barycenter_interpolates_between_corners():
    n, eps = 64, 0.1
    grid = np.linspace(-1, 1, n, dtype=np.float32)[:, None]
    fm = JGaussianFeatureMap(r=256, d=1, eps=eps, R=1.5)
    rng = np.random.default_rng(5)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((256, 1))).astype(
        np.float32)
    lxi = np.asarray(j_glf(_j(grid), _j(u), eps=eps, q=fm.q))

    def blob(c):
        z = -((grid[:, 0] - c) ** 2) / 0.005
        w = np.exp(z - z.max())
        return w / w.sum()

    hists = np.stack([blob(-0.8), blob(0.8)]).astype(np.float32)
    res = barycenter_log_factored(_t(lxi), _t(hists), eps=eps, max_iter=1000)
    w = res.weights.numpy()
    assert abs(float(np.sum(w * grid[:, 0]))) < 0.15
    assert float(np.sum(np.where(np.abs(grid[:, 0]) < 0.4, w, 0.0))) > 0.3
    jres = jax.jit(lambda lx, h: j_bary.barycenter_log_factored(
        lx, h, eps=eps, max_iter=1000))(_j(lxi), _j(hists))
    np.testing.assert_allclose(w, np.asarray(jres.weights), atol=1e-5)
    assert abs(res.n_iter - int(jres.n_iter)) <= 1


def test_barycenter_weights_match_jax():
    lxi, h = _support_features(n=50, r=128)
    rng = np.random.default_rng(8)
    h2 = rng.random(50).astype(np.float32)
    hists = np.stack([h, h2 / h2.sum()]).astype(np.float32)
    lam = np.array([0.3, 0.7], np.float32)
    jres = jax.jit(lambda lx, h, w: j_bary.barycenter_log_factored(
        lx, h, eps=0.3, weights=w, tol=1e-6))(_j(lxi), _j(hists), _j(lam))
    res = barycenter_log_factored(_t(lxi), _t(hists), eps=0.3,
                                  weights=_t(lam), tol=1e-6)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights),
                               atol=1e-5)
    assert abs(res.n_iter - int(jres.n_iter)) <= 1
    assert bool(res.converged) == bool(jres.converged)
    # on a grid the (k, n) batch runs one LSE an axis
    ax = [np.linspace(0, 1, 6).astype(np.float32)] * 2
    ha = np.stack([_blob_weights((6, 6), (0.2, 0.2), 3),
                   _blob_weights((6, 6), (0.8, 0.7), 4)])
    grid = convert.grid_separable(ax, ax, eps=0.2, device="cpu")
    g_res = barycenter_geometry(grid, _t(ha), tol=1e-6)
    d_res = barycenter_geometry(DenseCost(grid.cost_matrix(), 0.2), _t(ha),
                                tol=1e-6)
    np.testing.assert_allclose(g_res.weights.numpy(),
                               d_res.weights.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="symmetric"):
        barycenter_geometry(convert.grid_separable(ax, [ax[0], ax[0][:3]],
                                                   eps=0.2, device="cpu"),
                            _t(ha))


def test_sphere_example_peaks_mid_octant():
    import importlib.util
    import pathlib

    out = sphere_barycenter.main(["--device", "cpu"])
    assert out["angle"] < 25.0 and out["device"] == "cpu"
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "sphere_barycenter.py"
    spec = importlib.util.spec_from_file_location("j_sphere", path)
    j_sphere = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_sphere)
    pts = j_sphere.positive_sphere_grid(50)
    corners = [jnp.array(c, jnp.float32) for c in
               ([1, 0, 0], [0, 1, 0], [0, 0, 1])]
    want = np.asarray(j_sphere.barycenter_ibp(
        pts, [j_sphere.corner_hist(pts, c) for c in corners]))
    np.testing.assert_allclose(out["weights"].numpy(), want, rtol=1e-3,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The front end: dispatch, coercions, rank= / key=
# ---------------------------------------------------------------------------


def _pair(family):
    """One JAX problem and its port counterpart of ``family`` (clouds in
    the unit ball, where the Nystrom family is well posed at eps 0.5)."""
    x, y = _unit_ball_clouds(20, 18, d=3)
    u = _arccos_arrays("random", r=8)[2]
    if family == "gaussian":
        return (japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=EPS),
                OTProblem.from_point_clouds(x, y, u, eps=EPS, device="cpu"))
    if family == "arccos":
        return (japi.OTProblem.from_geometry(jg.ArcCosinePointCloud(
                    _j(x), _j(y), _j(u), eps=EPS)),
                convert.ot_problem(convert.arccos_point_cloud(
                    x, y, u, eps=EPS, device="cpu"), device="cpu"))
    if family == "nystrom":
        jgeom, _ = _jax_nystrom(x, y, EPS, 6, 0)
        return (japi.OTProblem.from_geometry(jgeom),
                convert.ot_problem(convert.nystrom_low_rank(
                    np.asarray(jgeom.L), np.asarray(jgeom.Rt), eps=EPS,
                    device="cpu"), device="cpu"))
    if family == "grid":
        ax, ay = _grid_axes()
        return (japi.OTProblem.from_grid([_j(t) for t in ax],
                                         [_j(t) for t in ay], eps=EPS),
                OTProblem.from_grid(ax, ay, eps=EPS, device="cpu"))
    C = np.random.default_rng(0).random((6, 5)).astype(np.float32)
    if family == "dense":
        return (japi.OTProblem.from_cost(_j(C), eps=EPS),
                OTProblem.from_cost(C, eps=EPS, device="cpu"))
    if family == "features":
        return (japi.OTProblem.from_features(_j(C + 0.1), _j(C + 0.1),
                                             eps=EPS),
                OTProblem.from_features(C + 0.1, C + 0.1, eps=EPS,
                                        device="cpu"))
    return (japi.OTProblem.from_log_features(_j(C), _j(C), eps=EPS),
            OTProblem.from_log_features(C, C, eps=EPS, device="cpu"))


@pytest.mark.parametrize("family", ["gaussian", "arccos", "nystrom", "grid",
                                    "dense", "features", "log_features"])
def test_auto_dispatch_matches_the_reference(family):
    jprob, prob = _pair(family)
    assert tapi._auto_method(prob) == japi._auto_method(jprob)
    res = solve(prob, tol=1e-5)
    assert bool(res.converged) and not bool(res.diverged)


def test_rank_and_key_reach_both_coercions():
    _, prob = _pair("gaussian")
    x, y = prob.geometry.x, prob.geometry.y
    res = solve(prob, method="arccos", rank=16,
                key=torch.Generator().manual_seed(1))
    anchors = ArcCosineFeatureMap(r=16, d=3).init(
        torch.Generator().manual_seed(1), device="cpu")
    want = solve(convert.ot_problem(ArcCosinePointCloud(x, y, anchors,
                                                        eps=EPS),
                                    device="cpu"))
    assert float(res.cost) == float(want.cost) and res.n_iter == want.n_iter
    default = solve(prob, method="arccos")
    seeded0 = solve(prob, method="arccos",
                    key=torch.Generator().manual_seed(0))
    assert float(default.cost) == float(seeded0.cost)
    res = solve(prob, method="nystrom", rank=12,
                key=torch.Generator().manual_seed(2))
    geom = NystromLowRank.from_point_clouds(
        x, y, eps=EPS, rank=12, generator=torch.Generator().manual_seed(2))
    want = solve(convert.ot_problem(geom, device="cpu"))
    assert float(res.cost) == float(want.cost) and res.n_iter == want.n_iter
    assert not bool(res.diverged)
    # the arc-cosine problem reaches nystrom too (its own anchors count)
    _, arc = _pair("arccos")
    assert not bool(solve(arc, method="nystrom").diverged)
    with pytest.raises(ValueError, match="point-cloud"):
        solve(_pair("dense")[1], method="arccos")
    with pytest.raises(ValueError, match="point-cloud"):
        solve(_pair("grid")[1], method="nystrom")


def test_grid_anneals_through_solve():
    from repro_torch.core import EpsSchedule

    ax = [np.linspace(0, 1, 6).astype(np.float32)] * 2
    a = _blob_weights((6, 6), (0.3, 0.3), 0)
    b = _blob_weights((6, 6), (0.7, 0.6), 1)
    prob = OTProblem.from_grid(ax, a=a, b=b, eps=0.05, device="cpu")
    cold = solve(prob, tol=1e-6, max_iter=5000)
    warm = solve(prob, tol=1e-6, max_iter=5000,
                 schedule=EpsSchedule(eps_init=0.8, decay=0.5))
    assert float(warm.cost) == pytest.approx(float(cold.cost), rel=1e-4)
    with pytest.raises(ValueError, match="annealing"):
        solve(_pair("arccos")[1], schedule=EpsSchedule(eps_init=1.0))
