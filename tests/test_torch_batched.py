"""repro_torch's batched slice against the JAX package, on the CPU: the
one-record front door (``SolveSpec``, ``RecoveryPolicy``, ``solve(spec)``),
the bucket cells, the batched engine (``BatchedSinkhorn``, ``solve_many``
and its engine LRU), the batched envelope VJPs and divergences, the
batched plain twins of the kernels, the cloud generators and the ported
quickstart.

The same numpy inputs go through the JAX package (``JAX_PLATFORMS=cpu``,
its engine ``vmap``ped and jitted) and through the port with
``device="cpu"``, where every kernel runs its plain PyTorch batched twin.
The CUDA kernels with their problem axis are held against those twins on
the card by chip_smoke.py (phase 2). Tolerances: engine costs 1e-5
relative and ``n_iter`` equal, or |d n_iter| <= 1 on Gaussian plans
(``tests/test_api.py``'s bound for batched against single solves);
potentials within 1e-4 of max |value|; divergences 1e-6 relative and
gradients within 1e-5 of max |grad| (``jax.grad`` of the JAX package's
batched divergence); plain twins 1e-4 relative as
``tests/test_kernels.py`` holds the JAX batched iteration.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.core import api as japi
from repro.core import divergence as jdiv
from repro.core import spec as jspec
from repro.core.features import gaussian_log_features as j_log_features
from repro.kernels import fused_batched_sinkhorn_iteration as j_batched_iter
from repro.resilience import policy as jpolicy
from repro_torch import convert
from repro_torch.configs import shapes
from repro_torch.core import (
    BatchedSinkhorn,
    EpsSchedule,
    ExecutionPolicy,
    FactoredPositive,
    GaussianFeatureMap,
    OTObjective,
    OTProblem,
    SolveSpec,
    clear_engine_cache,
    engine_cache_info,
    get_engine,
    rot_factored_batched,
    rot_log_factored_batched,
    set_engine_cache_capacity,
    sinkhorn_divergence_features_batched,
    sinkhorn_divergence_gaussian_batched,
    solve,
    solve_many,
)
from repro_torch.data import gaussian_clouds, highdim_clouds, sphere_clouds
from repro_torch.kernels import ref
from repro_torch.kernels.kermatvec import _contract_plan, _rows_plan
from repro_torch.kernels.logmatvec import _halfstep_plan
from repro_torch.kernels.ops import (
    fused_batched_sinkhorn_iteration,
    observe_plan_selection,
)
from repro_torch.resilience import RecoveryPolicy

EPS = 0.5
REL = 1e-5
P, N, M, R = 3, 48, 40, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at these sizes
    the port is op-overhead bound, and torch's pool otherwise contends
    with XLA's, and with the other test processes', on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32)).contiguous()


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    scale = float(np.max(np.abs(want[fin]))) if fin.any() else 0.0
    err = float(np.max(np.abs(got[fin] - want[fin]))) if fin.any() else 0.0
    assert err <= rel * scale, (err, scale)


def _clouds(p, n, m, seed, d=2):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((p, n, d)), -2, 2).astype(np.float32)
    y = np.clip(0.7 * rng.standard_normal((p, m, d)), -2, 2).astype(
        np.float32)
    return x, y


def _anchors(r=R, d=2, R_=3.0, eps=EPS, seed=4):
    fm = GaussianFeatureMap(r=r, d=d, eps=eps, R=R_)
    u = math.sqrt(fm.sigma2) * np.random.default_rng(seed).standard_normal(
        (r, d))
    return u.astype(np.float32), fm.q


def _log_features(pts, anchors, q, eps=EPS):
    """Lemma-1 log-features of stacked clouds, computed once in JAX and
    handed to both packages."""
    return np.stack([np.array(j_log_features(_j(p), _j(anchors), eps=eps,
                                               q=q)) for p in pts])


# ---------------------------------------------------------------------------
# RecoveryPolicy and SolveSpec
# ---------------------------------------------------------------------------

BAD_POLICIES = [dict(max_attempts=0), dict(eps_scale=1.0),
                dict(deadline_s=0.0), dict(rungs=("bogus",)),
                dict(rungs=("log_domain", "log_domain")),
                dict(accept=("bogus",)), dict(accept=())]


@pytest.mark.parametrize("kw", BAD_POLICIES,
                         ids=lambda kw: next(iter(kw)))
def test_recovery_policy_refusals_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jpolicy.RecoveryPolicy(**kw)
    with pytest.raises(ValueError) as got:
        RecoveryPolicy(**kw)
    assert str(got.value) == str(want.value)


def test_recovery_policy_fields_and_order_match_reference():
    pol = convert.recovery_policy(rungs=("cold_restart", "log_domain"),
                                  max_attempts=3, eps_scale=4.0)
    ref_pol = jpolicy.RecoveryPolicy(rungs=("cold_restart", "log_domain"),
                                     max_attempts=3, eps_scale=4.0)
    assert dataclass_fields(pol) == dataclass_fields(ref_pol)
    for verdict in ("diverged", "poisoned_warm_start"):
        assert pol.ordered_rungs(verdict) == ref_pol.ordered_rungs(verdict)
    assert RecoveryPolicy().rungs == jpolicy.RUNGS


def dataclass_fields(obj):
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _geom(seed=7, n=24, m=20, r=6):
    rng = np.random.default_rng(seed)
    xi = (np.abs(rng.normal(size=(n, r))) + 0.1).astype(np.float32)
    zeta = (np.abs(rng.normal(size=(m, r))) + 0.1).astype(np.float32)
    return xi, zeta


def test_spec_validation_and_bridges():
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    with pytest.raises(TypeError, match="Geometry"):
        SolveSpec(geometry=torch.ones(4, 4))
    with pytest.raises(ValueError, match="method"):
        SolveSpec(geometry=g, method="nope")
    with pytest.raises(TypeError, match="ExecutionPolicy"):
        SolveSpec(geometry=g, policy="cpu")
    with pytest.raises(TypeError, match="RecoveryPolicy"):
        SolveSpec(geometry=g, recovery="ladder")
    with pytest.raises(ValueError, match="no axis named"):
        solve(SolveSpec(geometry=g, policy=ExecutionPolicy(mesh=object())))
    spec = SolveSpec(geometry=g, method="factored")
    assert spec.eps == EPS and "FactoredPositive" in spec.describe()
    assert spec.replace(tol=1e-4).tol == 1e-4
    prob = spec.problem()
    assert isinstance(prob, OTProblem) and prob.a.device.type == "cpu"
    back = SolveSpec.from_problem(prob, method="factored", tol=1e-5)
    assert back.method == "factored" and back.tol == 1e-5
    assert set(spec.solver_kwargs()) == set(
        jspec.SolveSpec(geometry=_jfactored(xi, zeta)).solver_kwargs())


def _jfactored(xi, zeta):
    from repro.core.geometry import FactoredPositive as JFactored
    return JFactored(xi=_j(xi), zeta=_j(zeta), eps=EPS)


@pytest.mark.parametrize("method", ["factored", "log_factored"])
def test_solve_spec_equals_keyword_form_and_reference(method):
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    spec = SolveSpec(geometry=g, method=method, tol=1e-6)
    got = solve(spec)
    kw = solve(OTProblem.from_geometry(g, device="cpu"), method=method,
               tol=1e-6)
    assert float(got.cost) == float(kw.cost) and got.n_iter == kw.n_iter
    assert torch.equal(got.f, kw.f)
    want = japi.solve(jspec.SolveSpec(geometry=_jfactored(xi, zeta),
                                      method=method, tol=1e-6))
    assert _rel(got.cost, want.cost) <= REL
    assert abs(got.n_iter - int(want.n_iter)) <= 1


def test_solve_spec_annealed_and_policy_scope():
    rng = np.random.default_rng(3)
    x, y = (rng.normal(size=(k, 3)).astype(np.float32) for k in (24, 20))
    anchors = rng.normal(size=(32, 3)).astype(np.float32)
    g = convert.gaussian_point_cloud(x, y, anchors, eps=EPS, device="cpu")
    sched = EpsSchedule(eps_init=4.0, decay=0.5)
    spec = SolveSpec(geometry=g, method="log_factored", schedule=sched,
                     policy=ExecutionPolicy(device="cpu"))
    got = solve(spec)
    assert bool(got.converged)
    from repro.core.geometry import GaussianPointCloud as JGaussian
    jg = JGaussian.build(_j(x), _j(y), _j(anchors), eps=EPS)
    want = japi.solve(jspec.SolveSpec(
        geometry=jg, method="log_factored",
        schedule=japi.EpsSchedule(eps_init=4.0, decay=0.5)))
    assert _rel(got.cost, want.cost) <= REL
    # the policy's device is pinned inside its scope, as the JAX policy
    # pins its backend
    from repro_torch.kernels import backend
    with ExecutionPolicy(device="cpu").scope():
        assert backend.resolve_device() == torch.device("cpu")
    with ExecutionPolicy().scope():
        pass


def test_legacy_execution_kwargs_warn_and_spec_path_is_silent():
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    prob = OTProblem.from_geometry(g, device="cpu")
    with pytest.warns(DeprecationWarning, match="SolveSpec"):
        solve(prob, method="factored", use_pallas=False)
    with pytest.warns(DeprecationWarning, match="SolveSpec"):
        solve_many([prob], method="factored", precision="bf16")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve(SolveSpec(geometry=g, method="factored",
                        policy=ExecutionPolicy(use_pallas=False)))


def test_recovery_is_refused_by_both_front_doors():
    """No front door refuses ``recovery`` any more (the ladder is ported):
    a healthy spec solves as it does without a policy, through both."""
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    spec = SolveSpec(geometry=g, method="factored",
                     recovery=RecoveryPolicy())
    plain = solve(spec.replace(recovery=None))
    got = solve(spec)
    assert got.health.ok and got.n_iter == plain.n_iter
    assert torch.equal(got.f, plain.f)
    for res in solve_many([spec, spec]):
        assert res.health.ok
        assert float(res.cost) == pytest.approx(float(plain.cost), rel=REL)


def test_objective_spec_bridge():
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    obj = OTObjective(eps=EPS, tol=1e-6, max_iter=500,
                      policy=ExecutionPolicy(use_pallas=False))
    spec = obj.spec(g, method="factored")
    assert spec.tol == obj.tol and spec.max_iter == obj.max_iter
    assert spec.policy is obj.policy
    assert bool(solve(spec).converged)
    bad = FactoredPositive(xi=g.xi, zeta=g.zeta, eps=2 * EPS)
    with pytest.raises(ValueError, match="eps"):
        obj.spec(bad)


def test_convert_solve_spec_carries_the_fields():
    xi, zeta = _geom()
    g = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    a = np.full(24, 1 / 24, np.float32)
    spec = convert.solve_spec(
        g, a=a, method="factored", tol=1e-5, max_iter=300, precision="bf16",
        schedule=dict(eps_init=2.0, decay=0.5), seed=3,
        recovery=dict(max_attempts=2), device="cpu")
    assert spec.policy.precision == "bf16" and spec.max_iter == 300
    assert spec.schedule == EpsSchedule(eps_init=2.0, decay=0.5)
    assert isinstance(spec.key, torch.Generator)
    assert spec.recovery.max_attempts == 2
    assert torch.equal(spec.a, torch.as_tensor(a))


# ---------------------------------------------------------------------------
# Bucket cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 1000, 1024, 16384, 16385,
                               40000])
def test_buckets_match_reference(n):
    assert shapes.ot_bucket(n) == jshapes.ot_bucket(n)
    for max_batch in (1, 4, 32):
        assert shapes.ot_batch_bucket(n, max_batch) == \
            jshapes.ot_batch_bucket(n, max_batch)
    cell = shapes.OTBatchShape.for_problem(n, n + 7, 16)
    want = jshapes.OTBatchShape.for_problem(n, n + 7, 16)
    assert (cell.n_pad, cell.m_pad, cell.r) == (want.n_pad, want.m_pad,
                                                want.r)
    q = shapes.OTBatchShape.for_quadratic(n, 3)
    assert (q.n_pad, q.m_pad, q.r) == (jshapes.ot_bucket(n), 64, 0)
    for bad in (shapes.ot_bucket, lambda k: shapes.ot_batch_bucket(k, 4)):
        with pytest.raises(ValueError):
            bad(0)


# ---------------------------------------------------------------------------
# The batched engine
# ---------------------------------------------------------------------------


def _stacked_inputs(method, seed=5):
    """Stacked kernel data for ``method`` (P problems, n = 48, m = 40, r =
    8) and uniform weights, as numpy."""
    x, y = _clouds(P, N, M, seed)
    anchors, q = _anchors()
    if method in ("quadratic", "log_quadratic"):
        ka = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1).astype(
            np.float32)
        kb = ka
    else:
        ka, kb = _log_features(x, anchors, q), _log_features(y, anchors, q)
        if method == "factored":
            ka, kb = np.exp(ka), np.exp(kb)
    a = np.full((P, N), 1.0 / N, np.float32)
    b = np.full((P, M), 1.0 / M, np.float32)
    return ka, kb, a, b


ENGINE_METHODS = ["factored", "log_factored", "accelerated", "quadratic",
                  "log_quadratic"]


@pytest.mark.parametrize("method", ENGINE_METHODS)
def test_solve_stacked_matches_reference_and_single_solves(method):
    """Each lane of the port's batched solve against the JAX engine's lane
    (cost 1e-5 relative, n_iter within 1) and against the port's own
    single solve of that problem (the same bounds)."""
    ka, kb, a, b = _stacked_inputs(method)
    tol = 1e-5 if method == "accelerated" else 1e-6
    kw = dict(eps=EPS, method=method, tol=tol, max_iter=3000)
    got = BatchedSinkhorn(**kw).solve_stacked(_t(ka), _t(kb), _t(a), _t(b))
    want = japi.BatchedSinkhorn(**kw).solve_stacked(_j(ka), _j(kb), _j(a),
                                                    _j(b))
    assert got.cost.shape == (P,) and got.f.shape == (P, N)
    assert got.n_iter.dtype == torch.int64
    for i in range(P):
        assert _rel(got.cost[i], want.cost[i]) <= REL, i
        assert abs(int(got.n_iter[i]) - int(want.n_iter[i])) <= 1, i
        assert bool(got.converged[i]) == bool(want.converged[i])
        if method in ("quadratic", "log_quadratic"):
            prob = OTProblem.from_cost(ka[i], eps=EPS, device="cpu")
        elif method == "factored":
            prob = OTProblem.from_features(ka[i], kb[i], eps=EPS,
                                           device="cpu")
        else:
            prob = OTProblem.from_log_features(ka[i], kb[i], eps=EPS,
                                               device="cpu")
        one = solve(prob, method=method, tol=tol, max_iter=3000)
        assert _rel(got.cost[i], one.cost) <= REL, i
        assert abs(int(got.n_iter[i]) - one.n_iter) <= 1, i


@pytest.mark.parametrize("method", ["factored", "log_factored"])
def test_engine_takes_the_stacked_fused_plan_or_the_plain_operators(method):
    ka, kb, a, b = _stacked_inputs(method, seed=8)
    args = (_t(ka), _t(kb), _t(a), _t(b))
    with observe_plan_selection() as events:
        fused = BatchedSinkhorn(eps=EPS, method=method, tol=1e-6,
                                max_iter=3000).solve_stacked(*args)
    assert [e["kind"] for e in events] == [method]
    with observe_plan_selection() as events:
        plain = BatchedSinkhorn(eps=EPS, method=method, tol=1e-6,
                                max_iter=3000,
                                use_pallas=False).solve_stacked(*args)
    assert events == []
    assert torch.equal(fused.n_iter, plain.n_iter)
    for i in range(P):
        assert _rel(fused.cost[i], plain.cost[i]) <= REL


def test_engine_warm_start_and_captures_once_a_cell():
    """A warm start copied into the cell's buffers: the same cost in fewer
    iterations; a second solve of the cell replays its runner (no new
    capture), a solve at another problem count captures one more cell."""
    ka, kb, a, b = _stacked_inputs("log_factored", seed=9)
    eng = BatchedSinkhorn(eps=EPS, method="log_factored", tol=1e-6,
                          max_iter=3000)
    args = (_t(ka), _t(kb), _t(a), _t(b))
    cold = eng.solve_stacked(*args)
    assert eng.runners.captures == 1
    warm = eng.solve_stacked(*args, cold.f, cold.g)
    assert eng.runners.captures == 1 and eng.runners.hits >= 1
    for i in range(P):
        assert _rel(warm.cost[i], cold.cost[i]) <= 1e-6
        assert int(warm.n_iter[i]) < int(cold.n_iter[i])
    eng.solve_stacked(*(t[:2] for t in args))
    assert eng.runners.captures == 2
    with pytest.raises(ValueError, match="both f_init and g_init"):
        eng.solve_stacked(*args, cold.f)


def test_point_cloud_mode_with_a_schedule_matches_reference():
    x, y = _clouds(P, 40, 36, seed=13)
    anchors, _ = _anchors(r=16)
    sched = dict(eps_init=0.8, decay=0.4)
    kw = dict(eps=0.1, method="log_factored", tol=1e-5, max_iter=4000)
    got = BatchedSinkhorn(schedule=EpsSchedule(**sched),
                          **kw).solve_point_clouds(_t(x), _t(y),
                                                   _t(anchors), R=3.0)
    want = japi.BatchedSinkhorn(schedule=japi.EpsSchedule(**sched),
                                **kw).solve_point_clouds(
        _j(x), _j(y), _j(anchors), R=3.0)
    for i in range(P):
        assert _rel(got.cost[i], want.cost[i]) <= REL, i
        stages = len(EpsSchedule(**sched).stages(0.1))
        assert abs(int(got.n_iter[i]) - int(want.n_iter[i])) <= stages, i
        prob = OTProblem.from_point_clouds(x[i], y[i], anchors, eps=0.1,
                                           R=3.0, device="cpu")
        one = solve(prob, method="log_factored", tol=1e-5, max_iter=4000,
                    schedule=EpsSchedule(**sched))
        assert _rel(got.cost[i], one.cost) <= REL, i
    # the default R rounds the data radius up to the next 0.5
    eng = BatchedSinkhorn(**kw)
    r_default = math.ceil(float(np.max(np.linalg.norm(
        np.concatenate([x.reshape(-1, 2), y.reshape(-1, 2)]), axis=1))) * 2) / 2
    assert torch.allclose(eng.solve_point_clouds(_t(x), _t(y),
                                                 _t(anchors)).cost,
                          eng.solve_point_clouds(_t(x), _t(y), _t(anchors),
                                                 R=r_default).cost)
    with pytest.raises(ValueError, match="log domain"):
        BatchedSinkhorn(eps=0.1, method="factored").solve_point_clouds(
            _t(x), _t(y), _t(anchors))


def _ragged(sizes, seed, r=R):
    anchors, q = _anchors(r=r)
    out = []
    for i, (n, m) in enumerate(sizes):
        rng = np.random.default_rng(seed + i)
        x = np.clip(rng.standard_normal((n, 2)), -2, 2).astype(np.float32)
        y = np.clip(rng.standard_normal((m, 2)), -2, 2).astype(np.float32)
        out.append((np.array(j_log_features(_j(x), _j(anchors), eps=EPS,
                                             q=q)),
                    np.array(j_log_features(_j(y), _j(anchors), eps=EPS,
                                            q=q))))
    return out


def _problems(feats):
    port = [OTProblem.from_log_features(lx, ly, eps=EPS, device="cpu")
            for lx, ly in feats]
    jax_ = [japi.OTProblem.from_log_features(_j(lx), _j(ly), eps=EPS)
            for lx, ly in feats]
    return port, jax_


def test_ragged_solve_many_with_mixed_warm_and_cold_lanes_matches_reference():
    feats = _ragged([(60, 50), (60, 50), (40, 70), (100, 30)], seed=11)
    port, ref_ = _problems(feats)
    kw = dict(method="log_factored", tol=1e-6, max_iter=2000)
    cold = solve_many(port, **kw)
    want = japi.solve_many(ref_, **kw)
    for p, c, w in zip(port, cold, want):
        assert c.f.shape == p.a.shape and c.g.shape == p.b.shape
        assert _rel(c.cost, w.cost) <= REL
        assert abs(c.n_iter - int(w.n_iter)) <= 1
        one = solve(p, method="log_factored", tol=1e-6, max_iter=2000)
        assert _rel(c.cost, one.cost) <= REL
    f0 = [cold[0].f, None, None, cold[3].f]
    g0 = [cold[0].g, None, None, cold[3].g]
    warm = solve_many(port, f_inits=f0, g_inits=g0, **kw)
    jwarm = japi.solve_many(ref_, f_inits=[None if f is None else _j(f)
                                           for f in f0],
                            g_inits=[None if g is None else _j(g)
                                     for g in g0], **kw)
    for i, (c, w, jw) in enumerate(zip(cold, warm, jwarm)):
        assert _rel(w.cost, c.cost) <= 1e-6, i
        assert abs(w.n_iter - int(jw.n_iter)) <= 1, i
    assert warm[0].n_iter < cold[0].n_iter
    assert warm[1].n_iter == cold[1].n_iter       # the cold lane unchanged


def test_solve_many_takes_specs_and_quadratic_padding():
    xi1, zeta1 = _geom(1)
    xi2, zeta2 = _geom(2, n=30, m=17)
    specs = [SolveSpec(geometry=convert.factored_positive(
        xi=a_, zeta=b_, eps=EPS, device="cpu"), method="factored")
        for a_, b_ in ((xi1, zeta1), (xi2, zeta2))]
    got = solve_many(specs)
    want = japi.solve_many([jspec.SolveSpec(geometry=_jfactored(a_, b_),
                                            method="factored")
                            for a_, b_ in ((xi1, zeta1), (xi2, zeta2))])
    for g_, w_, s_ in zip(got, want, specs):
        assert _rel(g_.cost, w_.cost) <= REL
        assert _rel(g_.cost, solve(s_).cost) <= REL
    rng = np.random.default_rng(11)
    costs = [((rng.normal(size=(n, 1, 2)) - 0.5 * rng.normal(
        size=(1, m, 2))) ** 2).sum(-1).astype(np.float32)
        for n, m in ((30, 45), (50, 20))]
    got = solve_many([OTProblem.from_cost(c, eps=EPS, device="cpu")
                      for c in costs], method="log_quadratic", tol=1e-7,
                     max_iter=4000)
    want = japi.solve_many([japi.OTProblem.from_cost(_j(c), eps=EPS)
                            for c in costs], method="log_quadratic",
                           tol=1e-7, max_iter=4000)
    for g_, w_ in zip(got, want):
        assert _rel(g_.cost, w_.cost) <= REL


def _refusal_cases():
    feats = _ragged([(60, 50)], seed=12)
    port, _ = _problems(feats)
    f, g = torch.zeros(60), torch.zeros(50)
    xi, zeta = _geom()
    gm = convert.factored_positive(xi=xi, zeta=zeta, eps=EPS, device="cpu")
    s1 = SolveSpec(geometry=gm, method="factored", tol=1e-6)
    return {
        "engine-method": (lambda: BatchedSinkhorn(eps=0.5, method="sharded"),
                          ValueError, "batched engine supports"),
        "engine-schedule": (lambda: BatchedSinkhorn(
            eps=0.5, method="factored", schedule=EpsSchedule(eps_init=1.0)),
            ValueError, "log domain"),
        "stacked-schedule": (lambda: BatchedSinkhorn(
            eps=0.5, schedule=EpsSchedule(eps_init=1.0)).solve_stacked(
            *(torch.zeros(1, 2, 2),) * 2, torch.ones(1, 2), torch.ones(1, 2)),
            ValueError, "solve_point_clouds"),
        "one-init": (lambda: solve_many(port, f_inits=[f]), ValueError,
                     "both f_inits and g_inits"),
        "init-count": (lambda: solve_many(port, f_inits=[f, f],
                                          g_inits=[g, g]),
                       ValueError, "must match problems"),
        "init-pair": (lambda: solve_many(port, f_inits=[f], g_inits=[None]),
                      ValueError, "both f_init and g_init"),
        "mesh-inits": (lambda: solve_many(port, mesh=object(), f_inits=[f],
                                          g_inits=[g]),
                       ValueError, "warm starts"),
        "mesh": (lambda: solve_many(port, mesh=object()),
                 ValueError, "no axis named"),
        "mesh-method": (lambda: solve_many(port, method="nystrom",
                                           mesh=object()),
                        ValueError, "supports methods"),
        "mixed-eps": (lambda: solve_many(port + [OTProblem.from_features(
            xi, zeta, eps=0.7, device="cpu")]), ValueError, "mixed"),
        "engine-eps": (lambda: get_engine(eps=0.7).solve_many(port),
                       ValueError, "one engine per eps"),
        "specs-heterogeneous": (lambda: solve_many(
            [s1, s1.replace(tol=1e-4)]), ValueError, "heterogeneous"),
        "specs-mixed": (lambda: solve_many(
            [s1, OTProblem.from_geometry(gm, device="cpu")]), TypeError,
            "mixed"),
        "specs-schedule": (lambda: solve_many(
            [s1.replace(schedule=EpsSchedule(eps_init=1.0))]), ValueError,
            "schedule"),
        "accelerated-momentum": (lambda: BatchedSinkhorn(
            eps=0.5, method="accelerated", momentum=1.3).solve_stacked(
            *(torch.zeros(1, 2, 2),) * 2, torch.ones(1, 2) / 2,
            torch.ones(1, 2) / 2), ValueError, "momentum"),
    }


REFUSALS = sorted(_refusal_cases())


@pytest.mark.parametrize("case", REFUSALS)
def test_engine_refusals(case):
    fn, exc, match = _refusal_cases()[case]
    with pytest.raises(exc, match=match):
        fn()


def _lru_sequence(mod):
    mod.clear_engine_cache()
    cap = mod.engine_cache_info()["capacity"]
    seen = []
    try:
        mod.set_engine_cache_capacity(2)
        e1 = mod.get_engine(eps=0.5, tol=1e-4)
        seen.append(mod.get_engine(eps=0.5, tol=1e-4) is e1)
        mod.get_engine(eps=0.6, tol=1e-4)
        mod.get_engine(eps=0.5, tol=1e-4)
        mod.get_engine(eps=0.7, tol=1e-4)
        seen.append(mod.engine_cache_info())
        seen.append(mod.get_engine(eps=0.5, tol=1e-4) is e1)
        seen.append(mod.get_engine(eps=0.6, tol=1e-4) is e1)
        mod.set_engine_cache_capacity(1)
        seen.append(mod.engine_cache_info())
        return seen
    finally:
        mod.clear_engine_cache()
        mod.set_engine_cache_capacity(cap)


def test_engine_lru_counters_match_reference():
    from repro_torch.core import api
    assert _lru_sequence(api) == _lru_sequence(japi)
    assert engine_cache_info()["size"] == 0
    with pytest.raises(ValueError):
        set_engine_cache_capacity(0)
    clear_engine_cache()


def test_a_nan_lane_leaves_its_siblings_bitwise_unchanged():
    """A problem whose factor holds a NaN, swapped into a batch: the other
    lanes keep every bit (lanes stop on their own; the kernels never mix
    problems), as the JAX package's vmapped lanes do."""
    ka, kb, a, b = _stacked_inputs("factored", seed=21)
    bad = ka.copy()
    bad[1, 3] = np.nan
    eng = BatchedSinkhorn(eps=EPS, method="factored", tol=1e-6,
                          max_iter=400)
    clean = eng.solve_stacked(_t(ka), _t(kb), _t(a), _t(b))
    poisoned = eng.solve_stacked(_t(bad), _t(kb), _t(a), _t(b))
    for i in (0, 2):
        assert torch.equal(poisoned.f[i], clean.f[i])
        assert torch.equal(poisoned.g[i], clean.g[i])
        assert int(poisoned.n_iter[i]) == int(clean.n_iter[i])
    assert not bool(torch.isfinite(poisoned.cost[1]))


# ---------------------------------------------------------------------------
# Batched envelope VJPs and divergences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_domain", [False, True], ids=["scaling", "log"])
def test_batched_divergence_and_gradients_match_jax_grad(log_domain):
    x, y = _clouds(P, 32, 28, seed=17)
    anchors, q = _anchors(r=12)
    lx, ly = _log_features(x, anchors, q), _log_features(y, anchors, q)
    if not log_domain:
        lx, ly = np.exp(lx), np.exp(ly)
    a = np.random.default_rng(2).uniform(0.5, 1.5, (P, 32)).astype(np.float32)
    a /= a.sum(-1, keepdims=True)
    b = np.full((P, 28), 1 / 28, np.float32)
    # tol 1e-6 converges in float32: the weights' gradients are the
    # potentials, which a solve stopped at max_iter leaves free to drift
    # along their additive constant
    kw = dict(eps=EPS, tol=1e-6, max_iter=2000, log_domain=log_domain)
    leaves = [_t(v).requires_grad_(True) for v in (lx, ly, a, b)]
    got = sinkhorn_divergence_features_batched(*leaves, **kw)
    grads = torch.autograd.grad(got.sum(), leaves)

    def jfun(*args):
        div = jdiv.sinkhorn_divergence_features_batched(*args, **kw)
        return jnp.sum(div), div

    jargs = [_j(v) for v in (lx, ly, a, b)]
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)
    scale = float(np.max(np.abs(np.asarray(want))))
    assert float(np.max(np.abs(got.detach().numpy() - np.asarray(want)))) \
        <= 1e-6 * max(scale, 1.0)
    for g_, w_ in zip(grads, jgrads):
        _close_to_max(g_.numpy(), w_, rel=1e-5)
    rot = rot_log_factored_batched if log_domain else rot_factored_batched
    w_xy = rot(*(_t(v) for v in (lx, ly, a, b)), EPS, 1e-6, 2000)
    assert w_xy.shape == (P,)


def test_gaussian_batched_divergence_differentiates_clouds_and_anchors():
    x, y = _clouds(P, 24, 20, seed=19)
    anchors, q = _anchors(r=10)
    kw = dict(eps=EPS, q=q, tol=1e-6, max_iter=2000)
    leaves = [_t(v).requires_grad_(True) for v in (x, y, anchors)]
    got = sinkhorn_divergence_gaussian_batched(*leaves, **kw)
    grads = torch.autograd.grad(got.sum(), leaves)

    def jfun(*args):
        div = jdiv.sinkhorn_divergence_gaussian_batched(*args, **kw)
        return jnp.sum(div), div

    jargs = [_j(v) for v in (x, y, anchors)]
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2), has_aux=True))(*jargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for g_, w_ in zip(grads, jgrads):
        _close_to_max(g_.numpy(), w_, rel=1e-5)


# ---------------------------------------------------------------------------
# The kernels' batched plain twins and the stacked plans' geometry
# ---------------------------------------------------------------------------


def test_batched_iteration_matches_the_reference_kernels():
    """The port's batched iteration (each kernel's stacked twin on the
    CPU) against the JAX package's Pallas batched iteration in interpret
    mode, problem by problem, as ``tests/test_kernels.py`` holds it."""
    rng = np.random.default_rng(3)
    Pb, n, m, r = 3, 64, 48, 32
    xi = (rng.uniform(size=(Pb, n, r)) + 0.05).astype(np.float32)
    zeta = (rng.uniform(size=(Pb, m, r)) + 0.05).astype(np.float32)
    a = np.full((Pb, n), 1.0 / n, np.float32)
    b = np.full((Pb, m), 1.0 / m, np.float32)
    u, ju = torch.ones(Pb, n), jnp.ones((Pb, n))
    for _ in range(5):
        u, v = fused_batched_sinkhorn_iteration(_t(xi), _t(zeta), _t(a),
                                                _t(b), u)
        ju, jv = j_batched_iter(_j(xi), _j(zeta), _j(a), _j(b), ju,
                                backend="interpret")
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4)
    # each stacked twin equals its 2-D version problem by problem
    t = ref.feature_contract_ref(_t(xi), u[..., None])
    lt = ref.log_feature_contract_ref(torch.log(_t(xi)), u[..., None])
    for i in range(Pb):
        assert torch.allclose(t[i], ref.feature_contract_ref(
            _t(xi[i]), u[i][:, None]), rtol=1e-6)
        assert torch.allclose(lt[i], ref.log_feature_contract_ref(
            torch.log(_t(xi[i])), u[i][:, None]), rtol=1e-6)
        lh = ref.log_halfstep_ref(torch.log(_t(zeta)), lt,
                                  torch.zeros(Pb, m, 1), scale=-1.0)
        assert torch.allclose(lh[i], ref.log_halfstep_ref(
            torch.log(_t(zeta[i])), lt[i], torch.zeros(m, 1), scale=-1.0))


SMS, WAVE = 132, 2


@pytest.mark.parametrize("Pn", [1, 3, 32, 300])
@pytest.mark.parametrize("n,r,vec,es", [(1024, 256, True, 4),
                                        (1001, 256, True, 2),
                                        (777, 1000, False, 4)])
def test_stacked_plans_fit_one_wave_and_depend_on_shape_only(Pn, n, r, vec,
                                                             es):
    """A contract over P problems meets at its grid barrier only where all
    P * splits * col_tiles * chunks CTAs fit one wave; past that each
    problem takes one slab and no barrier. At P = 1 every plan is the
    single-problem one. The row kernels' grid is a problem's CTAs."""
    B = 1 if vec else 3
    plan = _contract_plan(n, r, B, vec, es, SMS, WAVE, P=Pn)
    ctas = Pn * plan.grid
    assert plan.splits == 1 or ctas <= SMS * WAVE
    assert plan.splits * plan.rows_per_split >= n
    assert plan == _contract_plan(n, r, B, vec, es, SMS, WAVE, P=Pn)
    if Pn == 1:
        assert plan == _contract_plan(n, r, B, vec, es, SMS, WAVE)
    rows = _rows_plan(n, r, B, vec, es, SMS, 8, P=Pn)
    assert rows.grid >= 1 and (Pn * rows.grid <= SMS * 8 or rows.grid == 1)
    half = _halfstep_plan(n, r, B, vec, es, SMS, 8, P=Pn)
    assert half.grid >= 1 and (Pn * half.grid <= SMS * 8 or half.grid == 1)


def test_stacked_wrappers_check_shapes():
    from repro_torch.kernels import feature_contract, log_halfstep
    with pytest.raises(ValueError, match="problems first"):
        feature_contract(torch.ones(2, 2, 3, 4), torch.ones(2, 2, 3, 1))
    with pytest.raises(ValueError, match="shape mismatch"):
        feature_contract(torch.ones(2, 5, 3), torch.ones(3, 5, 1))
    with pytest.raises(ValueError, match="shape mismatch"):
        log_halfstep(torch.ones(2, 5, 3), torch.ones(2, 3, 1),
                     torch.ones(2, 4, 1))


# ---------------------------------------------------------------------------
# Cloud generators and the quickstart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen,d", [(gaussian_clouds, 3),
                                   (sphere_clouds, 3),
                                   (highdim_clouds, 28)])
def test_cloud_generators_shapes_dtype_and_seed(gen, d):
    kw = dict(device="cpu")
    args = (7, 50, d) if gen is not sphere_clouds else (7, 50)
    x, y = gen(*args, **kw)
    assert x.shape == (50, d) and y.shape == (50, d)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    x2, y2 = gen(*args, **kw)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = gen(8, *args[1:], **kw)
    assert not torch.equal(x, x3)
    if gen is sphere_clouds:
        assert torch.allclose(torch.linalg.norm(x, dim=1), torch.ones(50))
    if gen is gaussian_clouds:
        big, small = gen(0, 4000, 2, **kw)
        assert abs(float(big.mean()) - 1.0) < 0.05
        assert abs(float(small.var()) - 0.1) < 0.01


def test_quickstart_runs_on_the_cpu():
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--n", "300", "--r", "48",
                           "--small", "120", "--batch", "3",
                           "--batch-n", "40"])
    assert abs(out["factored"] - out["exact"]) < 0.05 * abs(out["exact"])
    assert out["annealed_iters"] <= out["cold_iters"]
    assert out["batch_costs"].shape == (3,)
    assert bool(torch.isfinite(out["batch_costs"]).all())
    assert out["after_step"] < out["divergence"]


def test_megakernel_cadence_at_one_problem_and_per_iteration_beyond(
        monkeypatch):
    """With ``inner_steps=8`` a stacked plan runs the megakernel block
    step at any P, as the JAX package vmaps its megakernel: at P = 1 and
    at P = 3 one block launch serves every problem (on the card one
    cluster a problem), so a solve launches as many blocks as its slowest
    lane needs, and each lane's ``n_iter`` and cost equal its own single
    solve's."""
    from repro_torch.kernels import ops
    calls = []
    block = ops.log_sinkhorn_block
    monkeypatch.setattr(ops, "log_sinkhorn_block",
                        lambda *a_, **k_: calls.append(1) or block(*a_, **k_))
    ka, kb, a, b = _stacked_inputs("log_factored", seed=27)
    kw = dict(eps=EPS, method="log_factored", tol=1e-6, max_iter=3000,
              inner_steps=8)
    one = BatchedSinkhorn(**kw).solve_stacked(*(_t(v[:1]) for v in
                                                (ka, kb, a, b)))
    blocks = len(calls)
    assert blocks == int(one.n_iter[0]) // 8
    many = BatchedSinkhorn(**kw).solve_stacked(_t(ka), _t(kb), _t(a), _t(b))
    assert len(calls) - blocks == int(many.n_iter.max()) // 8
    for i in range(P):
        single = solve(SolveSpec(geometry=convert.factored_positive(
            log_xi=ka[i], log_zeta=kb[i], eps=EPS, device="cpu"),
            method="log_factored", tol=1e-6, max_iter=3000,
            policy=ExecutionPolicy(inner_steps=8)))
        assert single.n_iter % 8 == 0
        assert int(many.n_iter[i]) == single.n_iter
        assert _rel(many.cost[i], single.cost) <= REL
        if i == 0:
            assert int(one.n_iter[0]) == single.n_iter
            assert _rel(one.cost[0], single.cost) <= REL
