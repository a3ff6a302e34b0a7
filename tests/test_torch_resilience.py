"""repro_torch's recovery ladder, chaos injection and the service's
resilience against the JAX package, on the CPU: ``solve_with_recovery``
climbs the same rungs to the same verdicts, ``solve(spec)`` and
``solve_many(specs)`` take a recovery policy, the service isolates a bad
lane, quarantines, sheds and never serves a poisoned warm entry, the
injector draws what the reference's draws, a kernel fault is never
absorbed, and the driver's ``--chaos --strict`` lane passes.

The same numpy inputs go through the JAX package (``JAX_PLATFORMS=cpu``)
and through the port with ``device="cpu"``. Tolerances: rungs, verdicts,
attempts and counters equal; recovered costs 1e-5 relative (1e-6
absolute), healthy lanes' potentials within 1e-5 of max |value|, as
``tests/test_resilience.py`` holds the JAX ladder against its log-domain
ground truth.
"""
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import spec as jspec
from repro.core.geometry import GaussianPointCloud as JGaussianPointCloud
from repro.resilience import chaos as jchaos
from repro.resilience import ladder as jladder
from repro.resilience import policy as jpolicy
from repro.serving import service as jservice
from repro_torch.core import OTProblem, SolveSpec, solve, solve_many
from repro_torch.kernels.build import KernelError
from repro_torch.launch import ot_service
from repro_torch.resilience import ladder
from repro_torch.resilience import (
    ChaosInjector,
    ChaosSpec,
    RecoveryPolicy,
    solve_with_recovery,
)
from repro_torch.serving import OTService, QuarantineError, QueueFullError

EPS = 0.5
SMALL_EPS = 1e-4       # scaling-domain Gaussian features underflow here
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file, restored after it: at these sizes
    the port is op-overhead bound, and torch's pool otherwise contends
    with XLA's, and with the other test processes', on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feature_arrays(n, m, r=8, seed=0, nan_row=None):
    rng = np.random.default_rng(seed)
    xi = np.asarray(rng.uniform(0.05, 1.05, (n, r)), np.float32)
    zeta = np.asarray(rng.uniform(0.05, 1.05, (m, r)), np.float32)
    if nan_row is not None:
        xi[nan_row] = np.nan
    a = np.asarray(rng.dirichlet(np.full(n, 2.0)), np.float32)
    b = np.asarray(rng.dirichlet(np.full(m, 2.0)), np.float32)
    return xi, zeta, a / a.sum(), b / b.sum()


def _features(n, m, eps=EPS, **kw):
    """(JAX problem, port problem) on the same explicit features."""
    arrays = _feature_arrays(n, m, **kw)
    return (japi.OTProblem.from_features(*arrays, eps=eps),
            OTProblem.from_features(*arrays, eps=eps, device="cpu"))


def _gauss(n=14, m=12, r=8, seed=0, eps=SMALL_EPS):
    """(JAX problem, port problem) on point clouds: at a small eps the
    scaling kernel underflows and the log domain recovers."""
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.normal(size=(n, 2)), np.float32)
    y = np.asarray(rng.normal(size=(m, 2)), np.float32)
    anchors = np.asarray(rng.normal(size=(r, 2)), np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    b = np.full(m, 1.0 / m, np.float32)
    jp = japi.OTProblem.from_geometry(
        JGaussianPointCloud.build(x, y, anchors, eps=eps), a, b)
    return jp, OTProblem.from_point_clouds(x, y, anchors, a, b, eps=eps,
                                           device="cpu")


def _cost_close(got, want):
    want = float(want)
    assert abs(float(got) - want) <= 1e-6 + REL * abs(want), (got, want)


def _verdicts(rec):
    return [(name, h.verdict) for name, h in rec.history]


# -- the core ladder ----------------------------------------------------------


LADDER_CASES = {
    # a scaling solve that underflows at small eps: the log rung recovers
    "underflow": (lambda: _gauss(seed=3), dict(tol=1e-4, max_iter=300), {}),
    # NaN features defeat every rung within the attempt budget
    "unrecoverable": (lambda: _features(10, 9, seed=7, nan_row=1),
                      dict(tol=1e-6, max_iter=50), dict(max_attempts=3)),
    "healthy": (lambda: _features(10, 9, seed=5),
                dict(tol=1e-6, max_iter=500), {}),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_solve_with_recovery_matches_reference(case):
    make, kw, pol = LADDER_CASES[case]
    jp, p = make()
    want = jladder.solve_with_recovery(jspec.SolveSpec.from_problem(
        jp, method="factored", recovery=jpolicy.RecoveryPolicy(**pol), **kw))
    spec = SolveSpec.from_problem(p, method="factored",
                                  recovery=RecoveryPolicy(**pol), **kw)
    got = solve_with_recovery(spec)
    assert got.rungs == want.rungs
    assert got.attempts == want.attempts
    assert _verdicts(got) == _verdicts(want)
    assert got.recovered == want.recovered
    assert got.health.verdict == want.health.verdict
    if got.health.finite:
        _cost_close(got.result.cost, want.result.cost)
    # solve(spec) with the policy set runs the same ladder
    res = solve(spec)
    assert res.health.verdict == got.health.verdict
    if res.health.finite:
        assert torch.equal(res.f, got.result.f)


def test_solve_many_recovers_a_diverged_lane_and_leaves_siblings_alone():
    """A lane that diverges in a ``solve_many(specs)`` bucket climbs the
    ladder alone; its siblings are bit-identical to the same batch without
    a policy, and the recovered lane is the reference's."""
    healthy = [_features(14, 12, eps=SMALL_EPS, seed=s)[1] for s in (1, 2)]
    jbad, bad = _gauss(seed=3)

    def specs(recovery):
        return [SolveSpec.from_problem(p, method="factored", tol=1e-4,
                                       max_iter=300, recovery=recovery)
                for p in (healthy[0], bad, healthy[1])]

    rec = solve_many(specs(RecoveryPolicy()))
    plain = solve_many(specs(None))
    assert plain[1].health.failed and rec[1].health.finite
    for i in (0, 2):
        assert rec[i].n_iter == plain[i].n_iter
        assert torch.equal(rec[i].f, plain[i].f)
        assert torch.equal(rec[i].g, plain[i].g)
        assert rec[i].health.ok
    want = japi.solve_many([jspec.SolveSpec.from_problem(
        jbad, method="factored", tol=1e-4, max_iter=300,
        recovery=jpolicy.RecoveryPolicy())])[0]
    _cost_close(rec[1].cost, want.cost)


def test_per_iteration_rung_keeps_the_fused_plan(monkeypatch):
    """The ``per_iteration`` rung drops the megakernel (one iteration a
    launch, a check every iteration) and leaves ``use_pallas`` unset, so
    on the card it runs the per-iteration CUDA kernels and never the plain
    operators: in the ladder's transitions and in every attempt
    ``solve_with_recovery`` makes on an input no rung can rescue."""
    from repro_torch.core import api

    st = ladder._LadderState(method="factored", precision="bf16",
                             use_pallas=None, inner_steps=None,
                             check_every=None)
    assert ladder.degrade(st, "per_iteration")
    assert (st.use_pallas, st.inner_steps, st.check_every) == (None, 1, 1)
    assert not ladder.degrade(st, "per_iteration")     # already there
    seen = []
    real = api.solve

    def spy(spec, *args, **kw):
        seen.append(spec.policy)
        return real(spec, *args, **kw)

    monkeypatch.setattr(api, "solve", spy)
    _, p = _features(10, 9, seed=7, nan_row=1)
    rec = solve_with_recovery(SolveSpec.from_problem(
        p, method="factored", tol=1e-6, max_iter=50,
        recovery=RecoveryPolicy()))
    assert "per_iteration" in rec.rungs and not rec.health.finite
    assert seen and all(pol.use_pallas is None for pol in seen)
    assert (seen[-1].inner_steps, seen[-1].check_every) == (1, 1)


# -- the service's ladder ------------------------------------------------------


@pytest.fixture(scope="module")
def services():
    """A reference and a port service with the recovery ladder on, at the
    small eps where Gaussian features underflow, warmed up (main and rung
    runners) on the one cell the tests below use."""
    kw = dict(eps=SMALL_EPS, method="factored", tol=1e-4, max_iter=300,
              max_batch=4, max_wait=0.0, recovery=None, quarantine_after=2)
    out = []
    for cls, dev, pol in ((jservice.OTService, {}, jpolicy.RecoveryPolicy),
                          (OTService, {"device": "cpu"}, RecoveryPolicy)):
        svc = cls(**dict(kw, recovery=pol()), **dev)
        svc.warmup([(14, 12, 8)])
        svc.warmup_recovery([(14, 12, 8)])
        out.append(svc)
    return tuple(out)


def _recovery_stats(svc):
    s = svc.stats()
    return dict(s["recovery"], health=s["health"], served=s["served"],
                shed=s["shed"], runner=s["runner"], warm=s["warm"])


def test_service_isolates_a_bad_lane_and_recovers_like_the_reference(
        services):
    jsvc, svc = services
    pairs = [_features(14, 12, eps=SMALL_EPS, seed=1), _gauss(seed=4),
             _features(14, 12, eps=SMALL_EPS, seed=9, nan_row=0),
             _features(14, 12, eps=SMALL_EPS, seed=2)]
    jt = [jsvc.submit(jp) for jp, _ in pairs]
    tt = [svc.submit(p) for _, p in pairs]
    jsvc.drain()
    svc.drain()
    assert all(t.done for t in tt)
    for want, got in zip(jt, tt):
        assert got.rungs == want.rungs and got.attempts == want.attempts
        assert (got.refusal is None) == (want.refusal is None)
        if got.refusal is not None:
            assert got.refusal.reason == want.refusal.reason
            assert got.result is None
            continue
        assert got.health.verdict == want.health.verdict
        _cost_close(got.result.cost, want.result.cost)
        for name in ("f", "g"):
            w = np.asarray(getattr(want.result, name))
            assert np.abs(getattr(got.result, name).numpy() - w).max() <= \
                REL * max(np.abs(w).max(), 1.0)
    assert tt[1].rungs == ("log_domain",) and tt[1].health.finite
    assert tt[2].refusal.reason == "recovery_exhausted"
    assert _recovery_stats(svc) == _recovery_stats(jsvc)
    # the refused lane climbed past per_iteration on a pre-captured rung
    # runner that keeps the fused plan (use_pallas unset), as every rung
    # configuration does
    assert "per_iteration" in tt[2].rungs
    engines = [c.engine for c in svc._rung_caches.values()]
    assert any(e.inner_steps == e.check_every == 1 for e in engines)
    assert all(e.use_pallas is None for e in engines)


def test_service_quarantines_sheds_and_refuses_like_the_reference(services):
    jsvc, svc = services
    jbad, bad = _features(14, 12, eps=SMALL_EPS, seed=13, nan_row=2)
    for s, p in ((jsvc, jbad), (svc, bad)):
        for _ in range(2):
            t = s.submit(p)
            s.drain()
            assert t.refusal is not None
        with pytest.raises(QuarantineError if s is svc else
                           jservice.QuarantineError):
            s.submit(p)
    assert _recovery_stats(svc) == _recovery_stats(jsvc)
    assert svc.stats()["recovery"]["quarantined"] >= 1
    # shedding at max_depth: the queue refuses past its bound
    shed = OTService(eps=EPS, method="factored", tol=1e-6, max_batch=8,
                     max_wait=10.0, max_depth=2, device="cpu")
    _, ok = _features(10, 9, seed=14)
    shed.submit(ok)
    shed.submit(ok)
    with pytest.raises(QueueFullError):
        shed.submit(ok)
    assert shed.stats()["shed"] == 1 and shed.drain() == 2
    assert shed.submit(ok) is not None


def test_a_poisoned_warm_entry_never_reaches_the_next_request(services):
    jsvc, svc = services
    # a diverged solve's potentials are refused on store ...
    plain = OTService(eps=EPS, method="factored", tol=1e-6, max_iter=50,
                      max_batch=1, device="cpu")
    _, bad = _features(10, 9, seed=11, nan_row=3)
    t1 = plain.submit(bad)
    plain.drain()
    assert t1.health.failed and plain.warm.snapshot()["poisoned_rejects"] >= 1
    t2 = plain.submit(bad)
    plain.drain()
    assert not t2.warm_hit
    # ... and an entry corrupted in the cache is evicted on lookup: the
    # exact repeat solves cold, as the reference's does
    jp, p = _features(14, 12, eps=SMALL_EPS, seed=21)
    for s, prob in ((jsvc, jp), (svc, p)):
        s.solve_many([prob])
        ka, kb = s.engine.kernel_data(prob)
        keys = s.warm.keys_for(np.asarray(ka), np.asarray(kb),
                               np.asarray(prob.a), np.asarray(prob.b))
        jchaos.ChaosInjector(jchaos.ChaosSpec()).poison_warm_cache(
            s.warm, *keys, 14, 12)
    jt, tt = jsvc.submit(jp), svc.submit(p)
    jsvc.drain()
    svc.drain()
    assert not tt.warm_hit and not jt.warm_hit
    assert tt.health.ok and np.isfinite(tt.result.f.numpy()).all()
    _cost_close(tt.result.cost, jt.result.cost)
    assert svc.stats()["warm"] == jsvc.stats()["warm"]


# -- chaos --------------------------------------------------------------------


def test_chaos_injector_draws_match_reference():
    """One seed, one call order: the same fault classes, corrupted rows,
    hook draws and clock skews as the reference's injector."""
    kw = dict(seed=5, nan_feature_frac=0.25, inf_feature_frac=0.125,
              nan_weight_frac=0.125, runner_fault_frac=0.3,
              clock_skew_s=0.01)
    want_inj, got_inj = jchaos.ChaosInjector(jchaos.ChaosSpec(**kw)), \
        ChaosInjector(ChaosSpec(**kw))
    assert got_inj.assign_faults(16) == want_inj.assign_faults(16)
    xi = np.ones((6, 3), np.float32)
    for kind in ("nan_feature", "inf_feature", "nan_feature"):
        np.testing.assert_array_equal(got_inj.corrupt_features(xi, kind),
                                      want_inj.corrupt_features(xi, kind))
    np.testing.assert_array_equal(
        got_inj.corrupt_weights(np.ones(5, np.float32)),
        want_inj.corrupt_weights(np.ones(5, np.float32)))
    hooks = got_inj.fault_hook(), want_inj.fault_hook()
    for _ in range(20):
        raised = []
        for hook in hooks:
            try:
                hook((64, 64, 8), 2)
                raised.append(False)
            except RuntimeError as exc:
                assert "chaos" in str(exc)
                raised.append(True)
        assert raised[0] == raised[1]
    base = lambda: 100.0
    skews = got_inj.skewed(base), want_inj.skewed(base)
    assert [skews[0]() for _ in range(8)] == [skews[1]() for _ in range(8)]
    assert got_inj.stats() == want_inj.stats()
    assert got_inj.runner_faults > 0
    with pytest.raises(ValueError, match="partition"):
        ChaosSpec(nan_feature_frac=0.8, inf_feature_frac=0.3)


@pytest.mark.parametrize("fault", ["kernel", "chaos"])
def test_kernel_faults_leave_drain_and_chaos_faults_are_absorbed(
        monkeypatch, fault):
    """With recovery on, a runner's own exception (here the chaos hook's
    ``RuntimeError``) is absorbed and the request served down the ladder;
    a ``KernelError`` from the stacked solve is re-raised by ``drain``, in
    the dispatch and in the ladder alike, never served by other
    operators."""
    svc = OTService(eps=EPS, method="factored", tol=1e-6, max_batch=2,
                    recovery=RecoveryPolicy(), device="cpu")
    _, p = _features(10, 9, seed=15)
    if fault == "chaos":
        inj = ChaosInjector(ChaosSpec(runner_fault_frac=1.0,
                                      nan_feature_frac=0.0,
                                      inf_feature_frac=0.0,
                                      nan_weight_frac=0.0))
        svc.chaos_hook = inj.fault_hook()
        t = svc.submit(p)
        svc.drain()
        assert t.health.ok and t.rungs == ("cold_restart",)
        assert svc.stats()["recovery"]["runner_faults"] == inj.runner_faults
        return
    svc.warmup([(10, 9, 8)])
    svc.warmup_recovery([(10, 9, 8)])

    def broken(*args, **kw):
        raise KernelError("feature_contract: CUDA launch failed (700)")

    monkeypatch.setattr(svc.engine, "solve_stacked", broken)
    t = svc.submit(p)
    with pytest.raises(KernelError):
        svc.drain()
    assert not t.done and svc.stats()["recovery"]["runner_faults"] == 0
    # in the ladder too: a runner fault sends the request up the ladder,
    # whose rung runner then fails to launch
    monkeypatch.undo()
    svc.chaos_hook = lambda shape, batch: (_ for _ in ()).throw(
        RuntimeError("runner fault"))
    for cache in svc._rung_caches.values():
        monkeypatch.setattr(cache.engine, "solve_stacked", broken)
    svc.submit(p)
    with pytest.raises(KernelError):
        svc.drain()
    assert svc.stats()["recovery"]["runner_faults"] == 1


def test_ot_service_driver_chaos_lane_strict(capsys):
    rc = ot_service.main(["--device", "cpu", "--strict", "--chaos",
                          "--pool", "16", "--requests", "48"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "unhandled exceptions=0" in out and "NaN results served=0" in out
    assert "poisoned_evictions=1" in out


def test_device_fault_tells_kernel_faults_from_runner_faults(monkeypatch,
                                                            tmp_path):
    from repro_torch.kernels import build

    assert build.device_fault(KernelError("launch failed"))
    assert build.device_fault(RuntimeError("CUDA error: an illegal memory "
                                           "access was encountered"))
    assert not build.device_fault(RuntimeError("chaos: injected runner "
                                               "fault"))
    assert not build.device_fault(ValueError("CUDA error"))
    # a refused toolchain is a KernelError too
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(KernelError, match="nvcc not found"):
        build.nvcc_path()
