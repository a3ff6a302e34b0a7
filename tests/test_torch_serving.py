"""repro_torch's serving front end against the JAX package, on the CPU: the
fingerprints and the warm-start cache, the runner cache, ``OTService`` on
one trace (``log_factored`` and ``factored``), the traffic generator and
the open loop, and the ``ot_service`` driver's default and ``--stream``
lanes.

The same numpy inputs go through the JAX package (``JAX_PLATFORMS=cpu``)
and through the port with ``device="cpu"``, where every kernel runs its
plain PyTorch version; the CUDA kernels behind the service are held
against those versions on the card by chip_smoke.py (phases 2 and 10).
Tolerances: fingerprints, traffic arrays and cache counters equal; served
costs 1e-5 relative, potentials within 1e-5 of max |value| and |d n_iter|
<= 1, as ``tests/test_serving.py`` holds the JAX service against its
one-shot solver.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.core import api as japi
from repro.core import spec as jspec
from repro.serving import service as jservice
from repro.serving import traffic as jtraffic
from repro.serving import warmstart as jwarm
from repro.serving.runner_cache import RunnerCache as JRunnerCache
from repro_torch.configs import shapes
from repro_torch.core import BatchedSinkhorn, OTProblem, SolveSpec
from repro_torch.launch import ot_service
from repro_torch.serving import (
    OTService,
    RunnerCache,
    TrafficSpec,
    WarmStartCache,
    fingerprint,
    make_traffic,
    request_keys,
    run_open_loop,
    traffic_cells,
)

EPS = 0.6
REL = 1e-5
METHODS = ("log_factored", "factored")
# one trace over two bucket cells: (64, 64, 8) and (64, 128, 8)
TRACE = dict(n_requests=24, eps=EPS, r=8, size_classes=((40, 56), (33, 70)),
             pool_size=6, repeat_frac=0.6, near_frac=0.3, seed=4)


def _arrays(n, m, r=8, seed=0):
    rng = np.random.default_rng(seed)
    xi = np.asarray(rng.uniform(0.05, 1.05, (n, r)), np.float32)
    zeta = np.asarray(rng.uniform(0.05, 1.05, (m, r)), np.float32)
    a = np.asarray(rng.dirichlet(np.full(n, 2.0)), np.float32)
    b = np.asarray(rng.dirichlet(np.full(m, 2.0)), np.float32)
    return xi, zeta, a / a.sum(), b / b.sum()


def _problems(arrays, eps=EPS):
    return (japi.OTProblem.from_features(*arrays, eps=eps),
            OTProblem.from_features(*arrays, eps=eps, device="cpu"))


def _close(got, want, what):
    """One served result against the reference's: cost 1e-5 relative,
    potentials within 1e-5 of max |value|, |d n_iter| <= 1."""
    assert got.f.device.type == "cpu", what
    want_cost = float(want.cost)
    assert abs(float(got.cost) - want_cost) <= REL * abs(want_cost), what
    for got_x, w in ((got.f.numpy(), np.asarray(want.f)),
                     (got.g.numpy(), np.asarray(want.g))):
        assert got_x.shape == w.shape, what
        assert np.abs(got_x - w).max() <= REL * max(np.abs(w).max(), 1.0), \
            what
    assert abs(int(got.n_iter) - int(want.n_iter)) <= 1, what


# -- fingerprints and the warm-start cache ------------------------------------


def _fingerprint_case(case):
    rng = np.random.default_rng(7)
    x = np.asarray(rng.normal(size=(9, 5)), np.float32)
    y = np.asarray(rng.uniform(size=(6,)), np.float32)
    if case == "nonfinite":
        x[0, 1], x[2, 2], x[4, 0], x[5, 3] = np.nan, np.inf, -np.inf, 3e30
        y[1] = np.nan
    elif case == "log_dead":
        y[:2] = -np.inf                  # a log domain's dead atoms
    return x, y


@pytest.mark.parametrize("case", ["finite", "nonfinite", "log_dead"])
@pytest.mark.parametrize("quant", [1e-6, 1e-3])
def test_fingerprint_and_request_keys_bytes_match_reference(case, quant):
    x, y = _fingerprint_case(case)
    want = jwarm.fingerprint((x, y), quant=quant)
    assert fingerprint((x, y), quant=quant) == want
    # a tensor is quantised in torch (on its device) to the same bytes
    assert fingerprint((torch.as_tensor(x), torch.as_tensor(y)),
                       quant=quant) == want
    a = np.abs(y) + 0.1
    want_keys = jwarm.request_keys(x, x[:4], a, a[:3], quant=quant)
    assert request_keys(torch.as_tensor(x), torch.as_tensor(x[:4]), a,
                        torch.as_tensor(a[:3]), quant=quant) == want_keys
    # the shape is part of the identity
    assert fingerprint((x.reshape(5, 9), y), quant=quant) != want


def test_warmstart_cache_counters_match_reference():
    """One sequence of stores and lookups, poison on store and on lookup
    included, through both caches: every return value and counter equal."""
    caches = (jwarm.WarmStartCache(capacity=2), WarmStartCache(capacity=2))
    f, g = np.arange(4, dtype=np.float32), np.ones(3, np.float32)
    a, b = np.array([0.5, 0.5, 0.0, 0.0], np.float32), np.ones(3, np.float32)
    dead = np.array([1.0, 2.0, -np.inf, -np.inf], np.float32)
    ops = [
        ("store", b"s1", b"f1", f, g, None, None, True),
        ("lookup", b"s1", b"f1"),
        ("lookup", b"s1", b"other"),                 # near hit
        ("lookup", b"s2", b"f2"),                    # miss
        ("store", b"s2", b"f2", np.array([np.nan, 0, 0, 0], np.float32), g,
         None, None, True),                          # refused on store
        ("store", b"s2", b"f2", dead, g, a, b, True),   # sanitised dead atoms
        ("lookup", b"s2", b"f2"),
        ("store", b"s3", b"f3", np.full(4, np.nan, np.float32), g, None,
         None, False),                               # a corrupted snapshot
        ("lookup", b"s3", b"f3"),                    # evicted on lookup
        ("store", b"s4", b"f4", f, g, None, None, True),
        ("store", b"s5", b"f5", f, g, None, None, True),   # LRU eviction
        ("lookup", b"s2", b"f2"),
        ("lookup", b"s5", b"f5"),
    ]
    for op in ops:
        outs = []
        for cache in caches:
            if op[0] == "store":
                sk, fk, f_, g_, a_, b_, validate = op[1:]
                outs.append(cache.store(sk, fk, f_, g_, a_, b_,
                                        validate=validate))
            else:
                hit = cache.lookup(*op[1:])
                outs.append(None if hit is None else
                            (hit.exact, hit.f.tolist(), hit.g.tolist()))
        assert outs[0] == outs[1], op[:3]
        assert caches[0].snapshot() == caches[1].snapshot(), op[:3]
    assert caches[1].snapshot()["poisoned_evictions"] == 1
    assert caches[1].snapshot()["poisoned_rejects"] == 1


# -- the runner cache ---------------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 3, 4, 6, 16])
def test_runner_cache_batch_buckets_match_reference(max_batch):
    eng = BatchedSinkhorn(eps=EPS, method="log_factored")
    jeng = japi.BatchedSinkhorn(eps=EPS, method="log_factored")
    got = RunnerCache(eng, max_batch=max_batch, device="cpu").batch_buckets()
    assert got == JRunnerCache(jeng, max_batch=max_batch).batch_buckets()
    for b in range(1, 2 * max_batch + 1):
        assert shapes.ot_batch_bucket(b, max_batch) == \
            jshapes.ot_batch_bucket(b, max_batch)
        assert shapes.ot_batch_bucket(b, max_batch) in got


def test_runner_cache_hits_misses_evictions_match_reference():
    """The same gets through both caches (capacity 2): equal counters, no
    re-capture, and an evicted runner's graph and buffers freed."""
    eng = BatchedSinkhorn(eps=EPS, method="log_factored", tol=1e-6)
    jeng = japi.BatchedSinkhorn(eps=EPS, method="log_factored", tol=1e-6)
    cache = RunnerCache(eng, capacity=2, max_batch=4, device="cpu")
    jcache = JRunnerCache(jeng, capacity=2, max_batch=4)
    cells = [(64, 64, 8), (64, 128, 8)]
    gets = [(0, 3), (0, 4), (0, 1), (1, 2), (1, 1), (1, 2), (0, 1)]
    first = cache.get(shapes.OTBatchShape(*cells[0]), 1)
    jcache.get(jshapes.OTBatchShape(*cells[0]), 1)
    buf = weakref.ref(next(first.loops._runners[first.loops.keys()[0]]
                           .tensors()))
    for i, b in gets:
        cache.get(shapes.OTBatchShape(*cells[i]), b)
        jcache.get(jshapes.OTBatchShape(*cells[i]), b)
    snap, jsnap = cache.snapshot(), jcache.snapshot()
    for k in ("size", "capacity", "hits", "misses", "evictions",
              "extra_traces"):
        assert snap[k] == jsnap[k], k
    assert snap["extra_traces"] == 0 and snap["evictions"] == 3
    assert snap["hits"] == 3 and snap["misses"] == 5
    assert all(r.traces == 1 for r in cache.runners())
    # the first batch-1 runner was evicted (and built again): its loop is
    # gone
    assert first not in cache.runners()
    assert len(first.loops) == 0 and first.loops.nbytes == 0
    gc.collect()
    assert buf() is None
    # the engine's own cache holds none of the serving runners' loops
    assert eng.runners.captures == 0


# -- the service on one trace -------------------------------------------------


@pytest.fixture(scope="module", params=METHODS)
def services(request):
    """One reference and one port service of the same configuration, each
    warmed up on the trace's cells (shared by the tests below)."""
    method = request.param
    kw = dict(eps=EPS, method=method, tol=1e-6, max_batch=4, max_wait=0.001)
    jsvc = jservice.OTService(**kw)
    svc = OTService(device="cpu", **kw)
    jtrace = jtraffic.make_traffic(jtraffic.TrafficSpec(**TRACE))
    trace = make_traffic(TrafficSpec(**TRACE), device="cpu")
    jsvc.warmup(jtraffic.traffic_cells(jtrace, jsvc.engine))
    svc.warmup(traffic_cells(trace, svc.engine))
    return jsvc, svc, jtrace, trace


def _serve_in_chunks(svc, trace, chunk=3):
    tickets = []
    for k in range(0, len(trace), chunk):
        tickets += [svc.submit(req.problem) for req in trace[k:k + chunk]]
        svc.drain()
    return tickets


def test_service_matches_reference_on_a_trace(services):
    """The trace in chunks of 3 (a bucket of 4 padded by replicating a
    lane), warm starts on: each ticket's result, warm class and every
    counter of ``stats()`` as the reference's."""
    jsvc, svc, jtrace, trace = services
    j0, t0 = jsvc.stats(), svc.stats()
    jt = _serve_in_chunks(jsvc, jtrace)
    tt = _serve_in_chunks(svc, trace)
    for k, (want, got) in enumerate(zip(jt, tt)):
        assert got.done and got.refusal is None
        assert (got.warm_hit, got.warm_exact) == \
            (want.warm_hit, want.warm_exact), k
        _close(got.result, want.result, k)
        assert got.health.verdict == want.health.verdict == "ok"
    assert any(t.warm_exact for t in tt) and any(
        t.warm_hit and not t.warm_exact for t in tt)
    js, ts = jsvc.stats(), svc.stats()
    for k in ("served", "batches", "mean_batch", "shed", "health",
              "pending"):
        assert ts[k] == js[k], k
    for part in ("runner", "warm"):
        assert ts[part] == js[part], part
    assert ts["recovery"] == js["recovery"]
    for k in ("mean_iters_warm", "mean_iters_cold"):
        assert abs(ts[k] - js[k]) <= 1, k
    # no runner captured after warmup, and no new runner was built
    assert ts["runner"]["misses"] == t0["runner"]["misses"]
    assert ts["runner"]["extra_traces"] == 0
    assert set(ts["host_s"]) == {"kernel_data", "fingerprint", "pad_upload",
                                 "dispatch", "pull_unpad", "classify"}


def test_service_max_wait_holds_then_flushes(services):
    _, svc, _, _ = services
    fake = [100.0]
    real_clock = svc.clock
    svc.clock = lambda: fake[0]
    try:
        _, p = _problems(_arrays(40, 56, seed=30))
        t = svc.submit(p)
        assert svc.pump() == 0 and not t.done     # younger than max_wait
        fake[0] += 0.002                          # past max_wait (0.001)
        assert svc.pump() == 1 and t.done
        assert t.latency == pytest.approx(0.002)
    finally:
        svc.clock = real_clock


def test_service_refuses_a_wrong_eps_and_a_mismatched_spec(services):
    jsvc, svc, _, _ = services
    _, p = _problems(_arrays(40, 56, seed=31), eps=EPS / 2)
    with pytest.raises(ValueError, match="eps"):
        svc.submit(p)
    _, p = _problems(_arrays(40, 56, seed=31))
    spec = SolveSpec.from_problem(p, tol=1e-4, max_iter=10)
    with pytest.raises(ValueError, match="tol.*max_iter"):
        svc.submit(spec)
    jp, _ = _problems(_arrays(40, 56, seed=31))
    with pytest.raises(ValueError, match="tol.*max_iter"):
        jsvc.submit(jspec.SolveSpec.from_problem(jp, tol=1e-4, max_iter=10))
    # a matching spec is served like its problem
    ok = SolveSpec.from_problem(p, tol=1e-6)
    res = svc.solve_many([ok, p])
    assert float(res[0].cost) == float(res[1].cost)


@pytest.mark.parametrize("method", ["log_quadratic", "quadratic"])
def test_service_quadratic_methods_match_reference(method):
    """Dense costs: a megabatch of 3 ragged costs (rows and columns padded
    by replicating the last ones) padded to a bucket of 4."""
    rng = np.random.default_rng(3)
    pairs = []
    for n, m in ((20, 30), (25, 28), (18, 31)):
        x = np.asarray(rng.normal(size=(n, 2)), np.float32)
        y = np.asarray(rng.normal(size=(m, 2)), np.float32)
        C = ((x[:, None] - y[None]) ** 2).sum(-1).astype(np.float32)
        a, b = np.full(n, 1 / n, np.float32), np.full(m, 1 / m, np.float32)
        pairs.append((japi.OTProblem.from_cost(C, a, b, eps=EPS),
                      OTProblem.from_cost(C, a, b, eps=EPS, device="cpu")))
    kw = dict(eps=EPS, method=method, tol=1e-6, max_batch=4)
    want = jservice.OTService(**kw).solve_many([jp for jp, _ in pairs])
    got = OTService(device="cpu", **kw).solve_many([p for _, p in pairs])
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, k)


# -- traffic and the open loop ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_make_traffic_matches_reference(seed):
    kw = dict(TRACE, n_requests=40, seed=seed)
    want = jtraffic.make_traffic(jtraffic.TrafficSpec(**kw))
    got = make_traffic(TrafficSpec(**kw), device="cpu")
    assert [r.t_offset for r in got] == [r.t_offset for r in want]
    assert [r.kind for r in got] == [r.kind for r in want]
    for g, w in zip(got, want):
        for name in ("a", "b"):
            assert np.array_equal(getattr(g.problem, name).numpy(),
                                  np.asarray(getattr(w.problem, name)))
        for name in ("xi", "zeta"):
            assert np.array_equal(getattr(g.problem.geometry, name).numpy(),
                                  np.asarray(getattr(w.problem.geometry,
                                                     name)))
    assert {r.kind for r in got} == {"fresh", "repeat", "near"}


def test_run_open_loop_with_an_injected_clock_matches_reference():
    """Both services on one fake clock that moves only when the loop
    sleeps: the same completions, duration and latencies."""
    kw = dict(TRACE, n_requests=12, rate_hz=500.0)
    reports = []
    for mod, svc_cls, dev in ((jtraffic, jservice.OTService, {}),
                              (None, OTService, {"device": "cpu"})):
        now = [0.0]
        clock = lambda: now[0]

        def sleep(dt):
            now[0] += max(dt, 1e-4)

        svc = svc_cls(eps=EPS, method="log_factored", tol=1e-6, max_batch=2,
                      max_wait=0.003, clock=clock, **dev)
        if mod is None:
            trace = make_traffic(TrafficSpec(**kw), device="cpu")
            reports.append(run_open_loop(svc, trace, sleep=sleep))
        else:
            trace = mod.make_traffic(mod.TrafficSpec(**kw))
            reports.append(mod.run_open_loop(svc, trace, sleep=sleep))
    want, got = reports
    assert got.completed == want.completed == 12
    assert got.duration_s == pytest.approx(want.duration_s)
    np.testing.assert_allclose(got.latencies_s, want.latencies_s)
    assert got.p99_ms >= got.p50_ms > 0


# -- the driver ---------------------------------------------------------------


def test_ot_service_driver_default_lane_strict(capsys):
    rc = ot_service.main(["--device", "cpu", "--strict", "--requests", "24",
                          "--rank", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "served 24/24" in out and "post-warmup builds=0" in out


def test_ot_service_driver_stream_lane_strict(capsys):
    rc = ot_service.main(["--device", "cpu", "--strict", "--stream",
                          "--requests", "60"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "post-warmup captures=0" in out


def test_service_loops_live_in_its_own_runners():
    """A service's stacked solves capture into its runners, never into the
    engine's shared cache, so ``solve_many`` callers on the same engine
    cannot evict them."""
    svc = OTService(eps=EPS, method="log_factored", tol=1e-6, max_batch=2,
                    device="cpu")
    before = svc.engine.runners.captures
    svc.warmup([(40, 56, 8)])
    _, p = _problems(_arrays(40, 56, seed=40))
    svc.solve_many([p, p])
    assert svc.engine.runners.captures == before
    assert svc.runners.loop_stats()["captures"] == 2
