"""OT-as-a-service driver: serve a synthetic open-loop trace and report.

    PYTHONPATH=src python -m repro_torch.launch.ot_service --requests 200 \
        --rate 150 --max-batch 4 --max-wait-ms 4 [--device cpu]

Builds a heavy-tailed request trace (:mod:`repro_torch.serving.traffic`),
pre-plans runners for every bucket cell the trace hits, then serves the
trace open-loop and prints throughput/latency percentiles plus the
serving-path cache counters. ``--no-warm-starts`` A/Bs the potential
re-serving; ``--strict`` exits nonzero if any runner captured its loop
after warmup (the zero-recapture serving invariant). ``--device`` picks
the device (the card by default; ``cpu`` runs the kernels' plain
versions).

``--stream`` switches to the STREAMING service instead: a pool of
mutable pairs (paged feature stores) receives a synthetic stream of
insert/evict mutations coalesced through the admission queue
(:class:`repro_torch.serving.StreamingOTService`), one warm re-solve per
pair per flush. ``--strict`` then gates zero post-warmup runner captures
across every mutation.

``--chaos`` runs the RESILIENCE lane: a seeded fault campaign
(:class:`repro_torch.resilience.ChaosInjector`) mixes NaN/inf feature rows,
NaN weights, an adversarially small eps (Gaussian features underflow ->
the scaling path diverges; the log rung recovers), injected runner
exceptions, a poisoned warm cache and a skewed clock into the traffic,
with the recovery ladder + quarantine enabled. ``--strict`` then gates:
every request terminates in a finite result or a STRUCTURED refusal (no
NaN cost is ever returned), zero post-warmup captures across the main
AND rung runner caches, zero unhandled exceptions, and as many runner
faults absorbed as the injector made. A fault of the kernels or the CUDA
runtime (``kernels.build.device_fault``) is never counted and carried on
from: it propagates and ends the run. Counterpart of
``repro.launch.ot_service``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..kernels.backend import resolve_device
from ..kernels.build import device_fault
from ..serving import (
    OTService,
    TrafficSpec,
    make_traffic,
    run_open_loop,
    traffic_cells,
)


def run_stream(args) -> int:
    """Synthetic mutation traffic through the streaming service."""
    from ..serving import StreamingOTService
    from ..streaming import StreamingDistribution, StreamingSolver

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    r, n, eps = args.rank, args.stream_n, args.eps
    n_pairs = max(1, min(args.pool, 8))
    svc = StreamingOTService(
        solver=StreamingSolver(method="scaling", tol=args.tol,
                               use_pallas=False),
        max_batch=args.max_batch, max_wait=args.max_wait_ms * 1e-3,
    )

    def positive_feats(k):
        return (np.abs(rng.normal(size=(k, r))) + 0.05).astype(np.float32)

    t0 = time.monotonic()
    for p in range(n_pairs):
        dx = StreamingDistribution.from_features(
            [(p, "x", i) for i in range(n)], positive_feats(n),
            np.ones(n, np.float32), eps=eps, device=dev)
        dy = StreamingDistribution.from_features(
            [(p, "y", i) for i in range(n)], positive_feats(n),
            np.ones(n, np.float32), eps=eps, device=dev)
        svc.register(f"pair{p}", dx, dy)
        svc.solver.re_solve(svc.solver.pair(f"pair{p}"))
    traces0 = svc.solver.traces
    print(f"[ot-service] stream warmup: {n_pairs} pairs at n={n} r={r} "
          f"({svc.solver.stats()['runners']} runners, "
          f"{traces0} traces) in {time.monotonic() - t0:.1f}s")

    k = max(1, n // 50)                 # <= 2% of the support per update
    tickets = []
    # ids already scheduled for removal in a not-yet-flushed mutation:
    # coalesced batches apply every removal, so sampling must avoid them
    pending_rm = {p: set() for p in range(n_pairs)}
    t0 = time.monotonic()
    for j in range(args.requests):
        p = int(rng.integers(n_pairs))
        pair = svc.solver.pair(f"pair{p}")
        live = [i for i in pair.x.store.ids() if i not in pending_rm[p]]
        rm = [live[int(i)] for i in
              rng.choice(len(live), size=k, replace=False)]
        pending_rm[p].update(rm)
        tickets.append(svc.submit_update(
            f"pair{p}", remove_x=rm,
            add_x=dict(ids=[(p, "new", j, i) for i in range(k)],
                       feats=positive_feats(k),
                       weights=np.ones(k, np.float32))))
        svc.pump()
    svc.drain()
    dt = time.monotonic() - t0
    lat = sorted(t.latency for t in tickets)
    stats = svc.stats()
    retraces = svc.solver.traces - traces0
    print(f"[ot-service] streamed {len(tickets)} mutations over "
          f"{n_pairs} pairs in {dt:.2f}s ({len(tickets) / dt:.1f} "
          f"updates/s, delta_n={k}/{n} per update)")
    print(f"[ot-service] latency p50={lat[len(lat) // 2] * 1e3:.2f}ms "
          f"p99={lat[int(len(lat) * 0.99)] * 1e3:.2f}ms")
    print(f"[ot-service] coalescing: {stats['solves']} warm re-solves "
          f"for {stats['dispatched']} mutations "
          f"(ratio {stats['coalesce_ratio']:.2f}); "
          f"post-warmup captures={retraces}")
    if args.strict and retraces:
        print("[ot-service] STRICT FAILURE: streaming runner captured "
              "after warmup", file=sys.stderr)
        return 1
    return 0


def _unhandled(exc: Exception) -> int:
    """Count an exception the service let through (1), unless it is a
    fault of the kernels or the CUDA runtime: that one is re-raised."""
    if device_fault(exc):
        raise exc
    return 1


def run_chaos(args) -> int:
    """Chaos-tested serving: seeded fault campaign through the recovery
    ladder, with the no-NaN / no-recapture / no-unhandled-exception gates."""
    from collections import Counter

    from ..core.api import OTProblem, solve
    from ..resilience import ChaosInjector, ChaosSpec, RecoveryPolicy
    from ..serving import QuarantineError, QueueFullError

    dev = resolve_device(args.device)
    eps = args.chaos_eps
    r = args.rank
    rng = np.random.default_rng(args.seed)
    inj = ChaosInjector(ChaosSpec(
        seed=args.seed, nan_feature_frac=0.15, inf_feature_frac=0.10,
        nan_weight_frac=0.10, runner_fault_frac=0.08, clock_skew_s=0.005))

    # -- fault-assigned problem pool ----------------------------------------
    # healthy slots alternate between two classes: "gauss" (Gaussian
    # features at an adversarially small eps — exp(-d^2/eps) underflows,
    # the scaling path diverges, the LOG rung recovers a finite result)
    # and "benign" (explicit positive features — converges as-is)
    pool_n = args.pool
    size_classes = ((24, 20), (40, 32))
    kinds = inj.assign_faults(pool_n)
    problems, classes = [], []
    healthy_seen = 0
    for i, kind in enumerate(kinds):
        n, m = size_classes[i % len(size_classes)]
        xi = np.asarray(rng.uniform(0.05, 1.05, (n, r)), np.float32)
        zeta = np.asarray(rng.uniform(0.05, 1.05, (m, r)), np.float32)
        a = np.full(n, 1.0 / n, np.float32)
        b = np.full(m, 1.0 / m, np.float32)
        if kind == "":
            if healthy_seen % 2 == 0:
                x = np.asarray(rng.normal(size=(n, 2)), np.float32)
                y = np.asarray(rng.normal(size=(m, 2)), np.float32)
                anchors = np.asarray(rng.normal(size=(r, 2)), np.float32)
                problems.append(OTProblem.from_point_clouds(
                    x, y, anchors, a, b, eps=eps, device=dev))
                classes.append("gauss_small_eps")
            else:
                problems.append(OTProblem.from_features(
                    xi, zeta, a, b, eps=eps, device=dev))
                classes.append("benign")
            healthy_seen += 1
        elif kind == "nan_weight":
            problems.append(OTProblem.from_features(
                xi, zeta, inj.corrupt_weights(a), b, eps=eps, device=dev))
            classes.append(kind)
        else:
            problems.append(OTProblem.from_features(
                inj.corrupt_features(xi, kind), zeta, a, b, eps=eps,
                device=dev))
            classes.append(kind)

    svc = OTService(
        eps=eps, method="factored", tol=args.tol, max_iter=300,
        max_batch=args.max_batch, max_wait=args.max_wait_ms * 1e-3,
        recovery=RecoveryPolicy(), quarantine_after=2,
        max_depth=16, chaos_hook=inj.fault_hook(),
        clock=inj.skewed(time.monotonic), device=dev,
    )

    cells, seen = [], set()
    for p in problems:
        ka, kb = svc.engine.kernel_data(p)
        shape = svc.engine.batch_shape(ka, kb)
        if shape not in seen:
            seen.add(shape)
            cells.append(shape)
    t0 = time.monotonic()
    built_main = svc.warmup(cells)
    built_rungs = svc.warmup_recovery(cells)
    print(f"[ot-chaos] warmup: {built_main} main + {built_rungs} rung "
          f"runners over {len(cells)} cells in {time.monotonic() - t0:.1f}s")

    # fp32 log-domain ground truth for the healthy classes, under the
    # SAME iteration budget as the service: parity then measures whether
    # a recovered result IS the log-domain answer (not an iteration-count
    # artifact)
    ref_cost = {}
    for i, cls in enumerate(classes):
        if cls in ("gauss_small_eps", "benign"):
            res = solve(problems[i], method="log_factored", tol=args.tol,
                        max_iter=300)
            ref_cost[i] = float(res.cost)

    # -- drive: round-robin closed loop with fault handling -----------------
    outcomes = Counter()
    tickets = []
    unhandled = 0
    poisoned = False
    t0 = time.monotonic()
    for j in range(args.requests):
        i = j % pool_n
        if not poisoned and j == pool_n and ref_cost:
            # one full round served: corrupt a healthy pair's warm-cache
            # entry under its REAL fingerprint (bypassing put-validation)
            # — its next repeat must evict on get and cold-solve
            i0 = next(iter(ref_cost))
            ka, kb = svc.engine.kernel_data(problems[i0])
            sk, fk = svc.warm.keys_for(ka, kb, problems[i0].a,
                                       problems[i0].b)
            inj.poison_warm_cache(svc.warm, sk, fk,
                                  problems[i0].a.shape[0],
                                  problems[i0].b.shape[0])
            poisoned = True
        try:
            tickets.append((i, svc.submit(problems[i])))
        except QuarantineError:
            outcomes["quarantined_submit"] += 1
            continue
        except QueueFullError:
            outcomes["shed_submit"] += 1
            continue
        except Exception as exc:
            unhandled += _unhandled(exc)
            continue
        try:
            svc.pump()
        except Exception as exc:
            unhandled += _unhandled(exc)
    try:
        svc.drain()
    except Exception as exc:
        unhandled += _unhandled(exc)
    dt = time.monotonic() - t0

    # -- shed burst: overflow the bounded queue without pumping -------------
    benign = [i for i, c in enumerate(classes) if c == "benign"]
    if benign:
        for _ in range(20):
            try:
                tickets.append((benign[0], svc.submit(problems[benign[0]])))
            except QueueFullError:
                outcomes["shed_submit"] += 1
            except QuarantineError:
                outcomes["quarantined_submit"] += 1
        try:
            svc.drain()
        except Exception as exc:
            unhandled += _unhandled(exc)

    # -- verdicts, parity, gates --------------------------------------------
    nonterminal = sum(not t.done for _, t in tickets)
    nan_served = 0
    parity = 0.0
    per_class = {}
    for i, t in tickets:
        cls = classes[i]
        hist = per_class.setdefault(cls, Counter())
        if t.refusal is not None:
            hist["refused:" + t.refusal.reason] += 1
        elif t.result is not None:
            v = t.health.verdict if t.health is not None else "?"
            hist[("recovered:" + "+".join(t.rungs)) if t.rungs else v] += 1
            c = float(t.result.cost)
            if not np.isfinite(c):
                nan_served += 1
            elif i in ref_cost:
                parity = max(parity,
                             abs(c - ref_cost[i]) / max(1.0, abs(ref_cost[i])))
    stats = svc.stats()
    rec, runner, warm = stats["recovery"], stats["runner"], stats["warm"]
    post_main = runner["misses"] - built_main
    post_rung = rec["rung_compiles"] - built_rungs

    print(f"[ot-chaos] drove {len(tickets)} admitted requests over "
          f"{pool_n} pool entries in {dt:.2f}s; injected: {inj.stats()}")
    print(f"[ot-chaos] fault mix -> outcomes:")
    for cls in sorted(per_class):
        print(f"[ot-chaos]   {cls:16s} {dict(per_class[cls])}")
    print(f"[ot-chaos] submit refusals: {dict(outcomes)}")
    print(f"[ot-chaos] recovery: attempts={rec['attempts']} "
          f"recovered={rec['recovered']} refused={rec['refused']} "
          f"runner_faults={rec['runner_faults']} "
          f"(injected {inj.runner_faults}) "
          f"rung_hist={rec['rung_hist']} "
          f"quarantined={rec['quarantined']} shed={stats['shed']}")
    print(f"[ot-chaos] warm cache: poisoned_rejects="
          f"{warm['poisoned_rejects']} poisoned_evictions="
          f"{warm['poisoned_evictions']}")
    print(f"[ot-chaos] parity: recovered/served healthy results within "
          f"{parity:.2e} (rel) of fp32 log-domain ground truth")
    print(f"[ot-chaos] captures after warmup: main={post_main} "
          f"rung={post_rung} extra_traces="
          f"{runner['extra_traces'] + rec['rung_extra_traces']}; "
          f"unhandled exceptions={unhandled}; "
          f"non-terminal tickets={nonterminal}; "
          f"NaN results served={nan_served}")

    failures = []
    if nonterminal:
        failures.append(f"{nonterminal} tickets not terminal")
    if nan_served:
        failures.append(f"{nan_served} NaN-cost results served")
    if unhandled:
        failures.append(f"{unhandled} unhandled exceptions")
    if rec["recovered"] == 0:
        failures.append("recovery ladder never rescued a request")
    if rec["refused"] == 0:
        failures.append("no structured refusals (faults not exercised)")
    if warm["poisoned_evictions"] == 0:
        failures.append("poisoned warm entry was not evicted on get")
    if stats["shed"] == 0:
        failures.append("queue depth bound never shed")
    if post_main or post_rung or runner["extra_traces"] \
            or rec["rung_extra_traces"]:
        failures.append(
            f"post-warmup captures (main={post_main} rung={post_rung})")
    if rec["runner_faults"] != inj.runner_faults:
        failures.append(
            f"{rec['runner_faults']} runner faults absorbed, "
            f"{inj.runner_faults} injected")
    if parity > 1e-3:
        failures.append(f"parity {parity:.2e} vs ground truth")
    if args.strict and failures:
        print("[ot-chaos] STRICT FAILURE: " + "; ".join(failures),
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=150.0,
                    help="open-loop arrival rate (requests/second)")
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--pool", type=int, default=32,
                    help="distinct distribution pairs in the traffic pool")
    ap.add_argument("--repeat-frac", type=float, default=0.6)
    ap.add_argument("--near-frac", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="log_factored")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--no-warm-starts", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any post-warmup capture (and, with "
                    "--chaos, on any of its gates)")
    ap.add_argument("--stream", action="store_true",
                    help="serve synthetic MUTATION traffic through the "
                         "streaming service (paged stores + incremental "
                         "re-solve) instead of the request-trace service")
    ap.add_argument("--stream-n", type=int, default=400,
                    help="--stream: live support size per distribution")
    ap.add_argument("--chaos", action="store_true",
                    help="run the resilience lane: seeded fault injection "
                         "through the recovery ladder (see module doc)")
    ap.add_argument("--chaos-eps", type=float, default=1e-4,
                    help="--chaos: the adversarially small eps the "
                         "Gaussian-feature class underflows at")
    ap.add_argument("--device", default=None,
                    help="where to serve: the card by default, 'cpu' for "
                    "the kernels' plain versions")
    args = ap.parse_args(argv)

    if args.chaos:
        return run_chaos(args)
    if args.stream:
        return run_stream(args)

    spec = TrafficSpec(
        n_requests=args.requests, rate_hz=args.rate, eps=args.eps,
        r=args.rank, pool_size=args.pool, repeat_frac=args.repeat_frac,
        near_frac=args.near_frac, seed=args.seed,
    )
    traffic = make_traffic(spec, device=args.device)
    svc = OTService(
        eps=spec.eps, method=args.method, tol=args.tol,
        max_batch=args.max_batch, max_wait=args.max_wait_ms * 1e-3,
        warm_starts=not args.no_warm_starts, device=args.device,
    )
    cells = traffic_cells(traffic, svc.engine)
    t0 = time.monotonic()
    built = svc.warmup(cells)
    print(f"[ot-service] warmup: {built} runners over {len(cells)} bucket "
          f"cells in {time.monotonic() - t0:.1f}s")

    report = run_open_loop(svc, traffic)
    stats = svc.stats()
    runner, warm = stats["runner"], stats["warm"]
    print(f"[ot-service] served {report.completed}/{len(traffic)} requests "
          f"in {report.duration_s:.2f}s ({report.rps:.1f} req/s)")
    print(f"[ot-service] latency p50={report.p50_ms:.2f}ms "
          f"p99={report.p99_ms:.2f}ms "
          f"(from scheduled arrival, queueing included)")
    print(f"[ot-service] batches={stats['batches']} "
          f"mean_batch={stats['mean_batch']:.2f}")
    print(f"[ot-service] warm-start: hit_rate={warm['hit_rate']:.3f} "
          f"(exact={warm['exact_hits']} near={warm['near_hits']} "
          f"miss={warm['misses']}); mean iters "
          f"warm={stats['mean_iters_warm']:.2f} "
          f"cold={stats['mean_iters_cold']:.2f}")
    post_warmup_builds = runner["misses"] - built
    print(f"[ot-service] runners: size={runner['size']} "
          f"steady-state hits={runner['hits']} "
          f"post-warmup builds={post_warmup_builds} "
          f"extra_traces={runner['extra_traces']}")
    if args.strict and (post_warmup_builds or runner["extra_traces"]):
        print("[ot-service] STRICT FAILURE: serving path captured after "
              "warmup", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
