"""Synthetic serving traffic: heavy-tailed repeat requests, open-loop load.

Models many users without any external data:

* a POOL of distinct distribution pairs (each a positive-feature OT
  problem) across several ragged size classes, so requests land in several
  ``OTBatchShape`` buckets;
* requests sample the pool with repetition (``repeat_frac`` of requests
  re-serve a pair already seen) and ``near_frac`` of those re-jitter the
  weights only (same supports, slightly different marginals: the
  warm-start cache's near-repeat class);
* arrivals follow a fixed exponential (Poisson) schedule at ``rate_hz``,
  made ahead of time: OPEN loop, arrival times never depend on
  completions, so queueing delay shows in the latency percentiles instead
  of being absorbed by backpressure.

The trace is drawn in numpy with the JAX package's draws in its order, so
one seed gives the same offsets, kinds and problem arrays as the
reference; each pool problem is put on ``device`` (the card by default)
once, and a near repeat shares its pool entry's geometry. Counterpart of
``repro.serving.traffic``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.api import OTProblem
from ..kernels.backend import resolve_device

__all__ = ["TrafficSpec", "Request", "make_traffic", "run_open_loop",
           "TrafficReport", "traffic_cells"]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs for one synthetic trace (deterministic given ``seed``)."""

    n_requests: int = 200
    rate_hz: float = 200.0
    eps: float = 0.5
    r: int = 16
    size_classes: Tuple[Tuple[int, int], ...] = ((40, 56), (90, 70),
                                                 (150, 120))
    pool_size: int = 32
    repeat_frac: float = 0.6
    near_frac: float = 0.3       # fraction of repeats with re-jittered weights
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One scheduled arrival: offset seconds from the trace's start and a
    problem."""

    t_offset: float
    problem: OTProblem
    kind: str                    # "fresh" | "repeat" | "near"


def _pool_arrays(rng: np.random.Generator, n: int, m: int, r: int):
    xi = np.asarray(rng.uniform(0.05, 1.05, (n, r)), np.float32)
    zeta = np.asarray(rng.uniform(0.05, 1.05, (m, r)), np.float32)
    a = np.asarray(rng.dirichlet(np.full(n, 2.0)), np.float32)
    b = np.asarray(rng.dirichlet(np.full(m, 2.0)), np.float32)
    return xi, zeta, a / a.sum(), b / b.sum()


def make_traffic(spec: TrafficSpec, *, device=None) -> List[Request]:
    """The request trace of ``spec``, sorted by arrival, its problems on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    pool: List[OTProblem] = []
    for i in range(spec.pool_size):
        n, m = spec.size_classes[i % len(spec.size_classes)]
        # ragged within the class: sizes vary but stay inside one bucket
        n = int(rng.integers(max(2, n - n // 8), n + 1))
        m = int(rng.integers(max(2, m - m // 8), m + 1))
        xi, zeta, a, b = _pool_arrays(rng, n, m, spec.r)
        pool.append(OTProblem.from_features(xi, zeta, a, b, eps=spec.eps,
                                            device=dev))
    gaps = rng.exponential(1.0 / spec.rate_hz, spec.n_requests)
    arrivals = np.cumsum(gaps)
    # Zipf-like popularity over the pool: low indices dominate, as reuse
    # does in heavy-tailed production traffic
    ranks = np.arange(1, spec.pool_size + 1, dtype=np.float64)
    popularity = (1.0 / ranks) / (1.0 / ranks).sum()
    out: List[Request] = []
    seen: set = set()
    for t in arrivals:
        idx = int(rng.choice(spec.pool_size, p=popularity))
        base = pool[idx]
        if idx in seen and rng.random() < spec.repeat_frac:
            if rng.random() < spec.near_frac:
                # near repeat: identical supports, re-jittered weights
                a0, b0 = base.a.cpu().numpy(), base.b.cpu().numpy()
                a = a0 * np.asarray(rng.uniform(0.9, 1.1, a0.shape[0]),
                                    np.float32)
                b = b0 * np.asarray(rng.uniform(0.9, 1.1, b0.shape[0]),
                                    np.float32)
                a, b = a / a.sum(), b / b.sum()
                p = OTProblem.from_geometry(base.geometry, a, b, device=dev)
                out.append(Request(float(t), p, "near"))
            else:
                out.append(Request(float(t), base, "repeat"))
        else:
            seen.add(idx)
            out.append(Request(float(t), base, "fresh"))
    return out


@dataclasses.dataclass
class TrafficReport:
    """Measured open-loop serving outcome."""

    completed: int
    duration_s: float
    latencies_s: np.ndarray      # per request, scheduled arrival -> done

    @property
    def rps(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    def percentile_ms(self, q: float) -> float:
        if len(self.latencies_s) == 0:
            return float("nan")
        return float(np.percentile(self.latencies_s, q) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)


def run_open_loop(
    service,
    traffic: Sequence[Request],
    *,
    clock: Optional[Callable[[], float]] = None,
    sleep: Callable[[float], None] = time.sleep,
    poll_s: float = 0.0002,
) -> TrafficReport:
    """Drive ``service`` with the pre-scheduled ``traffic`` trace.

    Submissions happen at their scheduled offsets on ``clock`` (open
    loop); between arrivals the loop pumps due megabatches and otherwise
    sleeps until the next arrival or admission deadline. Returns the
    latency and throughput report (latency from each request's scheduled
    arrival, so queueing delay counts)."""
    clock = service.clock if clock is None else clock
    tickets = []
    start = clock()
    for req in traffic:
        target = start + req.t_offset
        while True:
            now = clock()
            if now >= target:
                break
            service.pump(now)
            deadline = service.next_deadline()
            wait = target - now
            if deadline is not None:
                wait = min(wait, max(deadline - now, 0.0))
            sleep(min(wait, poll_s) if wait > 0 else 0.0)
        # enqueue at the real clock time (max-wait aging must see true
        # arrivals, or a loop that slipped past the schedule would flush
        # every group at once as batches of one) ...
        t = service.submit(req.problem)
        # ... but measure latency from the scheduled arrival: a submission
        # that slipped because the loop was busy still pays its lateness
        t.t_submit = target
        tickets.append(t)
        service.pump()
    service.drain()
    end = clock()
    lat = np.asarray([t.latency for t in tickets if t.done], np.float64)
    return TrafficReport(
        completed=sum(t.done for t in tickets),
        duration_s=end - start,
        latencies_s=lat,
    )


def traffic_cells(traffic: Sequence[Request], engine) -> List:
    """The bucket cells a trace will hit (for ``OTService.warmup``)."""
    shapes = []
    seen = set()
    for req in traffic:
        ka, kb = engine.kernel_data(req.problem)
        shape = engine.batch_shape(ka, kb)
        if shape not in seen:
            seen.add(shape)
            shapes.append(shape)
    return shapes
