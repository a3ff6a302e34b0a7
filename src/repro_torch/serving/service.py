"""OT as a service: a persistent, request-driven front end for the batched
engine.

The pieces, each its own module:

* :class:`~repro_torch.serving.runner_cache.RunnerCache`: pre-captured,
  warmed-up solve loops per ``(OTBatchShape, B)`` bucket cell, so
  steady-state requests never capture.
* :class:`~repro_torch.serving.admission.AdmissionQueue`: continuous
  batching of ragged requests into bucket-padded megabatches under a
  max-batch / max-wait policy.
* :class:`~repro_torch.serving.warmstart.WarmStartCache`: fingerprinted
  potentials handed back to the engine for repeat (exact) and near-repeat
  pairs.

Usage::

    svc = OTService(eps=0.05, method="log_factored", max_batch=8,
                    max_wait=0.002)          # device="cpu" without a card
    svc.warmup([(200, 150, 64)])          # pre-plan the expected buckets
    t = svc.submit(problem)               # -> Ticket
    svc.pump()                            # dispatch due megabatches
    svc.drain()                           # flush everything pending
    t.result                              # the request's unpadded result

``submit`` / ``pump`` / ``drain`` are synchronous and single-threaded: the
event loop (a driver, an RPC handler, the open-loop benchmark) owns
scheduling, the service owns batching and caching. Time is injected
(``clock=``), so tests drive the max-wait policy with a fake clock.

Where the data lives. The JAX package keeps the dispatch glue in host
numpy, because every jnp slice on a new shape compiles an XLA executable.
PyTorch compiles nothing, so here a request's kernel data stays where
``kernel_data`` made it, on the problem's device (the service's, as a
rule), and a megabatch is padded on the service's device, straight into
its stacked tensors. The host holds what host code reads: the weights
(one read a request, for validation and classification), the fingerprint
(its int64 grid, quantised on the device; one read a request) and the
warm potentials, which go up once a megabatch as one (B, n + m) copy. A
megabatch's results come down in one read, and each ticket's
:class:`SinkhornResult` is a slice of CPU tensors. ``host_s`` in
:meth:`OTService.stats` splits the host's seconds over those steps.

Faults. With ``recovery`` set, any exception a runner or the chaos hook
raises is absorbed and the requests retried down the ladder, as the JAX
package absorbs them, except a fault of the kernels or the CUDA runtime
(``kernels.build.device_fault``: a kernel that does not build or launch, a
failed capture): that is re-raised, so no request is ever served by the
plain operators in its place. Counterpart of ``repro.serving.service``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, OrderedDict
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..configs.shapes import OTBatchShape, ot_batch_bucket
from ..core.api import (
    BatchedSinkhorn,
    OTProblem,
    engine_cache_info,
    get_engine,
)
from ..core.sinkhorn import SinkhornResult
from ..kernels.backend import resolve_device
from ..kernels.build import device_fault
from ..resilience.health import SolveHealth, classify
from ..resilience.ladder import CONFIG_RUNGS, _LadderState, degrade
from ..resilience.policy import RecoveryPolicy
from .admission import AdmissionQueue, QueueFullError
from .runner_cache import RunnerCache
from .warmstart import WarmStartCache

__all__ = ["Ticket", "OTService", "Refusal", "QuarantineError",
           "QueueFullError", "HOST_SPLIT"]

# the host steps of a request, in order: its kernel data (and the read of
# its weights), its fingerprint, the megabatch's padding and upload, the
# dispatch (the solve loop, ending in its last host read), the read of the
# results and their unpadding, and the per-lane verdicts
HOST_SPLIT = ("kernel_data", "fingerprint", "pad_upload", "dispatch",
              "pull_unpad", "classify")

class QuarantineError(RuntimeError):
    """Submit-time refusal of a quarantined repeat offender: a request
    fingerprint that has exhausted the recovery ladder
    ``quarantine_after`` times (admitting it again would burn a full
    ladder of solves on a known-unsolvable input)."""


@dataclasses.dataclass(frozen=True)
class Refusal:
    """Structured terminal refusal on a :class:`Ticket` whose request could
    not be recovered: the caller gets a reason and the last attempt's
    health instead of a NaN cost."""

    reason: str                      # "recovery_exhausted" | "runner_fault"
    detail: str
    health: Optional[SolveHealth]    # last attempt's verdict (if any ran)


class Ticket:
    """Handle for one submitted request, filled in by the dispatch path.

    A ticket terminates in exactly one of two states: ``result`` (a
    finite or classified solve; ``health`` has the verdict) or ``refusal``
    (the no-NaN contract once the recovery ladder is exhausted).
    ``attempts`` / ``rungs`` record the recovery work the request took."""

    __slots__ = ("seq", "t_submit", "t_done", "result", "warm_hit",
                 "warm_exact", "health", "refusal", "attempts", "rungs")

    def __init__(self, seq: int, t_submit: float):
        self.seq = seq
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self.result: Optional[SinkhornResult] = None
        self.warm_hit = False
        self.warm_exact = False
        self.health: Optional[SolveHealth] = None
        self.refusal: Optional[Refusal] = None
        self.attempts = 1            # solve attempts consumed (>= 1 once run)
        self.rungs: Tuple[str, ...] = ()

    @property
    def done(self) -> bool:
        return self.result is not None or self.refusal is not None

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise RuntimeError("request not served yet")
        return self.t_done - self.t_submit


@dataclasses.dataclass
class _Admitted:
    """One admitted request: its kernel data and weights on the service's
    device, the weights on the host, its keys, its warm start and its
    ticket."""

    ticket: Ticket
    ka: torch.Tensor
    kb: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    a_host: np.ndarray
    b_host: np.ndarray
    support_key: bytes
    full_key: bytes
    f0: Optional[np.ndarray]      # warm potentials (unpadded) or None
    g0: Optional[np.ndarray]
    problem: Optional[OTProblem] = None   # kept only when recovery may need
    # to derive the kernel data again under another method or eps

    @property
    def n(self) -> int:
        return self.a_host.shape[0]

    @property
    def m(self) -> int:
        return self.b_host.shape[0]


class OTService:
    """Persistent OT solver service over the batched engine.

    The solver knobs are :class:`~repro_torch.core.api.BatchedSinkhorn`'s
    (one service a solver configuration; the engine comes from the
    bounded :func:`~repro_torch.core.api.get_engine` LRU, so the service
    and ``solve_many`` callers share it and its accounting, while the
    service's loops live in its own runners). ``device`` is where the
    service solves: the card by default (raising without one), ``"cpu"``
    for the plain versions of the kernels. Serving knobs:

    ``max_batch`` / ``max_wait``
        the admission policy (:class:`AdmissionQueue`). A megabatch is
        padded up to its power-of-two batch bucket (``ot_batch_bucket``)
        by replicating a real lane, whose duplicates are discarded, so a
        support cell holds O(log max_batch) runners.
    ``runner_capacity``
        LRU cap on live runners.
    ``warm_capacity`` / ``warm_quant`` / ``warm_starts``
        warm-start cache size, fingerprint quantisation, and a switch (off:
        every request starts cold; the benchmark's A/B knob).
    ``clock``
        time source (injectable for tests; ``time.monotonic``).

    Resilience knobs (all off by default):

    ``recovery``
        a :class:`~repro_torch.resilience.policy.RecoveryPolicy`. Every
        dispatched lane is then classified, and a failed request climbs
        the ladder through pre-captured batch-1 rung runners (one small
        ``RunnerCache`` a cumulative rung configuration; call
        :meth:`warmup_recovery` beside :meth:`warmup` to capture them
        ahead of traffic). A request that exhausts the ladder gets a
        structured ``Refusal``, never a NaN cost.
    ``max_depth``
        admission depth bound; ``submit`` raises :class:`QueueFullError`
        (load shedding) past it.
    ``quarantine_after``
        fingerprints that exhaust the ladder this many times are
        quarantined: later submits raise :class:`QuarantineError`.
    ``chaos_hook``
        ``hook(shape, batch)``, called before every main-path dispatch:
        the fault-injection seam
        (:meth:`repro_torch.resilience.chaos.ChaosInjector.fault_hook`).
        What it raises is handled as a runner fault.
    """

    def __init__(
        self,
        *,
        eps: float,
        method: str = "log_factored",
        tol: float = 1e-6,
        max_iter: int = 2000,
        momentum: float = 1.0,
        use_pallas: Optional[bool] = None,
        inner_steps: Optional[int] = None,
        check_every: Optional[int] = None,
        precision: str = "highest",
        max_batch: int = 8,
        max_wait: float = 0.005,
        runner_capacity: int = 32,
        warm_capacity: int = 1024,
        warm_quant: float = 1e-6,
        warm_starts: bool = True,
        clock: Callable[[], float] = time.monotonic,
        recovery: Optional[RecoveryPolicy] = None,
        max_depth: Optional[int] = None,
        quarantine_after: int = 3,
        quarantine_capacity: int = 1024,
        chaos_hook: Optional[Callable[[OTBatchShape, int], None]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.engine = get_engine(
            eps=eps, method=method, tol=tol, max_iter=max_iter,
            momentum=momentum, use_pallas=use_pallas,
            inner_steps=inner_steps, check_every=check_every,
            precision=precision,
        )
        self.clock = clock
        self.max_batch = max_batch
        self.runners = RunnerCache(self.engine, capacity=runner_capacity,
                                   max_batch=max_batch, device=self.device)
        self.queue: AdmissionQueue[_Admitted] = AdmissionQueue(
            max_batch=max_batch, max_wait=max_wait, max_depth=max_depth)
        self.warm = WarmStartCache(capacity=warm_capacity, quant=warm_quant)
        self.warm_starts = warm_starts
        # -- resilience state ------------------------------------------------
        if recovery is not None and not isinstance(recovery, RecoveryPolicy):
            raise TypeError(
                f"recovery must be a RecoveryPolicy, got {type(recovery)}")
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        self.recovery = recovery
        self.quarantine_after = quarantine_after
        self.quarantine_capacity = quarantine_capacity
        self.chaos_hook = chaos_hook
        # full_key -> ladder exhaustions (bounded LRU)
        self._quarantine: "OrderedDict[bytes, int]" = OrderedDict()
        # cumulative rung configuration -> batch-1 RunnerCache (its engine
        # built directly, not through get_engine: recovery traffic must
        # not churn the engine LRU the happy path lives in)
        self._rung_caches: Dict[Tuple, RunnerCache] = {}
        # served-request accounting (stats() and the benchmark)
        self.served = 0
        self.batches = 0
        self.iters_warm = 0          # total solver iterations, warm-hit reqs
        self.iters_cold = 0
        self.served_warm = 0
        self.served_cold = 0
        self.host_s = dict.fromkeys(HOST_SPLIT, 0.0)
        # resilience accounting
        self.recovered = 0           # failed requests the ladder rescued
        self.refused = 0             # ladder exhausted -> structured Refusal
        self.runner_faults = 0       # runner/chaos exceptions absorbed
        self.quarantine_rejects = 0  # submits refused at quarantine
        self.recovery_attempts = 0   # total extra solves the ladder ran
        self.rung_hist: Counter = Counter()    # winning rung -> count
        self.health_hist: Counter = Counter()  # first-attempt verdicts

    # -- request path --------------------------------------------------------

    def _tick(self, step: str, t0: float) -> float:
        t = time.perf_counter()
        self.host_s[step] += t - t0
        return t

    def _check_spec(self, spec) -> OTProblem:
        """A spec's problem, its solver-facing fields checked against the
        engine: a spec asking for another eps / tol / max_iter / momentum,
        or a schedule, is an error, not a silent reconfiguration (one
        service a configuration; the execution policy and method are the
        service's)."""
        e = self.engine
        mismatches = [
            f"{name}: spec={got} != service={want}"
            for name, got, want in (
                ("eps", float(spec.eps), float(e.eps)),
                ("tol", float(spec.tol), float(e.tol)),
                ("max_iter", int(spec.max_iter), int(e.max_iter)),
                ("momentum", float(spec.momentum), float(e.momentum)),
            )
            if got != want
        ]
        if spec.schedule is not None:
            mismatches.append("schedule: serving solves are single-stage "
                              "(no eps annealing)")
        if mismatches:
            raise ValueError(
                "SolveSpec incompatible with this service's engine (run one "
                "service per configuration): " + "; ".join(mismatches))
        return spec.problem()

    def submit(self, problem: Union[OTProblem, "SolveSpec"],
               now: Optional[float] = None) -> Ticket:
        """Admit one request: derive its kernel data and bucket cell, look
        up a warm start, enqueue. Returns the request's :class:`Ticket`,
        filled when a ``pump`` / ``drain`` dispatches its megabatch.

        Takes an :class:`OTProblem` or a
        :class:`~repro_torch.core.spec.SolveSpec`, whose solver-facing
        fields must match the service's engine."""
        from ..core.spec import SolveSpec
        if isinstance(problem, SolveSpec):
            problem = self._check_spec(problem)
        if float(problem.eps) != float(self.engine.eps):
            raise ValueError(
                f"request declares eps={problem.eps} but this service "
                f"solves at eps={self.engine.eps}; run one service per eps")
        now = self.clock() if now is None else now
        ticket = Ticket(self.queue.admitted, now)
        t0 = time.perf_counter()
        ka, kb = self.engine.kernel_data(problem)
        a, b = problem.a, problem.b
        shape = self.engine.batch_shape(ka, kb)
        n = a.shape[0]
        weights = torch.cat([a, b]).cpu().numpy()
        a_host, b_host = weights[:n], weights[n:]
        t0 = self._tick("kernel_data", t0)
        f0 = g0 = None
        support_key = full_key = b""
        if self.warm_starts or self.recovery is not None:
            # recovery needs the keys too (quarantine is keyed on them)
            support_key, full_key = self.warm.keys_for(ka, kb, a_host,
                                                       b_host)
            t0 = self._tick("fingerprint", t0)
        if self.recovery is not None:
            count = self._quarantine.get(full_key, 0)
            if count >= self.quarantine_after:
                self._quarantine.move_to_end(full_key)
                self.quarantine_rejects += 1
                raise QuarantineError(
                    f"request fingerprint exhausted the recovery ladder "
                    f"{count}x and is quarantined (quarantine_after="
                    f"{self.quarantine_after})")
        if self.warm_starts:
            hit = self.warm.lookup(support_key, full_key)
            if hit is not None:
                f0, g0 = hit.f, hit.g
                ticket.warm_hit = True
                ticket.warm_exact = hit.exact
        adm = _Admitted(
            ticket=ticket, ka=ka, kb=kb, a=a, b=b, a_host=a_host,
            b_host=b_host, support_key=support_key, full_key=full_key,
            f0=f0, g0=g0,
            problem=problem if self.recovery is not None else None,
        )
        self.queue.add(shape, adm, now)
        return ticket

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Dispatch every due megabatch; returns requests completed."""
        now = self.clock() if now is None else now
        done = 0
        for shape, items in self.queue.pop_due(now, force=force):
            done += self._dispatch(shape, items)
        return done

    def drain(self) -> int:
        """Flush everything pending whatever its age; returns requests
        completed."""
        return self.pump(force=True)

    def solve_many(self, problems: Sequence[OTProblem]
                   ) -> List[Optional[SinkhornResult]]:
        """Submit all, drain, and return the results in submission order
        (the serving twin of ``BatchedSinkhorn.solve_many``)."""
        tickets = [self.submit(p) for p in problems]
        self.drain()
        return [t.result for t in tickets]

    def next_deadline(self) -> Optional[float]:
        return self.queue.next_deadline()

    def pending(self) -> int:
        return len(self.queue)

    # -- planning ------------------------------------------------------------

    def _shapes(self, cells) -> List[OTBatchShape]:
        """Bucket cells from :class:`OTBatchShape` s or raw ``(n, m, r)``
        support triples."""
        shapes = []
        for c in cells:
            if isinstance(c, OTBatchShape):
                shapes.append(c)
            else:
                n, m, r = c
                shapes.append(
                    OTBatchShape.for_quadratic(n, m)
                    if self.engine.method in self.engine._QUADRATIC
                    else OTBatchShape.for_problem(n, m, r))
        return shapes

    def warmup(
        self,
        cells: Iterable[Union[OTBatchShape, Tuple[int, int, int]]],
        batches: Optional[Iterable[int]] = None,
    ) -> int:
        """Pre-plan runners for the expected traffic shapes: every batch
        bucket up to ``max_batch`` a cell unless ``batches`` narrows it.
        Returns the runners built."""
        return self.runners.warm(self._shapes(cells), batches)

    # -- dispatch ------------------------------------------------------------

    def _megabatch(self, shape: OTBatchShape, engine: BatchedSinkhorn,
                   lanes: Sequence[Tuple]):
        """The stacked, bucket-padded operands of ``lanes`` (each ``(ka,
        kb, a, b, f0, g0)``, potentials host arrays or None), built on the
        device: each lane copied into its slot, its kernel data padded by
        replicating its last row (and column, for a cost) and its weights
        with zeros, the padded atoms carrying no mass; the warm
        potentials go up in one copy, zeros for a cold lane (the cold
        start) and for a warm lane's padded atoms, as the JAX package
        pads them."""
        B, n_pad, m_pad = len(lanes), shape.n_pad, shape.m_pad
        quadratic = engine.method in engine._QUADRATIC
        kw = dict(dtype=torch.float32, device=self.device)
        ka = torch.empty((B, n_pad, m_pad if quadratic else shape.r), **kw)
        kb = ka if quadratic else torch.empty((B, m_pad, shape.r), **kw)
        a = torch.zeros((B, n_pad), **kw)
        b = torch.zeros((B, m_pad), **kw)
        inits = np.zeros((B, n_pad + m_pad), np.float32)
        for j, (ka_j, kb_j, a_j, b_j, f0, g0) in enumerate(lanes):
            n, m = a_j.shape[0], b_j.shape[0]
            if quadratic:
                ka[j, :n, :m] = ka_j
                ka[j, n:, :m] = ka_j[-1:]
                ka[j, :, m:] = ka[j, :, m - 1:m]
            else:
                ka[j, :n] = ka_j
                ka[j, n:] = ka_j[-1:]
                kb[j, :m] = kb_j
                kb[j, m:] = kb_j[-1:]
            a[j, :n] = a_j
            b[j, :m] = b_j
            if f0 is not None:
                inits[j, :n] = f0
                inits[j, n_pad:n_pad + m] = g0
        inits = torch.from_numpy(inits).to(self.device)
        return ka, kb, a, b, inits[:, :n_pad], inits[:, n_pad:]

    @staticmethod
    def _pull(res: SinkhornResult, sizes: Sequence[Tuple[int, int]]
              ) -> List[SinkhornResult]:
        """The results of the first ``len(sizes)`` lanes, unpadded to their
        ``(n, m)``, from one read of the megabatch to the host."""
        B, n_pad = res.f.shape
        m_pad = res.g.shape[1]
        packed = torch.cat(
            [res.u.reshape(-1), res.v.reshape(-1), res.f.reshape(-1),
             res.g.reshape(-1), res.cost.reshape(-1).float(),
             res.marginal_err.reshape(-1).float(),
             res.converged.reshape(-1).float()]).cpu()
        cols = [B * n_pad, B * m_pad, B * n_pad, B * m_pad, B, B, B]
        u, v, f, g, cost, err, conv = torch.split(packed, cols)
        u, f = u.view(B, n_pad), f.view(B, n_pad)
        v, g = v.view(B, m_pad), g.view(B, m_pad)
        n_iter = torch.as_tensor(res.n_iter).reshape(-1)
        return [SinkhornResult(u=u[j, :n], v=v[j, :m], f=f[j, :n],
                               g=g[j, :m], cost=cost[j],
                               n_iter=int(n_iter[j]), marginal_err=err[j],
                               converged=conv[j] > 0)
                for j, (n, m) in enumerate(sizes)]

    def _dispatch(self, shape: OTBatchShape, items: List[_Admitted]) -> int:
        t0 = time.perf_counter()
        b_real = len(items)
        b_pad = ot_batch_bucket(b_real, self.max_batch)
        # pad dead lanes by replicating a real request: the duplicates
        # converge exactly like their source (no all-zero-weight lane to
        # poison or stall the batched loop) and are discarded
        lanes = items + [items[-1]] * (b_pad - b_real)
        args = self._megabatch(shape, self.engine, [
            (it.ka, it.kb, it.a, it.b, it.f0, it.g0) for it in lanes])
        runner = self.runners.get(shape, b_pad)
        t0 = self._tick("pad_upload", t0)
        try:
            if self.chaos_hook is not None:
                self.chaos_hook(shape, b_pad)
            res = runner.run(*args)
            t0 = self._tick("dispatch", t0)
            results = self._pull(res, [(it.n, it.m) for it in items])
            t0 = self._tick("pull_unpad", t0)
        except Exception as exc:
            # a runner's own fault or an injected one: with recovery the
            # megabatch is absorbed and every request retries alone down
            # the ladder, starting with a cold re-run of the base
            # configuration; a kernel or CUDA runtime fault never is
            if self.recovery is None or device_fault(exc):
                raise
            self.runner_faults += 1
            for it in items:
                self._recover_one(it, None, fault=exc)
            self.served += b_real
            self.batches += 1
            return b_real
        t_done = self.clock()
        for it, r in zip(items, results):
            h = classify(r, f_init=it.f0, g_init=it.g0, a=it.a_host,
                         b=it.b_host)
            self.health_hist[h.verdict] += 1
            it.ticket.health = h
            if self.recovery is not None and \
                    h.verdict not in self.recovery.accept:
                self._recover_one(it, h)
                continue
            it.ticket.result = r
            it.ticket.t_done = t_done
            self._store(it, r)
            iters = int(r.n_iter)
            if it.ticket.warm_hit:
                self.served_warm += 1
                self.iters_warm += iters
            else:
                self.served_cold += 1
                self.iters_cold += iters
        self._tick("classify", t0)
        self.served += b_real
        self.batches += 1
        return b_real

    def _store(self, it: _Admitted, r: SinkhornResult) -> None:
        """Offer a served result's potentials to the warm cache (copies:
        the result's tensors are views of its megabatch's host read)."""
        if self.warm_starts:
            self.warm.store(it.support_key, it.full_key,
                            r.f.numpy().copy(), r.g.numpy().copy(),
                            it.a_host, it.b_host)

    # -- recovery ladder -----------------------------------------------------

    def _base_state(self) -> _LadderState:
        e = self.engine
        return _LadderState(method=e.method, precision=e.precision,
                            use_pallas=e.use_pallas,
                            inner_steps=e.inner_steps,
                            check_every=e.check_every)

    def _rung_cache(self, state: _LadderState, eps: float) -> RunnerCache:
        """The batch-1 RunnerCache of one cumulative ladder configuration.
        Its engine is built directly (not through ``get_engine``), so
        recovery traffic never churns the engine LRU; its captures are
        once a (configuration, cell) and can be paid ahead through
        :meth:`warmup_recovery`."""
        key = (state.method, float(eps), state.precision, state.use_pallas,
               state.inner_steps, state.check_every)
        cache = self._rung_caches.get(key)
        if cache is None:
            engine = BatchedSinkhorn(
                eps=float(eps), method=state.method,
                tol=self.engine.tol, max_iter=self.engine.max_iter,
                momentum=self.engine.momentum,
                use_pallas=state.use_pallas,
                inner_steps=state.inner_steps,
                check_every=state.check_every,
                precision=state.precision,
            )
            cache = self._rung_caches[key] = RunnerCache(
                engine, capacity=8, max_batch=1, device=self.device)
        return cache

    def _apply_rung(self, state: _LadderState, rung: str,
                    it: _Admitted, first_cold: bool,
                    any_applied: bool) -> Tuple[bool, Optional[float]]:
        """Mutate ``state`` for one rung; returns ``(applicable,
        stage_eps)``. An inapplicable rung (already in that state, or a
        geometry that cannot take it) returns False and consumes no
        attempt. Rungs are cumulative: each keeps the degradations before
        it. The configuration rungs are the ladder's own
        (:func:`~repro_torch.resilience.ladder.degrade`)."""
        if rung in CONFIG_RUNGS:
            return degrade(state, rung), None
        if rung == "raise_eps":
            geom = it.problem.geometry if it.problem is not None else None
            if geom is None or not getattr(geom, "anneal_capable", False):
                return False, None
            return True, float(self.engine.eps) * self.recovery.eps_scale
        if rung == "cold_restart":
            # every recovery attempt already solves cold, so a bare
            # restart only adds information when nothing cold has run
            # yet: a poisoned warm first attempt, or a runner fault
            return (not any_applied and not first_cold), None
        return False, None

    def _run_rung(self, state: _LadderState, it: _Admitted,
                  eps: float, f0: Optional[np.ndarray],
                  g0: Optional[np.ndarray]) -> SinkhornResult:
        """One solo solve of ``it`` under a ladder configuration, through
        that configuration's pre-captured batch-1 runner."""
        cache = self._rung_cache(state, eps)
        engine = cache.engine
        # the kernel data under the rung's method and eps (log features
        # for the log twin, the geometry rebuilt at a raised eps)
        ka, kb = engine.kernel_data(it.problem)
        shape = engine.batch_shape(ka, kb)
        args = self._megabatch(shape, engine, [(ka, kb, it.a, it.b, f0, g0)])
        res = cache.get(shape, 1).run(*args)
        return self._pull(res, [(it.n, it.m)])[0]

    def _attempt(self, state: _LadderState, it: _Admitted,
                 stage_eps: Optional[float]) -> SinkhornResult:
        if stage_eps is None:
            return self._run_rung(state, it, float(self.engine.eps),
                                  None, None)
        # raise_eps is two stages with a warm hand-off (the EpsSchedule
        # cascade): solve cold at the raised eps, then at the service eps
        # from the stage-1 potentials. Non-finite stage-1 entries (-inf on
        # dead atoms) hand off as 0, the cold start of that atom.
        r1 = self._run_rung(state, it, stage_eps, None, None)
        f1, g1 = r1.f.numpy(), r1.g.numpy()
        f0 = np.where(np.isfinite(f1), f1, 0.0)
        g0 = np.where(np.isfinite(g1), g1, 0.0)
        return self._run_rung(state, it, float(self.engine.eps), f0, g0)

    def _recover_one(self, it: _Admitted, first_health: Optional[SolveHealth],
                     fault: Optional[Exception] = None) -> None:
        """Climb the recovery ladder for one failed request. Terminal:
        fills either ``ticket.result`` (and its health) or
        ``ticket.refusal``."""
        pol = self.recovery
        ticket = it.ticket
        if first_health is not None:
            order = pol.ordered_rungs(first_health.verdict)
        else:
            # runner fault: nothing numerical happened; retry the base
            # configuration cold first, then the standard ladder
            order = ("cold_restart",) + tuple(
                r for r in pol.rungs if r != "cold_restart")
        deadline = (time.monotonic() + pol.deadline_s
                    if pol.deadline_s is not None else None)
        state = self._base_state()
        applied: List[str] = []
        attempts = 1                       # the failed batched attempt
        last_health = first_health
        stage: Optional[float] = None      # sticks once raise_eps applies
        for rung in order:
            if attempts >= pol.max_attempts:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            ok, stage_eps = self._apply_rung(
                state, rung, it, first_cold=(it.f0 is None and fault is None),
                any_applied=bool(applied))
            if not ok:
                continue
            if stage_eps is not None:
                # cumulative: later rungs keep the two-stage eps cascade
                stage = stage_eps
            applied.append(rung)
            attempts += 1
            self.recovery_attempts += 1
            try:
                r = self._attempt(state, it, stage)
            except Exception as exc:
                if device_fault(exc):
                    raise
                self.runner_faults += 1
                continue
            h = classify(r, a=it.a_host, b=it.b_host)
            last_health = h
            if h.verdict in pol.accept:
                ticket.result = r
                ticket.health = h
                ticket.t_done = self.clock()
                ticket.attempts = attempts
                ticket.rungs = tuple(applied)
                self._store(it, r)
                self.recovered += 1
                self.rung_hist[rung] += 1
                self.served_cold += 1
                self.iters_cold += int(r.n_iter)
                return
        # ladder exhausted: a structured refusal, never a NaN result
        reason = "runner_fault" if (fault is not None and not applied) \
            else "recovery_exhausted"
        detail = (f"{type(fault).__name__}: {fault}" if fault is not None
                  else f"ladder exhausted after {attempts} attempts "
                       f"(rungs tried: {applied or ['none applicable']})")
        ticket.refusal = Refusal(reason=reason, detail=detail,
                                 health=last_health)
        ticket.health = last_health
        ticket.t_done = self.clock()
        ticket.attempts = attempts
        ticket.rungs = tuple(applied)
        self.refused += 1
        count = self._quarantine.get(it.full_key, 0) + 1
        self._quarantine[it.full_key] = count
        self._quarantine.move_to_end(it.full_key)
        while len(self._quarantine) > self.quarantine_capacity:
            self._quarantine.popitem(last=False)

    def warmup_recovery(
        self,
        cells: Iterable[Union[OTBatchShape, Tuple[int, int, int]]],
        *,
        anneal: bool = True,
    ) -> int:
        """Pre-capture the batch-1 rung runners every ladder prefix can
        reach for the expected cells: the recovery twin of :meth:`warmup`,
        and what keeps retries free of captures under traffic.
        ``anneal=False`` skips the raised-eps configurations where no
        traffic geometry is anneal-capable. Returns the runners built."""
        if self.recovery is None:
            return 0
        shapes = self._shapes(cells)
        base_eps = float(self.engine.eps)
        raised_eps = base_eps * self.recovery.eps_scale
        # walk the cumulative ladder, collecting every state a recovery
        # could solve under (cold_restart is the base state)
        state = self._base_state()
        states = [dataclasses.replace(state)]
        for rung in self.recovery.rungs:
            # raise_eps and cold_restart keep the configuration
            if rung in CONFIG_RUNGS and degrade(state, rung):
                states.append(dataclasses.replace(state))
        # the raised-eps stage composes with every cumulative state (a
        # later rung keeps the eps cascade), so warm each at both eps
        configs = [(st, base_eps) for st in states]
        if anneal and "raise_eps" in self.recovery.rungs:
            configs += [(st, raised_eps) for st in states]
        built = 0
        for st, eps in configs:
            built += self._rung_cache(st, eps).warm(shapes, batches=(1,))
        return built

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Every serving counter in one snapshot: the runner cache
        (captures paid = misses, steady-state hits, re-captures), the warm
        cache (exact / near hit rates), the engine LRU (this service's
        engine is one entry in it), the mean iterations of warm and cold
        requests (the warm-start win), the resilience counters, and
        ``host_s``, the host's seconds in each step of ``HOST_SPLIT``."""
        return dict(
            runner=self.runners.snapshot(),
            warm=self.warm.snapshot(),
            engine=engine_cache_info(),
            served=self.served,
            batches=self.batches,
            pending=self.pending(),
            mean_batch=self.served / self.batches if self.batches else 0.0,
            mean_iters_warm=(self.iters_warm / self.served_warm
                             if self.served_warm else 0.0),
            mean_iters_cold=(self.iters_cold / self.served_cold
                             if self.served_cold else 0.0),
            shed=self.queue.shed,
            health=dict(self.health_hist),
            host_s=dict(self.host_s),
            recovery=dict(
                enabled=self.recovery is not None,
                attempts=self.recovery_attempts,
                recovered=self.recovered,
                refused=self.refused,
                runner_faults=self.runner_faults,
                quarantine_rejects=self.quarantine_rejects,
                quarantined=sum(
                    1 for c in self._quarantine.values()
                    if c >= self.quarantine_after),
                rung_hist=dict(self.rung_hist),
                rung_configs=len(self._rung_caches),
                rung_runners=sum(
                    len(c) for c in self._rung_caches.values()),
                rung_compiles=sum(
                    c.misses for c in self._rung_caches.values()),
                rung_extra_traces=sum(
                    c.extra_traces for c in self._rung_caches.values()),
            ),
        )
