"""Streaming front end: mutation requests coalesced through the admission
queue, one warm re-solve per pair per flush.

Mutations to a streaming pair arrive ragged, but each invalidates the same
thing, the pair's coupling, so solving after each one wastes re-solves. The
service keys :class:`~repro_torch.serving.admission.AdmissionQueue` by the
pair name: mutations batch under the max-batch / max-wait policy, and a
due flush applies the whole batch to the stores (removals before inserts,
FIFO within each kind) before one warm ``re_solve``. Every ticket of the
batch gets the same result. The loop is synchronous and single-threaded
with an injected clock: ``submit_update`` enqueues, ``pump`` / ``drain``
dispatch. Counterpart of ``repro.serving.streaming``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.sinkhorn import SinkhornResult
from ..streaming import StreamingDistribution, StreamingPair, StreamingSolver
from .admission import AdmissionQueue

__all__ = ["MutationTicket", "StreamingOTService"]


class MutationTicket:
    """Handle for one submitted mutation; resolved at the batch flush."""

    __slots__ = ("seq", "pair", "t_submit", "t_done", "result", "health")

    def __init__(self, seq: int, pair: str, t_submit: float):
        self.seq = seq
        self.pair = pair
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self.result: Optional[SinkhornResult] = None
        self.health = None      # SolveHealth of the flush that served it

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise RuntimeError("ticket not dispatched yet")
        return self.t_done - self.t_submit


class StreamingOTService:
    """Mutation-coalescing wrapper around :class:`StreamingSolver`.

    ``max_batch`` / ``max_wait`` are the admission policy per pair: a pair
    flushes when it holds ``max_batch`` pending mutations or its oldest has
    waited ``max_wait`` seconds. ``solver`` defaults to a scaling-space
    :class:`StreamingSolver`; pass a configured one to pick the log domain
    or the tolerances.
    """

    def __init__(self, *, solver: Optional[StreamingSolver] = None,
                 max_batch: int = 16, max_wait: float = 0.005,
                 clock: Callable[[], float] = time.monotonic):
        self.solver = solver if solver is not None else StreamingSolver()
        self.queue: AdmissionQueue = AdmissionQueue(
            max_batch=max_batch, max_wait=max_wait)
        self.clock = clock
        self._seq = 0
        self.dispatched = 0
        self.solves = 0

    # -- registry ------------------------------------------------------

    def register(self, name: str, x: StreamingDistribution,
                 y: StreamingDistribution, *,
                 warmup: bool = True) -> StreamingPair:
        """Track a pair; by default builds and runs its runner once, so the
        first flush finds it ready."""
        pair = self.solver.register(name, x, y)
        if warmup:
            self.solver.warmup(pair)
        return pair

    # -- submission ----------------------------------------------------

    def submit_update(self, pair: str, *,
                      add_x: Optional[dict] = None,
                      remove_x: Optional[Sequence] = None,
                      add_y: Optional[dict] = None,
                      remove_y: Optional[Sequence] = None,
                      now: Optional[float] = None) -> MutationTicket:
        """Enqueue one mutation of a registered pair (``KeyError`` for an
        unknown one). ``add_*`` are keyword dicts for
        :meth:`~repro_torch.streaming.StreamingDistribution.add`,
        ``remove_*`` id sequences. The mutation lands at the batch flush,
        with every other pending mutation of the pair, before the one warm
        re-solve."""
        self.solver.pair(pair)
        now = self.clock() if now is None else now
        ticket = MutationTicket(self._seq, pair, now)
        self._seq += 1
        self.queue.add(pair, (ticket, add_x, remove_x, add_y, remove_y),
                       now)
        return ticket

    # -- dispatch ------------------------------------------------------

    def _apply(self, pair: StreamingPair,
               items: List[Tuple]) -> SinkhornResult:
        # removals first, so a remove and re-add of one id within a batch
        # nets out to the re-add (FIFO within each kind)
        for _, _, remove_x, _, remove_y in items:
            if remove_x:
                pair.x.remove(remove_x)
            if remove_y:
                pair.y.remove(remove_y)
        for _, add_x, _, add_y, _ in items:
            if add_x:
                pair.x.add(**add_x)
            if add_y:
                pair.y.add(**add_y)
        return self.solver.re_solve(pair)

    def pump(self, now: Optional[float] = None, force: bool = False) -> int:
        """Flush the due mutation batches; returns the tickets resolved."""
        now = self.clock() if now is None else now
        resolved = 0
        for name, items in self.queue.pop_due(now, force):
            pair = self.solver.pair(name)
            result = self._apply(pair, items)
            self.solves += 1
            t_done = self.clock() if force or now is None else now
            for ticket, *_ in items:
                ticket.result = result
                ticket.health = pair.last_health
                ticket.t_done = t_done
                resolved += 1
            self.dispatched += len(items)
        return resolved

    def drain(self) -> int:
        """Flush everything pending regardless of age."""
        return self.pump(force=True)

    def next_deadline(self) -> Optional[float]:
        return self.queue.next_deadline()

    @property
    def pending(self) -> int:
        return len(self.queue)

    def stats(self) -> Dict[str, object]:
        s = dict(self.solver.stats())
        s.update(
            pending=self.pending,
            dispatched=self.dispatched,
            solves=self.solves,
            coalesce_ratio=(self.dispatched / self.solves
                            if self.solves else 0.0),
            flushed_full=self.queue.flushed_full,
            flushed_aged=self.queue.flushed_aged,
        )
        return s
