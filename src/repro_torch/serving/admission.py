"""Admission queue: requests grouped by a key, flushed in batches.

The queue groups pending items by a hashable key (the streaming service
keys by pair name) and flushes a group when either

* it holds ``max_batch`` items (a full batch: dispatch now), or
* its oldest item has waited ``max_wait`` seconds (the latency against
  occupancy knob).

FIFO order holds within each key. The queue owns no clock: callers pass
``now``. With ``max_depth`` set, ``add`` past that depth raises
:class:`QueueFullError` and counts the shed request instead of growing
without bound. Pure host Python. Counterpart of
``repro.serving.admission``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Generic, Hashable, List, Optional, Tuple, TypeVar

__all__ = ["AdmissionQueue", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Raised by :meth:`AdmissionQueue.add` when depth is at
    ``max_depth``: the load-shedding refusal."""


T = TypeVar("T")


@dataclasses.dataclass
class _Group(Generic[T]):
    items: List[T]
    arrivals: List[float]       # parallel to items (submission times)


class AdmissionQueue(Generic[T]):
    """Key-grouped pending items with a max-batch / max-wait flush
    policy."""

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.005,
                 max_depth: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.max_depth = max_depth
        self._groups: Dict[Hashable, _Group[T]] = {}
        self.admitted = 0
        self.shed = 0               # submissions refused at the depth bound
        self.flushed_full = 0       # groups flushed because they filled
        self.flushed_aged = 0       # groups flushed on the max_wait deadline

    def __len__(self) -> int:
        return sum(len(g.items) for g in self._groups.values())

    @property
    def full(self) -> bool:
        return self.max_depth is not None and len(self) >= self.max_depth

    def add(self, key: Hashable, item: T, now: float) -> None:
        if self.full:
            self.shed += 1
            raise QueueFullError(
                f"admission queue at max_depth={self.max_depth} "
                f"({len(self)} pending): request shed; retry after a "
                "pump/drain")
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group([], [])
        group.items.append(item)
        group.arrivals.append(now)
        self.admitted += 1

    def pop_due(self, now: float,
                force: bool = False) -> List[Tuple[Hashable, List[T]]]:
        """Flush and return every due batch as ``(key, items)``: full
        groups in ``max_batch`` chunks regardless of age, a group whose
        oldest item has waited ``max_wait`` whatever it holds, and with
        ``force`` everything."""
        out: List[Tuple[Hashable, List[T]]] = []
        for key in list(self._groups):
            group = self._groups[key]
            while len(group.items) >= self.max_batch:
                out.append((key, group.items[: self.max_batch]))
                del group.items[: self.max_batch]
                del group.arrivals[: self.max_batch]
                self.flushed_full += 1
            if group.items and (
                force or now - group.arrivals[0] >= self.max_wait
            ):
                out.append((key, group.items))
                group.items, group.arrivals = [], []
                self.flushed_aged += 1
            if not group.items:
                del self._groups[key]
        return out

    def next_deadline(self) -> Optional[float]:
        """Earliest time a pending group becomes due (its oldest arrival +
        ``max_wait``), or ``None`` when empty."""
        oldest = [g.arrivals[0] for g in self._groups.values() if g.arrivals]
        return min(oldest) + self.max_wait if oldest else None
