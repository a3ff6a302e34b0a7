"""Streaming supports: paged feature storage and incremental re-solves.

* :class:`~repro_torch.streaming.store.PagedFeatureStore` — fixed-capacity
  paged buffer of positive feature rows; insert and evict flip weights and
  write pages, never shapes.
* :class:`~repro_torch.streaming.store.StreamingDistribution` — one
  mutable side of an OT problem, with bucket-boundary regrowth.
* :class:`~repro_torch.streaming.solver.StreamingSolver` — warm-started
  re-solves through one runner per bucket cell, on the paged kernels.

The serving front end (mutations coalesced through the admission queue)
is ``repro_torch.serving.streaming``. Counterpart of ``repro.streaming``.
"""
from .solver import StreamingPair, StreamingSolver
from .store import PagedFeatureStore, StreamingDistribution, bucket_capacity

__all__ = [
    "PagedFeatureStore",
    "StreamingDistribution",
    "StreamingPair",
    "StreamingSolver",
    "bucket_capacity",
]
