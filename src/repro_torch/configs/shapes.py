"""OT support-size buckets: the capacities the streaming stores and the
batched engine pad a support to, the batch-count buckets of a serving
layer, and the bucket cell a batched solve is grouped and cached by.

Powers of two bound padding waste at < 2x. Counterpart of the OT bucket
part of ``repro.configs.shapes``; the architecture shapes wait for the LM
surfaces.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Tuple

__all__ = ["OT_SUPPORT_BUCKETS", "ot_bucket", "ot_batch_bucket",
           "OTBatchShape"]

OT_SUPPORT_BUCKETS: Tuple[int, ...] = (
    64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
)


def ot_bucket(n: int) -> int:
    """Smallest bucket >= n; support sizes above the largest bucket round up
    to the next multiple of the largest bucket."""
    if n <= 0:
        raise ValueError(f"support size must be positive, got {n}")
    i = bisect.bisect_left(OT_SUPPORT_BUCKETS, n)
    if i < len(OT_SUPPORT_BUCKETS):
        return OT_SUPPORT_BUCKETS[i]
    top = OT_SUPPORT_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def ot_batch_bucket(b: int, max_batch: int) -> int:
    """Batch-count bucket: the smallest power of two >= b, capped at
    ``max_batch``. A serving layer pads a megabatch up to it (replicating
    a real problem lane, whose duplicates are discarded), so each support
    cell captures O(log max_batch) loops, one a problem count."""
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    if b >= max_batch:
        return max_batch
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch)


@dataclasses.dataclass(frozen=True)
class OTBatchShape:
    """A bucketed batch cell: problems padded to (n_pad, m_pad) with a
    shared feature rank r, the key the batched engine groups problems by.
    Quadratic-method cells carry ``r = 0``: a dense cost has no rank."""

    n_pad: int
    m_pad: int
    r: int

    @classmethod
    def for_problem(cls, n: int, m: int, r: int) -> "OTBatchShape":
        return cls(n_pad=ot_bucket(n), m_pad=ot_bucket(m), r=r)

    @classmethod
    def for_quadratic(cls, n: int, m: int) -> "OTBatchShape":
        return cls(n_pad=ot_bucket(n), m_pad=ot_bucket(m), r=0)
