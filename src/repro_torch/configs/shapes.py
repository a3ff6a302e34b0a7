"""OT support-size buckets: the capacities the streaming stores (and, once
ported, the batched engine) pad a support to.

Powers of two bound padding waste at < 2x. Counterpart of the OT bucket
part of ``repro.configs.shapes``; the architecture shapes and the batch
buckets wait for the batched engine.
"""
from __future__ import annotations

import bisect
from typing import Tuple

__all__ = ["OT_SUPPORT_BUCKETS", "ot_bucket"]

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
