"""The four input shapes of the LM cells and their applicability to an
architecture; the OT support-size buckets the streaming stores and the
batched engine pad a support to, the batch-count buckets of a serving
layer, and the bucket cell a batched solve is grouped and cached by.

Powers of two bound padding waste at < 2x. Counterpart of
``repro.configs.shapes``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Tuple

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "get_shape", "cell_applicable",
           "all_cells", "OT_SUPPORT_BUCKETS", "ot_bucket", "ot_batch_bucket",
           "OTBatchShape"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k needs a sub-quadratic serving path."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, (
            "skip: pure full-attention arch — 500k decode would need the "
            "entire quadratic-cost KV cache")
    if shape.mode == "decode" and not cfg.supports_decode():
        return False, "skip: encoder-only arch has no decode step"
    return True, "run"


def all_cells() -> List[Tuple[str, str]]:
    from .base import list_archs
    return [(a, s) for a in list_archs() for s in SHAPES]

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
