"""Configuration records of the port: the ten architectures
(``get_config``, ``list_archs``), the LM cells' input shapes, the OT
support-size and batch buckets and the batched engine's cell.
Counterpart of ``repro.configs``."""
from __future__ import annotations

from .base import ArchConfig, get_config, list_archs, register
from .shapes import (
    OT_SUPPORT_BUCKETS,
    SHAPES,
    OTBatchShape,
    ShapeSpec,
    all_cells,
    cell_applicable,
    get_shape,
    ot_batch_bucket,
    ot_bucket,
)

__all__ = [
    "ArchConfig",
    "OT_SUPPORT_BUCKETS",
    "OTBatchShape",
    "SHAPES",
    "ShapeSpec",
    "all_cells",
    "cell_applicable",
    "get_config",
    "get_shape",
    "list_archs",
    "ot_batch_bucket",
    "ot_bucket",
    "register",
]
