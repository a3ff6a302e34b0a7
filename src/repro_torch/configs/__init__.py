"""Configuration records of the port: the OT support-size and batch
buckets and the batched engine's cell."""
from __future__ import annotations

from .shapes import OT_SUPPORT_BUCKETS, OTBatchShape, ot_batch_bucket, ot_bucket

__all__ = ["OT_SUPPORT_BUCKETS", "OTBatchShape", "ot_batch_bucket",
           "ot_bucket"]
