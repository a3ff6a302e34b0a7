"""Configuration records of the port: the OT support-size buckets."""
from __future__ import annotations

from .shapes import OT_SUPPORT_BUCKETS, ot_bucket

__all__ = ["OT_SUPPORT_BUCKETS", "ot_bucket"]
