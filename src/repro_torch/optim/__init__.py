"""Optimizers of the port: AdamW, its schedules and clipping, and the
int8 error-feedback gradient compression. Counterpart of
``repro.optim``."""
from __future__ import annotations

from .adamw import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    init_adamw,
    linear_warmup_cosine,
)
from .compression import (
    QuantizedGrad,
    compressed_psum,
    dequantize_int8,
    ef_compress_tree,
    init_error_buffers,
    quantize_int8,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "QuantizedGrad",
    "adamw_update",
    "clip_by_global_norm",
    "compressed_psum",
    "cosine_schedule",
    "dequantize_int8",
    "ef_compress_tree",
    "global_norm",
    "init_adamw",
    "init_error_buffers",
    "linear_warmup_cosine",
    "quantize_int8",
]
