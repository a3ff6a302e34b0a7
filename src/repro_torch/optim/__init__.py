"""Optimizers of the port: AdamW, its schedules and clipping. Counterpart
of ``repro.optim``; the gradient compression of the multi-card slice waits
(ROADMAP.md §A item 8d)."""
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

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "init_adamw",
    "linear_warmup_cosine",
]
