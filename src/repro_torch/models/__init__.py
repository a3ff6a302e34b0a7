"""The LM surfaces of the port for the ``dense`` and ``vlm`` families:
parameters, forward, the training loss with the OT prototype term,
prefill and decode. Counterpart of ``repro.models``."""
from __future__ import annotations

from .model import (
    check_ported,
    decode_step,
    effective_window,
    forward,
    group_plan,
    init_caches,
    init_params,
    param_count,
    prefill,
    train_loss,
)

__all__ = [
    "check_ported",
    "decode_step",
    "effective_window",
    "forward",
    "group_plan",
    "init_caches",
    "init_params",
    "param_count",
    "prefill",
    "train_loss",
]
