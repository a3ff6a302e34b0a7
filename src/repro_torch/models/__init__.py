"""The LM surfaces of the port for the ``dense``, ``vlm``, ``moe``,
``ssm``, ``hybrid`` and ``encdec`` families: parameters, forward, the
training loss with the OT prototype term, prefill and decode, and the
Mamba2 mixer of ``models.ssm``. Counterpart of ``repro.models``."""
from __future__ import annotations

from .model import (
    cache_logical_axes,
    check_ported,
    decode_step,
    effective_window,
    forward,
    group_plan,
    init_caches,
    init_params,
    param_count,
    prefill,
    shard_caches,
    train_loss,
)
from .ssm import (
    Mamba2Cache,
    init_mamba2,
    init_mamba2_cache,
    mamba2_decode,
    mamba2_train,
)

__all__ = [
    "Mamba2Cache",
    "cache_logical_axes",
    "check_ported",
    "decode_step",
    "effective_window",
    "forward",
    "group_plan",
    "init_caches",
    "init_mamba2",
    "init_mamba2_cache",
    "init_params",
    "mamba2_decode",
    "mamba2_train",
    "param_count",
    "prefill",
    "shard_caches",
    "train_loss",
]
