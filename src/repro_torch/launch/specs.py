"""Input and cache specs of an LM cell, as tensors on the ``meta``
device: the shapes and dtypes of every model input and of the decode
caches, with nothing allocated. Tokens and labels are int64 (the port's
index type). Counterpart of ``input_specs`` and ``cache_specs`` of
``repro.launch.specs``; the parameter, input and cache shardings wait for
the multi-card slice (ROADMAP.md §A item 8d).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..configs import ArchConfig, ShapeSpec
from ..models import init_caches

__all__ = ["input_specs", "cache_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for the (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tok = torch.int64
    if shape.mode == "train":
        if cfg.input_kind == "embeds":
            return {"embeds": _meta((B, S, d), cfg.cdtype),
                    "labels": _meta((B, S), tok)}
        if cfg.input_kind == "encdec":
            return {"enc_embeds": _meta((B, S, d), cfg.cdtype),
                    "tokens": _meta((B, S), tok),
                    "labels": _meta((B, S), tok)}
        return {"tokens": _meta((B, S), tok), "labels": _meta((B, S), tok)}
    if shape.mode == "prefill":
        if cfg.input_kind == "embeds":
            return {"embeds": _meta((B, S, d), cfg.cdtype)}
        if cfg.input_kind == "encdec":
            return {"enc_embeds": _meta((B, S, d), cfg.cdtype),
                    "tokens": _meta((B, S), tok)}
        return {"tokens": _meta((B, S), tok)}
    # decode: one new token against an S-long cache
    out: Dict[str, Any] = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = _meta((B, 1, d), cfg.cdtype)
    else:
        out["tokens"] = _meta((B, 1), tok)
    if cfg.input_kind == "encdec":
        kv = (cfg.n_layers, B, S, cfg.n_heads, cfg.head_dim)
        out["enc_kv"] = {"k": _meta(kv, cfg.cdtype),
                         "v": _meta(kv, cfg.cdtype)}
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> List[Any]:
    """The decode caches of the cell, on ``meta``."""
    return init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")
