"""Grouped-query attention (MHA when ``n_kv == n_heads``; sliding windows;
QKV bias) for training, prefill and decode.

:func:`chunked_attention` is the memory-efficient (flash-style) core: the
KV axis is taken in chunks with a running (max, sum, accumulator), so no
(S_q x S_kv) score matrix is ever built. The JAX package has no Pallas
kernel here (its attention stays in XLA), so plain PyTorch is the port.

Decode reads the cache and writes nothing: :func:`gqa_attend_step`
attends over the slots before the current position plus the new token as
an explicit self term, and returns the new token's (k, v) for the caller
to write once per step (``models.model.decode_step``). A sliding window
decodes on a rolling cache of ``window`` slots. MLA and cross-attention
wait for their families (ROADMAP.md, queue A). Counterpart of the GQA
half of ``repro.models.attention``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import apply_rotary, init_linear, linear, rotary_cos_sin

__all__ = [
    "chunked_attention",
    "init_gqa",
    "gqa_train",
    "GQACache",
    "gqa_attend_step",
    "init_gqa_cache",
    "gqa_decode",
]

_NEG_INF = -1e30


def chunked_attention(
    q: torch.Tensor,                  # (B, Q, H, D), scaled and rotated
    kv: Dict[str, torch.Tensor],      # tensors with the KV sequence on dim 1
    s_kv: int,
    *,
    score_fn: Callable[[torch.Tensor, Any], torch.Tensor],   # -> (B, H, Q, Ck)
    value_fn: Callable[[torch.Tensor, Any], torch.Tensor],   # -> (B, Q, H, D)
    mask_fn: Callable[[torch.Tensor], torch.Tensor],         # (Ck,) -> (.., Q, Ck)
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Numerically stable streaming softmax over KV chunks, float32."""
    B, Q, H, D = q.shape
    kv_chunk = min(kv_chunk, s_kv)
    n_chunks = -(-s_kv // kv_chunk)
    m = torch.full((B, H, Q), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Q), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Q, H, D), dtype=torch.float32, device=q.device)
    pad = n_chunks * kv_chunk - s_kv
    if pad:
        kv = {k: F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
              for k, v in kv.items()}
    for c in range(n_chunks):
        lo = c * kv_chunk
        kv_c = {k: v[:, lo:lo + kv_chunk] for k, v in kv.items()}
        pos_k = lo + torch.arange(kv_chunk, device=q.device)
        s = score_fn(q, kv_c).float()                       # (B, H, Q, Ck)
        valid = (pos_k < s_kv)[None, None, None, :]
        s = torch.where(mask_fn(pos_k) & valid, s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + value_fn(p, kv_c)
        m = m_new
    l = torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return acc / l


def init_gqa(generator, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, *, qkv_bias: bool = False, dtype=torch.float32,
             device=None, lead=()) -> Dict[str, Dict[str, torch.Tensor]]:
    kw = dict(dtype=dtype, device=device, lead=lead)
    out_std = 0.02 / (2.0 ** 0.5)
    return {
        "wq": init_linear(generator, d_model, n_heads * head_dim,
                          bias=qkv_bias, **kw),
        "wk": init_linear(generator, d_model, n_kv * head_dim,
                          bias=qkv_bias, **kw),
        "wv": init_linear(generator, d_model, n_kv * head_dim,
                          bias=qkv_bias, **kw),
        "wo": init_linear(generator, n_heads * head_dim, d_model,
                          std=out_std, **kw),
    }


def _gqa_score_fn(n_kv: int):
    def fn(q, kv_c):
        # q (B, Q, H, D) grouped as (B, Q, KH, G, D); k (B, Ck, KH, D)
        B, Q, H, D = q.shape
        qg = q.reshape(B, Q, n_kv, H // n_kv, D)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kv_c["k"])
        return s.reshape(B, H, Q, -1)
    return fn


def _gqa_value_fn(n_kv: int):
    def fn(p, kv_c):
        B, H, Q, Ck = p.shape
        pg = p.reshape(B, n_kv, H // n_kv, Q, Ck)
        o = torch.einsum("bkgqs,bskd->bqkgd", pg, kv_c["v"].float())
        return o.reshape(B, Q, H, -1)
    return fn


def _causal_window_mask(pos_q: torch.Tensor, window: Optional[int]):
    """pos_q (Q,) query positions -> mask_fn(pos_k (Ck,))."""

    def mask_fn(pos_k):
        m = pos_k[None, :] <= pos_q[:, None]
        if window is not None:
            m = m & ((pos_q[:, None] - pos_k[None, :]) < window)
        return m[None, None, :, :]

    return mask_fn


def gqa_train(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
              rope_theta: float = 10000.0, window: Optional[int] = None,
              kv_chunk: int = 1024,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal attention, (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device) if positions is None else positions
    q = linear(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = linear(p["wk"], x).reshape(B, S, n_kv, head_dim)
    v = linear(p["wv"], x).reshape(B, S, n_kv, head_dim)
    cos, sin = rotary_cos_sin(pos, head_dim, rope_theta)
    q = apply_rotary(q, cos[None], sin[None]) * (head_dim ** -0.5)
    k = apply_rotary(k, cos[None], sin[None])
    out = chunked_attention(
        q, {"k": k, "v": v}, S,
        score_fn=_gqa_score_fn(n_kv), value_fn=_gqa_value_fn(n_kv),
        mask_fn=_causal_window_mask(pos, window), kv_chunk=kv_chunk)
    return linear(p["wo"], out.reshape(B, S, n_heads * head_dim).to(x.dtype))


class GQACache(NamedTuple):
    k: torch.Tensor          # ([L,] B, S_cache, KH, D)
    v: torch.Tensor
    length: torch.Tensor     # ([L,]) int64: tokens decoded so far


def _slot_mask(pos: torch.Tensor, s_cache: int, window: Optional[int],
               strict: bool) -> torch.Tensor:
    """Which physical slots hold a position the query at ``pos`` attends:
    with a window, slot s holds the largest logical l <= pos with
    l = s (mod s_cache) (floor division, safe for negative numbers)."""
    slots = torch.arange(s_cache, device=pos.device)
    if window:
        n_wraps = torch.div(pos - slots, s_cache, rounding_mode="floor")
        logical = slots + n_wraps * s_cache
        before = logical < pos if strict else logical <= pos
        return (logical >= 0) & before & (pos - logical < window)
    return slots < pos if strict else slots <= pos


def gqa_attend_step(p, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, length: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    rope_theta: float = 10000.0,
                    window: Optional[int] = None):
    """Decode attention over a READ-ONLY cache: x (B, 1, d).

    The current slot is excluded (its logical position is < ``length``
    strictly) and the new token is attended as an explicit self term.
    Returns ``(out, k_new (B, KH, D), v_new (B, KH, D))``; the caller
    writes the new slot into the stacked cache once per step."""
    B = x.shape[0]
    s_cache = k_cache.shape[1]
    pos = length
    q = linear(p["wq"], x).reshape(B, 1, n_heads, head_dim)
    k = linear(p["wk"], x).reshape(B, 1, n_kv, head_dim)
    v = linear(p["wv"], x).reshape(B, 1, n_kv, head_dim)
    cos, sin = rotary_cos_sin(pos[None], head_dim, rope_theta)
    q = apply_rotary(q, cos[None], sin[None]) * (head_dim ** -0.5)
    k = apply_rotary(k, cos[None], sin[None])
    valid = _slot_mask(pos, s_cache, window, strict=True)
    G = n_heads // n_kv
    qg = q.reshape(B, 1, n_kv, G, head_dim).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()
                     ).reshape(B, n_heads, 1, s_cache)
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    s_self = torch.einsum("bqkgd,bqkd->bkgq", qg, k[:, 0][:, None].float()
                          ).reshape(B, n_heads, 1, 1)
    pr = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1)
    pr_c, pr_s = pr[..., :-1], pr[..., -1:]
    pg = pr_c.reshape(B, n_kv, G, 1, s_cache).to(v_cache.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg.float(), v_cache.float())
    w_self = pr_s.reshape(B, n_kv, G)
    o = o + torch.einsum("bkg,bkd->bkgd", w_self, v[:, 0].float())[:, None]
    o = o.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    out = linear(p["wo"], o)
    return out, k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)


def init_gqa_cache(batch: int, s_max: int, n_kv: int, head_dim: int, *,
                   window: Optional[int] = None, dtype=torch.float32,
                   device=None) -> GQACache:
    s_cache = min(s_max, window) if window else s_max
    z = torch.zeros((batch, s_cache, n_kv, head_dim), dtype=dtype,
                    device=device)
    return GQACache(z, z.clone(), torch.zeros((), dtype=torch.int64,
                                              device=device))


def gqa_decode(p, x: torch.Tensor, cache: GQACache, *, n_heads: int,
               n_kv: int, head_dim: int, rope_theta: float = 10000.0,
               window: Optional[int] = None):
    """Single-token decode of one layer that writes its own cache: x
    (B, 1, d); a rolling buffer when ``window`` is set. Returns
    ``(out, new cache)``; the given cache is left as it was."""
    B = x.shape[0]
    s_cache = cache.k.shape[1]
    pos = cache.length
    slot = torch.remainder(pos, s_cache) if window else pos
    q = linear(p["wq"], x).reshape(B, 1, n_heads, head_dim)
    k = linear(p["wk"], x).reshape(B, 1, n_kv, head_dim)
    v = linear(p["wv"], x).reshape(B, 1, n_kv, head_dim)
    cos, sin = rotary_cos_sin(pos[None], head_dim, rope_theta)
    q = apply_rotary(q, cos[None], sin[None]) * (head_dim ** -0.5)
    k = apply_rotary(k, cos[None], sin[None])
    k_all = cache.k.index_copy(1, slot.reshape(1), k.to(cache.k.dtype))
    v_all = cache.v.index_copy(1, slot.reshape(1), v.to(cache.v.dtype))
    valid = _slot_mask(pos, s_cache, window, strict=False)
    G = n_heads // n_kv
    qg = q.reshape(B, 1, n_kv, G, head_dim)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_all).reshape(
        B, n_heads, 1, s_cache)
    s = torch.where(valid[None, None, None, :], s.float(), _NEG_INF)
    pr = torch.softmax(s, dim=-1)
    pg = pr.reshape(B, n_kv, G, 1, s_cache)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v_all.float())
    o = o.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    return linear(p["wo"], o), GQACache(k_all, v_all, pos + 1)
