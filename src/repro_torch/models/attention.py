"""Grouped-query attention (MHA when ``n_kv == n_heads``; sliding windows;
QKV bias) and DeepSeek's multi-head latent attention (MLA) for training,
prefill and decode.

:func:`chunked_attention` is the memory-efficient (flash-style) core: the
KV axis is taken in chunks with a running (max, sum, accumulator), so no
(S_q x S_kv) score matrix is ever built. The JAX package has no Pallas
kernel here (its attention stays in XLA), so plain PyTorch is the port.

Decode reads the cache and writes nothing: :func:`gqa_attend_step`
attends over the slots before the current position plus the new token as
an explicit self term, and returns the new token's (k, v) for the caller
to write once per step (``models.model.decode_step``). A sliding window
decodes on a rolling cache of ``window`` slots.

MLA caches the compressed latents (``kv_lora`` + ``qk_rope`` numbers a
token) and decodes in the absorbed form: ``q_nope`` is taken into the
latent space through ``wk_up``, scores and values contract against the
cached latents, and ``wv_up`` decompresses the context once. Training
decompresses K and V a KV chunk at a time inside
:func:`chunked_attention`.

Cross-attention (the encoder-decoder family) is multi-head attention of
decoder states over encoder states, with no rotation and no mask; the
encoder's bidirectional self-attention is the same function with the
encoder states on both sides. Counterpart of ``repro.models.attention``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import MeshAxis, all_gather
from .layers import apply_rotary, init_device, init_linear, linear, \
    rmsnorm, rotary_cos_sin

__all__ = [
    "chunked_attention",
    "init_gqa",
    "gqa_train",
    "GQACache",
    "gqa_attend_step",
    "init_gqa_cache",
    "gqa_decode",
    "init_mla",
    "mla_train",
    "MLACache",
    "mla_attend_step",
    "init_mla_cache",
    "mla_decode",
    "init_cross_attention",
    "cross_attention",
    "cross_attend_step",
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


def _segment_positions(S: int, device, positions: Optional[torch.Tensor],
                       seq_axis: Optional[MeshAxis]) -> torch.Tensor:
    """The global positions of a rank's S queries: 0..S-1, offset by the
    segment's first position on a ``seq_axis`` (given ``positions`` as
    they are)."""
    if positions is not None:
        return positions
    pos = torch.arange(S, device=device)
    return pos if seq_axis is None else pos + seq_axis.rank * S


def _kv_whole(kv: Dict[str, torch.Tensor], s: int,
              seq_axis: Optional[MeshAxis]):
    """Keys and values (the sequence on dim 1) of the whole sequence: a
    rank's segments gathered over ``seq_axis`` in rank order (the
    backward reduce-scatters their cotangents). Returns ``(kv, S_kv)``."""
    if seq_axis is None:
        return kv, s
    return ({k: all_gather(v, seq_axis, dim=1) for k, v in kv.items()},
            s * seq_axis.size)


def gqa_train(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
              rope_theta: float = 10000.0, window: Optional[int] = None,
              kv_chunk: int = 1024,
              positions: Optional[torch.Tensor] = None,
              seq_axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Full-sequence causal attention, (B, S, d) -> (B, S, d). With a
    ``seq_axis`` x is this rank's contiguous segment of the sequence:
    the queries stay the rank's, at their global positions, and K and V
    are gathered over the axis after RoPE, so the causal and window mask
    compares global positions (a window reaches into earlier ranks'
    segments)."""
    B, S, _ = x.shape
    pos = _segment_positions(S, x.device, positions, seq_axis)
    q = linear(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = linear(p["wk"], x).reshape(B, S, n_kv, head_dim)
    v = linear(p["wv"], x).reshape(B, S, n_kv, head_dim)
    cos, sin = rotary_cos_sin(pos, head_dim, rope_theta)
    q = apply_rotary(q, cos[None], sin[None]) * (head_dim ** -0.5)
    k = apply_rotary(k, cos[None], sin[None])
    kv, s_kv = _kv_whole({"k": k, "v": v}, S, seq_axis)
    out = chunked_attention(
        q, kv, s_kv,
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator, d_model: int, n_heads: int, *, kv_lora: int = 512,
             q_lora: int = 1536, qk_nope: int = 128, qk_rope: int = 64,
             v_head: int = 128, dtype=torch.float32, device=None,
             lead=()) -> Dict[str, Any]:
    kw = dict(dtype=dtype, device=device, lead=lead)
    out_std = 0.02 / (2.0 ** 0.5)
    dev = init_device(device)
    return {
        "wq_down": init_linear(generator, d_model, q_lora, **kw),
        "q_norm": torch.ones(lead + (q_lora,), dtype=dtype, device=dev),
        "wq_up": init_linear(generator, q_lora,
                             n_heads * (qk_nope + qk_rope), **kw),
        "wkv_down": init_linear(generator, d_model, kv_lora + qk_rope, **kw),
        "kv_norm": torch.ones(lead + (kv_lora,), dtype=dtype, device=dev),
        "wk_up": init_linear(generator, kv_lora, n_heads * qk_nope, **kw),
        "wv_up": init_linear(generator, kv_lora, n_heads * v_head, **kw),
        "wo": init_linear(generator, n_heads * v_head, d_model,
                          std=out_std, **kw),
    }


def _mla_qkr(p, x: torch.Tensor, *, n_heads: int, qk_nope: int,
             qk_rope: int, pos: torch.Tensor, rope_theta: float):
    """The queries: ``q_nope`` (B, S, H, nope) and the rotated ``q_rope``
    (B, S, H, rope)."""
    B, S, _ = x.shape
    qc = rmsnorm(linear(p["wq_down"], x), p["q_norm"])
    q = linear(p["wq_up"], qc).reshape(B, S, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    cos, sin = rotary_cos_sin(pos, qk_rope, rope_theta)
    return q_nope, apply_rotary(q_rope, cos[None], sin[None])


def _mla_latents(p, x: torch.Tensor, *, kv_lora: int, qk_rope: int,
                 pos: torch.Tensor, rope_theta: float):
    """The compressed cache entries of x (B, S, d): the normed latents
    (B, S, kv_lora) and the rotated shared rope key (B, S, rope)."""
    kvd = linear(p["wkv_down"], x)
    c_kv = rmsnorm(kvd[..., :kv_lora], p["kv_norm"])
    cos, sin = rotary_cos_sin(pos, qk_rope, rope_theta)
    k_rope = apply_rotary(kvd[..., kv_lora:][:, :, None, :], cos[None],
                          sin[None])[:, :, 0, :]
    return c_kv, k_rope


def mla_train(p, x: torch.Tensor, *, n_heads: int, kv_lora: int = 512,
              qk_nope: int = 128, qk_rope: int = 64, v_head: int = 128,
              rope_theta: float = 10000.0, kv_chunk: int = 1024,
              positions: Optional[torch.Tensor] = None,
              seq_axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Full-sequence causal MLA, (B, S, d) -> (B, S, d), K and V
    decompressed one KV chunk at a time. With a ``seq_axis`` x is this
    rank's segment, as in :func:`gqa_train`: the compressed latents and
    rope keys are gathered over the axis before the up-projection."""
    # the streaming accumulator is shaped from q, and q here is q_nope, so
    # the value head must be as wide (true of DeepSeek-V2 / V3: 128)
    assert qk_nope == v_head, "mla_train requires qk_nope == v_head"
    B, S, _ = x.shape
    pos = _segment_positions(S, x.device, positions, seq_axis)
    scale = (qk_nope + qk_rope) ** -0.5
    q_nope, q_rope = _mla_qkr(p, x, n_heads=n_heads, qk_nope=qk_nope,
                              qk_rope=qk_rope, pos=pos,
                              rope_theta=rope_theta)
    c_kv, k_rope = _mla_latents(p, x, kv_lora=kv_lora, qk_rope=qk_rope,
                                pos=pos, rope_theta=rope_theta)
    wk, wv = p["wk_up"]["w"], p["wv_up"]["w"]

    def score_fn(q, kv_c):
        k_nope = (kv_c["c"] @ wk.to(kv_c["c"].dtype)).reshape(
            B, -1, n_heads, qk_nope)
        s = torch.einsum("bqhd,bshd->bhqs", q, k_nope)
        s = s + torch.einsum("bqhr,bsr->bhqs", q_rope, kv_c["r"])
        return s * scale

    def value_fn(pr, kv_c):
        v = (kv_c["c"] @ wv.to(kv_c["c"].dtype)).reshape(
            B, -1, n_heads, v_head)
        return torch.einsum("bhqs,bshd->bqhd", pr, v.float())

    kv, s_kv = _kv_whole({"c": c_kv, "r": k_rope}, S, seq_axis)
    out = chunked_attention(q_nope, kv, s_kv,
                            score_fn=score_fn, value_fn=value_fn,
                            mask_fn=_causal_window_mask(pos, None),
                            kv_chunk=kv_chunk)
    return linear(p["wo"], out.reshape(B, S, n_heads * v_head).to(x.dtype))


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # ([L,] B, S_max, kv_lora) compressed latents
    k_rope: torch.Tensor     # ([L,] B, S_max, qk_rope)
    length: torch.Tensor     # ([L,]) int64: tokens decoded so far


def _absorbed_query(p, x, pos, *, n_heads, kv_lora, qk_nope, qk_rope,
                    rope_theta):
    """One token's query in the latent space: ``q_c`` (B, 1, H, kv_lora)
    and ``q_rope`` (B, 1, H, rope)."""
    q_nope, q_rope = _mla_qkr(p, x, n_heads=n_heads, qk_nope=qk_nope,
                              qk_rope=qk_rope, pos=pos[None],
                              rope_theta=rope_theta)
    wk = p["wk_up"]["w"].reshape(kv_lora, n_heads, qk_nope)
    return torch.einsum("bqhd,chd->bqhc", q_nope, wk.to(q_nope.dtype)), \
        q_rope


def _absorbed_out(p, ctx_c: torch.Tensor, x: torch.Tensor, *, n_heads,
                  kv_lora, v_head) -> torch.Tensor:
    """The context (B, 1, H, kv_lora) decompressed by ``wv_up`` and
    projected by ``wo``: (B, 1, d)."""
    B = x.shape[0]
    wv = p["wv_up"]["w"].reshape(kv_lora, n_heads, v_head)
    out = torch.einsum("bqhc,chd->bqhd", ctx_c, wv.to(ctx_c.dtype))
    return linear(p["wo"], out.reshape(B, 1, n_heads * v_head).to(x.dtype))


def mla_attend_step(p, x: torch.Tensor, c_cache: torch.Tensor,
                    r_cache: torch.Tensor, length: torch.Tensor, *,
                    n_heads: int, kv_lora: int = 512, qk_nope: int = 128,
                    qk_rope: int = 64, v_head: int = 128,
                    rope_theta: float = 10000.0):
    """Absorbed MLA decode over a READ-ONLY compressed cache: x (B, 1, d).
    The slots before ``length`` are attended and the new token as an
    explicit self term. Returns ``(out, c_new (B, kv_lora), r_new (B,
    qk_rope))``; the caller writes the new slot once per step."""
    pos = length
    scale = (qk_nope + qk_rope) ** -0.5
    q_c, q_rope = _absorbed_query(p, x, pos, n_heads=n_heads,
                                  kv_lora=kv_lora, qk_nope=qk_nope,
                                  qk_rope=qk_rope, rope_theta=rope_theta)
    c_new, r_new = _mla_latents(p, x, kv_lora=kv_lora, qk_rope=qk_rope,
                                pos=pos[None], rope_theta=rope_theta)
    c_new, r_new = c_new[:, 0], r_new[:, 0]
    s = torch.einsum("bqhc,bsc->bhqs", q_c, c_cache)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope, r_cache)
    s = s.float() * scale
    valid = torch.arange(c_cache.shape[1], device=x.device) < pos
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    s_self = (torch.einsum("bqhc,bc->bhq", q_c, c_new.to(q_c.dtype))
              + torch.einsum("bqhr,br->bhq", q_rope, r_new.to(q_rope.dtype))
              ).float()[..., None] * scale
    pr = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1).to(
        c_cache.dtype)
    ctx_c = torch.einsum("bhqs,bsc->bqhc", pr[..., :-1], c_cache)
    ctx_c = ctx_c + torch.einsum("bhq,bc->bqhc", pr[..., -1], c_new)
    out = _absorbed_out(p, ctx_c, x, n_heads=n_heads, kv_lora=kv_lora,
                        v_head=v_head)
    return out, c_new.to(c_cache.dtype), r_new.to(r_cache.dtype)


def init_mla_cache(batch: int, s_max: int, *, kv_lora: int = 512,
                   qk_rope: int = 64, dtype=torch.float32,
                   device=None) -> MLACache:
    return MLACache(
        torch.zeros((batch, s_max, kv_lora), dtype=dtype, device=device),
        torch.zeros((batch, s_max, qk_rope), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int64, device=device))


def mla_decode(p, x: torch.Tensor, cache: MLACache, *, n_heads: int,
               kv_lora: int = 512, qk_nope: int = 128, qk_rope: int = 64,
               v_head: int = 128, rope_theta: float = 10000.0):
    """Absorbed single-token decode of one layer that writes its own
    cache: x (B, 1, d). Returns ``(out, new cache)``; the given cache is
    left as it was."""
    pos = cache.length
    scale = (qk_nope + qk_rope) ** -0.5
    q_c, q_rope = _absorbed_query(p, x, pos, n_heads=n_heads,
                                  kv_lora=kv_lora, qk_nope=qk_nope,
                                  qk_rope=qk_rope, rope_theta=rope_theta)
    c_new, r_new = _mla_latents(p, x, kv_lora=kv_lora, qk_rope=qk_rope,
                                pos=pos[None], rope_theta=rope_theta)
    slot = pos.reshape(1)
    c_all = cache.c_kv.index_copy(1, slot, c_new.to(cache.c_kv.dtype))
    r_all = cache.k_rope.index_copy(1, slot, r_new.to(cache.k_rope.dtype))
    s = torch.einsum("bqhc,bsc->bhqs", q_c, c_all)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope, r_all)
    s = s.float() * scale
    valid = torch.arange(c_all.shape[1], device=x.device) <= pos
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    pr = torch.softmax(s, dim=-1).to(c_all.dtype)
    ctx_c = torch.einsum("bhqs,bsc->bqhc", pr, c_all)
    out = _absorbed_out(p, ctx_c, x, n_heads=n_heads, kv_lora=kv_lora,
                        v_head=v_head)
    return out, MLACache(c_all, r_all, pos + 1)


# ---------------------------------------------------------------------------
# Cross-attention (the encoder-decoder family)
# ---------------------------------------------------------------------------


def init_cross_attention(generator, d_model: int, n_heads: int,
                         head_dim: int, *, dtype=torch.float32, device=None,
                         lead=()) -> Dict[str, Dict[str, torch.Tensor]]:
    """A GQA parameter set with as many K/V heads as query heads."""
    return init_gqa(generator, d_model, n_heads, n_heads, head_dim,
                    dtype=dtype, device=device, lead=lead)


def cross_attention(p, x: torch.Tensor, enc: torch.Tensor, *, n_heads: int,
                    head_dim: int, kv_chunk: int = 1024,
                    seq_axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Decoder states x (B, S, d) attend over encoder states enc (B, T, d):
    q from x, k and v from enc, no rotation, no mask. (B, S, d). With a
    ``seq_axis`` enc is this rank's segment of the encoder's sequence and
    its K and V are gathered over the axis."""
    B, S, _ = x.shape
    T = enc.shape[1]
    q = linear(p["wq"], x).reshape(B, S, n_heads, head_dim) * (
        head_dim ** -0.5)
    k = linear(p["wk"], enc).reshape(B, T, n_heads, head_dim)
    v = linear(p["wv"], enc).reshape(B, T, n_heads, head_dim)
    kv, T = _kv_whole({"k": k, "v": v}, T, seq_axis)
    out = chunked_attention(
        q, kv, T,
        score_fn=_gqa_score_fn(n_heads), value_fn=_gqa_value_fn(n_heads),
        mask_fn=lambda pos_k: torch.ones((1, 1, S, pos_k.shape[0]),
                                         dtype=torch.bool,
                                         device=pos_k.device),
        kv_chunk=kv_chunk)
    return linear(p["wo"], out.reshape(B, S, n_heads * head_dim).to(x.dtype))


def cross_attend_step(p, x: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, n_heads: int,
                      head_dim: int) -> torch.Tensor:
    """One decoder token x (B, 1, d) over cached encoder keys and values
    k, v (B, T, H, D), unchunked: the scores in the promoted dtype of q
    and k, then float32, the softmax and the values in float32, cast back
    before ``wo``. (B, 1, d)."""
    B = x.shape[0]
    q = linear(p["wq"], x).reshape(B, 1, n_heads, head_dim) * (
        head_dim ** -0.5)
    dt = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bqhd,bshd->bhqs", q.to(dt), k.to(dt)).float()
    o = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, dim=-1), v.float())
    return linear(p["wo"], o.reshape(B, 1, n_heads * head_dim).to(x.dtype))
