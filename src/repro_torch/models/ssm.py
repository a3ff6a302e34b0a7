"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060.

Training runs the chunked SSD: the sequence is cut into chunks of ``Q``
tokens; within a chunk the quadratic, attention-like form runs as batched
matrix products under the ``exp(segsum)`` decay mask, and across chunks a
linear recurrence carries the (H, P, N) chunk states (a Python loop over
the chunks, differentiated by autograd). Decode is the O(1) recurrent
update of a persistent state, which is why the ssm and hybrid families
are the ones that run the ``long_500k`` cell.

Shapes: x (B, S, H*P) with head dim P, state dim N, and one B / C pair
shared by every head (n_groups = 1). The JAX package computes the SSD in
XLA (no Pallas kernel), so plain PyTorch is the port; its three-operand
einsums are written as pairwise products in a fixed order, so no
contraction path can build a (B, C, Q, K, H, P) temporary.

Under a mesh context that splits the sequence over ``"model"``
(``distributed.seq_axis``) a rank holds the contiguous S / tp segment of
its rows: :func:`mamba2_train`'s causal conv takes a halo, the previous
rank's last ``conv_kernel - 1`` conv inputs (zeros on rank 0), and
:func:`ssd_context_parallel` runs the reference's context parallelism on
the segment and returns it. Counterpart of ``repro.models.ssm``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import MeshAxis, all_gather, \
    current_mesh_context, from_previous, seq_axis
from .layers import init_device, init_linear, linear, rmsnorm, trunc_normal

__all__ = [
    "init_mamba2",
    "mamba2_train",
    "mamba2_decode",
    "init_mamba2_cache",
    "Mamba2Cache",
    "ssd_chunked",
    "ssd_context_parallel",
]

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum_{k=j+1..i} x[k] (-inf above the diagonal). The
    reference's formula, ``cs_i - cs_j`` under the mask, kept as it is."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """x (B, S, H, P), dt (B, S, H) positive steps, A (H,) negative decay
    rates, Bm / Cm (B, S, N), init_state (B, H, P, N) or None. Returns
    ``(y (B, S, H, P), final state (B, H, P, N))``; S is padded to a
    multiple of ``chunk`` and the padding dropped from y.

    The largest temporaries are the decay mask L and the masked scores,
    (B, H, C, Q, Q) each: 67 MB in float32 at mamba2-1.3b's width (H = 64,
    Q = 128) and a batch of 8 x 256; the rest are the size of x (B, C, Q,
    H, P) or of the chunk states (B, C, H, P, N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nC = (S + pad) // chunk
    xb = x.reshape(Bsz, nC, chunk, H, P)
    dtb = dt.reshape(Bsz, nC, chunk, H)
    Bb = Bm.reshape(Bsz, nC, chunk, N)
    Cb = Cm.reshape(Bsz, nC, chunk, N)

    dA = (dtb * A[None, None, None, :]).permute(0, 3, 1, 2)   # (B,H,C,Q) <= 0
    dA_cs = torch.cumsum(dA, dim=-1)                          # within a chunk

    # intra-chunk: y_diag[b,c,q,h] = sum_k scores[b,c,q,k] L[b,h,c,q,k]
    # xdt[b,c,k,h]
    L = torch.exp(_segsum(dA))                                # (B,H,C,Q,Q)
    scores = Cb @ Bb.transpose(-1, -2)                        # (B,C,Q,Q)
    xdt = xb * dtb[..., None]                                 # (B,C,Q,H,P)
    masked = (L * scores[:, None]).transpose(1, 2)            # (B,C,H,Q,Q)
    y_diag = (masked @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: states[b,c,h,p,n] = sum_k xdt[b,c,k,h,p]
    # decay[b,h,c,k] Bb[b,c,k,n]
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (B,H,C,Q)
    xw = xdt * decay_states.permute(0, 2, 3, 1)[..., None]    # (B,C,Q,H,P)
    states = xw.permute(0, 1, 3, 4, 2) @ Bb[:, :, None]       # (B,C,H,P,N)

    # inter-chunk recurrence; each chunk reads the state before it
    chunk_decay = torch.exp(dA_cs[..., -1])                   # (B,H,C)
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device) \
        if init_state is None else init_state.to(x.dtype)
    prev = []
    for c in range(nC):
        prev.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,C,H,P,N)

    # inter-chunk output: y_off[b,c,q,h,p] = sum_n Cb[b,c,q,n]
    # exp(dA_cs)[b,h,c,q] prev[b,c,h,p,n]
    y_off = Cb[:, :, None] @ prev_states.transpose(-1, -2)    # (B,C,H,Q,P)
    y_off = y_off * torch.exp(dA_cs).permute(0, 2, 1, 3)[..., None]
    y = y_diag + y_off.permute(0, 1, 3, 2, 4)
    return y.reshape(Bsz, nC * chunk, H, P)[:, :S], h


def ssd_context_parallel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         chunk: int = 128) -> torch.Tensor:
    """The SSD as the training path calls it: the plain chunked SSD
    without a mesh context (or one whose ``"model"`` axis is absent or of
    one rank), else the sequence's context parallelism over the
    ``"model"`` ranks, whose context must split the sequence
    (``distributed.seq_axis``): x, dt, Bm and Cm are this rank's
    contiguous S / p segment. Each rank runs the chunked SSD on its
    segment from a zero state; the ranks gather each segment's final (B,
    H, P, N) state and (B, H) decay; the scan of ``(d, h) -> (d1 d2, h1
    d2 + h2)`` over the ranks before this one gives its inbound state; a
    linear correction ``C exp(cumsum dA) h_in`` adds it. Returns the
    segment's (B, S / p, H, P)."""
    ctx = current_mesh_context()
    if ctx is None or ctx.tp_axis is None or ctx.size(ctx.tp_axis) == 1:
        y, _ = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        return y
    tp = seq_axis(ctx)
    if tp is None:
        raise ValueError(f"the SSD over {ctx.size(ctx.tp_axis)} 'model' "
                         "ranks takes a sequence split over them")
    y0, h_loc = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    dacs = torch.cumsum(dt * A[None, None, :], dim=1)        # (B, S_l, H)
    seg_decay = torch.exp(dacs[:, -1, :])                      # (B, H)
    hs = all_gather(h_loc[None], tp, dim=0)                    # (R,B,H,P,N)
    ds = all_gather(seg_decay[None], tp, dim=0)                # (R, B, H)
    # the inbound states of every rank (the ranks before it, combined in
    # order), then this rank's: every rank builds the same graph on the
    # gathered tensors, so their backwards' collectives pair up
    prefix = [torch.zeros_like(h_loc)]
    for r in range(tp.size - 1):
        prefix.append(prefix[-1] * ds[r][..., None, None] + hs[r])
    init = torch.stack(prefix)[tp.rank]
    # y_corr[b,s,h,p] = sum_n C[b,s,n] exp(dacs)[b,s,h] init[b,h,p,n]
    y_corr = Cm[:, None] @ init.to(x.dtype).transpose(-1, -2)  # (B,H,S,P)
    y_corr = y_corr * torch.exp(dacs).transpose(1, 2)[..., None]
    return y0 + y_corr.transpose(1, 2).to(y0.dtype)


def init_mamba2(generator, d_model: int, *, d_state: int = 128,
                head_dim: int = 64, expand: int = 2, conv_kernel: int = 4,
                dtype=torch.float32, device=None, lead=()):
    """One mixer's parameters (``lead``: the stacked layers' axes)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    dev = init_device(device)
    kw = dict(dtype=dtype, device=device, lead=lead)
    out_std = 0.02 / (2.0 ** 0.5)

    def const(values):
        return values.to(dtype).expand(lead + values.shape).to(dev).clone()

    return {
        # order: [z (gate), x, B, C, dt]
        "in_proj": init_linear(generator, d_model,
                               2 * d_inner + 2 * d_state + n_heads, **kw),
        "conv_w": trunc_normal(lead + (conv_kernel, conv_dim), 0.1,
                               generator=generator, dtype=dtype, device=dev),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                                dtype=torch.float32))),
        "dt_bias": torch.zeros(lead + (n_heads,), dtype=dtype, device=dev),
        "D": torch.ones(lead + (n_heads,), dtype=dtype, device=dev),
        "norm_w": torch.ones(lead + (d_inner,), dtype=dtype, device=dev),
        "out_proj": init_linear(generator, d_inner, d_model, std=out_std,
                                **kw),
    }


def _conv_sum(windows, w: torch.Tensor) -> torch.Tensor:
    """sum_k windows[k] * w[k], in the reference's order (k = 0 first)."""
    return sum(win * w[k] for k, win in enumerate(windows))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU: x (B, S, C), w
    (K, C); the sum of K shifted products, as the reference sums it. The
    K - 1 inputs before x are ``halo`` (B, K - 1, C), zeros without one."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)) if halo is None else \
        torch.cat([halo, x], dim=1)
    out = _conv_sum([xp[:, k:k + S] for k in range(K)], w)
    return F.silu(out + b)


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int):
    """The in-projection's five parts: z, x, B, C, dt."""
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state,
                                zxbcdt.shape[-1] - 2 * (d_inner + d_state)],
                       dim=-1)


def ssd_inputs(p, x: torch.Tensor, *, d_state: int = 128,
               head_dim: int = 64, expand: int = 2,
               seq_axis: Optional[MeshAxis] = None):
    """The mixer up to the SSD: x (B, S, d_model) -> (z (B, S, d_inner),
    xh (B, S, H, P), dt (B, S, H), A (H,) float32, Bm, Cm (B, S, N)).
    With a ``seq_axis`` x is this rank's segment and the conv's halo comes
    from the previous rank."""
    B, S, d_model = x.shape
    d_inner = expand * d_model
    z, xr, Bm, Cm, dt = _split_proj(linear(p["in_proj"], x), d_inner,
                                    d_state)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    halo = None if seq_axis is None else from_previous(
        conv_in, seq_axis, p["conv_w"].shape[0] - 1, dim=1)
    conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], halo)
    xr, Bm, Cm = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return z, xr.reshape(B, S, d_inner // head_dim, head_dim), dt, A, Bm, Cm


def _mixer_out(p, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The skip term, the gated norm and the out-projection: y and xh
    (B, S, H, P), z (B, S, d_inner) -> (B, S, d_model)."""
    y = y + p["D"][:, None] * xh
    y = y.reshape(z.shape)
    return linear(p["out_proj"], rmsnorm(y * F.silu(z), p["norm_w"]))


def mamba2_train(p, x: torch.Tensor, *, d_state: int = 128,
                 head_dim: int = 64, expand: int = 2,
                 chunk: int = 128) -> torch.Tensor:
    """The full mixer over a sequence: x (B, S, d_model) -> (B, S,
    d_model); under a context that splits the sequence, over this rank's
    segment of it."""
    z, xh, dt, A, Bm, Cm = ssd_inputs(p, x, d_state=d_state,
                                      head_dim=head_dim, expand=expand,
                                      seq_axis=seq_axis())
    y = ssd_context_parallel(xh, dt, A, Bm, Cm, chunk=chunk)
    return _mixer_out(p, y, xh, z)


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor       # ([L,] B, K - 1, conv_dim) the last conv inputs
    state: torch.Tensor      # ([L,] B, H, P, N) the SSM state
    length: torch.Tensor     # ([L,]) int64: tokens decoded so far


def init_mamba2_cache(batch: int, d_model: int, *, d_state: int = 128,
                      head_dim: int = 64, expand: int = 2,
                      conv_kernel: int = 4, dtype=torch.float32,
                      device=None) -> Mamba2Cache:
    d_inner = expand * d_model
    conv_dim = d_inner + 2 * d_state
    dev = init_device(device)
    return Mamba2Cache(
        torch.zeros((batch, conv_kernel - 1, conv_dim), dtype=dtype,
                    device=dev),
        torch.zeros((batch, d_inner // head_dim, head_dim, d_state),
                    dtype=dtype, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev))


def mamba2_decode(p, x: torch.Tensor, cache: Mamba2Cache, *,
                  d_state: int = 128, head_dim: int = 64, expand: int = 2):
    """The O(1) single-token update: x (B, 1, d_model). Returns ``(out,
    new cache)``: the conv history shifted by one and the new state (in
    the cache's dtype), new tensors; the given cache is left as it was."""
    B, _, d_model = x.shape
    d_inner = expand * d_model
    z, xr, Bm, Cm, dt = _split_proj(linear(p["in_proj"], x), d_inner,
                                    d_state)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)                 # (B, 1, C)
    hist = torch.cat([cache.conv, conv_in], dim=1)            # (B, K, C)
    w = p["conv_w"]
    conv = F.silu(_conv_sum([hist[:, k] for k in range(w.shape[0])], w)
                  + p["conv_b"])
    xr, Bv, Cv = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    dtv = F.softplus(dt[:, 0] + p["dt_bias"])                 # (B, H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dtv * A)                                # (B, H)
    xh = xr.reshape(B, d_inner // head_dim, head_dim)         # (B, H, P)
    upd = (xh * dtv[..., None])[..., None] * Bv[:, None, None, :]
    state = cache.state * decay[..., None, None] + upd         # (B, H, P, N)
    y = (state @ Cv[:, None, :, None])[..., 0]                # (B, H, P)
    out = _mixer_out(p, y[:, None], xh[:, None], z)
    return out, Mamba2Cache(hist[:, 1:], state.to(cache.state.dtype),
                            cache.length + 1)
