"""Shared neural building blocks, as plain functions on tensors.

Parameters are nested dicts of tensors, as the JAX package's pytrees are:
a linear layer is ``{"w": (d_in, d_out)[, "b": (d_out,)]}`` and computes
``x @ w + b`` (the JAX layout, not ``nn.Linear``'s transposed one). Every
``init_*`` takes ``lead``, the leading axes a layer group stacks its
layers on, and draws from a CPU ``torch.Generator`` before moving the
values to ``device``, so one seed gives the same weights on every device;
on the ``meta`` device nothing is drawn or allocated. Norms and rotary
embeddings compute in float32 and cast back. Counterpart of
``repro.models.layers``.

A generator on the card draws on the card instead, a slice of at most
``DRAW_SLICE`` elements at a time, so that a leaf of billions of elements
(a full-width expert stack) never holds more than a few GiB of float32
transients; the distributions are the same, the numbers another stream.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.backend import resolve_device

__all__ = [
    "init_device",
    "trunc_normal",
    "normal",
    "rmsnorm",
    "layernorm",
    "rotary_cos_sin",
    "apply_rotary",
    "init_linear",
    "linear",
    "init_mlp",
    "mlp",
    "init_embedding",
]

Shape = Tuple[int, ...]


def init_device(device=None) -> torch.device:
    """Where parameters are made: ``meta`` (shapes only) or what
    ``resolve_device`` gives (the card by default)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


DRAW_SLICE = 1 << 28     # elements a slice of a draw on the card


def _draw(shape: Shape, values, generator: Optional[torch.Generator],
          device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values(shape, gen_device)`` (float32 draws from ``generator``) in
    ``dtype`` on ``device``: whole on the host for a CPU generator, in
    slices of ``DRAW_SLICE`` elements for one on the card."""
    if generator is None or generator.device.type == "cpu":
        return values(shape, None).to(dtype).to(device)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_SLICE):
        n = min(DRAW_SLICE, flat.numel() - lo)
        flat[lo:lo + n] = values((n,), generator.device)
    return out.to(device)


def trunc_normal(shape: Shape, std: float = 0.02, *,
                 generator: Optional[torch.Generator],
                 dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2] (the JAX
    package's ``std * truncated_normal(-2, 2)``), by inverting the normal
    CDF on uniform draws in float32."""
    dev = init_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))

    def values(sh, where):
        u = lo + (1.0 - 2.0 * lo) * torch.rand(
            sh, generator=generator, dtype=torch.float32, device=where)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return std * torch.clamp(z, -2.0, 2.0)

    return _draw(tuple(shape), values, generator, dev, dtype)


def normal(shape: Shape, std: float = 1.0, *,
           generator: Optional[torch.Generator],
           dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``std`` times standard normal draws."""
    dev = init_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)

    def values(sh, where):
        return std * torch.randn(sh, generator=generator,
                                 dtype=torch.float32, device=where)

    return _draw(tuple(shape), values, generator, dev, dtype)


def _full(shape: Shape, value: float, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=init_device(device))


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * w.float()).to(dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(dtype)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   theta: float = 10000.0):
    """positions (...,) -> cos, sin (..., head_dim / 2), float32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """The half-split rotation: x (..., S, H, hd); cos / sin (..., S,
    hd / 2), broadcast over the heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def init_linear(generator, d_in: int, d_out: int, *, bias: bool = False,
                std: float = 0.02, dtype=torch.float32, device=None,
                lead: Shape = ()) -> Dict[str, torch.Tensor]:
    p = {"w": trunc_normal(lead + (d_in, d_out), std, generator=generator,
                           dtype=dtype, device=device)}
    if bias:
        p["b"] = _full(lead + (d_out,), 0.0, dtype, device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_mlp(generator, d_model: int, d_ff: int, *, gated: bool = True,
             bias: bool = False, dtype=torch.float32, device=None,
             lead: Shape = ()) -> Dict[str, Dict[str, torch.Tensor]]:
    kw = dict(bias=bias, dtype=dtype, device=device, lead=lead)
    out_std = 0.02 / (2.0 ** 0.5)
    p = {"up": init_linear(generator, d_model, d_ff, **kw)}
    if gated:
        p["gate"] = init_linear(generator, d_model, d_ff, **kw)
    p["down"] = init_linear(generator, d_ff, d_model, std=out_std, **kw)
    return p


def mlp(p, x: torch.Tensor, *, gated: bool = True) -> torch.Tensor:
    if gated:
        return linear(p["down"], F.silu(linear(p["gate"], x))
                      * linear(p["up"], x))
    return linear(p["down"], F.gelu(linear(p["up"], x), approximate="tanh"))


def init_embedding(generator, vocab: int, d_model: int, *,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {"table": trunc_normal((vocab, d_model), 0.02, generator=generator,
                                  dtype=dtype, device=device)}
