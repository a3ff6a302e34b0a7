"""The persistent Sinkhorn megakernels: wrappers of ``csrc/fused_loop.cu``.

:func:`sinkhorn_block` advances the scaling plan's carry
``(u, v, s = Zeta (Xi^T u))`` and :func:`log_sinkhorn_block` the log
plan's carry ``(f, g, t = LSE_i(log_xi + f/eps))`` by ``inner_steps`` full
iterations in one launch; each returns the marginal error at the block
end, the only scalar a block hands back. Each CUDA kernel is one CTA that
holds both factors in shared memory for the whole block, so the plans take
them only where :func:`block_plan_fits` admits the shape, under the JAX
package's 192 KiB GPU budget; larger shapes run the streaming
per-iteration plan. A shape the budget admits but whose shared-memory
layout does not fit one CTA raises. Counterpart of
``repro.kernels.fused_loop``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .backend import MEGAKERNEL_BUDGET, check_operand
from .ref import log_sinkhorn_block_ref, sinkhorn_block_ref

__all__ = [
    "block_vmem_bytes",
    "block_plan_fits",
    "smem_bytes",
    "sinkhorn_block",
    "log_sinkhorn_block",
]

_SUBLANE_ANY = 16               # the JAX package's row quantum (f32 and bf16)
_LANE = 128                     # its feature (minor) axis quantum
_MAX_SMEM = 232448              # dynamic shared memory of one H100 CTA


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def block_vmem_bytes(n: int, m: int, r: int, B: int = 1,
                     feature_dtype: torch.dtype = torch.float32) -> int:
    """Working-set bytes of one megakernel launch, counted as the JAX
    package counts them (padded shapes): the factors at their storage
    width plus the float32 carries and intermediates."""
    np_, mp = _round_up(n, _SUBLANE_ANY), _round_up(m, _SUBLANE_ANY)
    rp = _round_up(r, _LANE)
    fbytes = torch.finfo(feature_dtype).bits // 8
    factors = (np_ + mp) * rp * fbytes
    vectors = (3 * np_ + 4 * mp + 2 * rp) * B * 4
    return factors + vectors


def block_plan_fits(n: int, m: int, r: int, B: int = 1,
                    feature_dtype: torch.dtype = torch.float32) -> bool:
    """Whether the megakernel is admitted at this shape: the JAX package's
    ``block_plan_fits`` on its gpu-triton backend, on both devices."""
    return block_vmem_bytes(n, m, r, B, feature_dtype) <= MEGAKERNEL_BUDGET


def smem_bytes(n: int, m: int, r: int, feature_dtype: torch.dtype, *,
               mode: str = "log") -> int:
    """Dynamic shared memory one CUDA launch of the ``mode`` ("scaling" or
    "log") megakernel takes (the kernel's layout); it stays under
    :data:`_MAX_SMEM` wherever :func:`block_plan_fits` admits the shape."""
    fn = {"log": _lib().log_sinkhorn_block_smem_bytes,
          "scaling": _lib().sinkhorn_block_smem_bytes}[mode]
    return int(fn(n, m, r, int(feature_dtype == torch.bfloat16)))


@functools.cache
def _lib():
    lib = build.load("fused_loop")
    for name in ("log_sinkhorn_block_smem_bytes",
                 "sinkhorn_block_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
        getattr(lib, name).restype = ctypes.c_longlong
    fn = lib.log_sinkhorn_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sinkhorn_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_block_shape(what, n, m, r, dtype, mode):
    smem = smem_bytes(n, m, r, dtype, mode=mode)
    if min(n, m, r) < 1 or smem > _MAX_SMEM:
        raise ValueError(
            f"{what} kernel takes n, m, r >= 1 within {_MAX_SMEM} bytes of "
            f"shared memory; got n={n}, m={m}, r={r} ({dtype}), {smem} bytes")


def sinkhorn_block(xi: torch.Tensor, zeta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                   s0: torch.Tensor, *, inner_steps: int,
                   momentum: float = 1.0):
    """``inner_steps`` scaling-space iterations: ``(u, v, s, err)``.

    ``xi`` (n, r) and ``zeta`` (m, r) are float32 or bfloat16; ``a``/``u0``
    (n, B) and ``b``/``v0``/``s0`` (m, B) float32 (a zero weight marks a
    dead atom). On a CUDA tensor this launches the kernel, which takes
    B = 1; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.sinkhorn_block_ref` (any B). ``err``
    is a 0-d tensor."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(zeta, "zeta", 2, dev, factor=True)
    for name, t in (("a", a), ("b", b), ("u0", u0), ("v0", v0), ("s0", s0)):
        check_operand(t, name, 2, dev)
    n, r = xi.shape
    m = zeta.shape[0]
    B = a.shape[1]
    if (zeta.dtype != xi.dtype or zeta.shape[1] != r
            or any(tuple(w.shape) != (n, B) for w in (a, u0))
            or any(tuple(w.shape) != (m, B) for w in (b, v0, s0))):
        raise ValueError(
            f"shape mismatch: xi {tuple(xi.shape)} {xi.dtype}, zeta "
            f"{tuple(zeta.shape)} {zeta.dtype}, a {tuple(a.shape)}, b "
            f"{tuple(b.shape)}, u0 {tuple(u0.shape)}, v0 {tuple(v0.shape)}, "
            f"s0 {tuple(s0.shape)}")
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if dev.type == "cpu":
        return sinkhorn_block_ref(xi, zeta, a, b, u0, v0, s0,
                                  inner_steps=inner_steps, momentum=momentum)
    if B != 1:
        raise ValueError(f"sinkhorn_block kernel takes B = 1 column, got {B}")
    _check_block_shape("sinkhorn_block", n, m, r, xi.dtype, "scaling")
    u = torch.empty((n, 1), dtype=torch.float32, device=dev)
    v = torch.empty((m, 1), dtype=torch.float32, device=dev)
    s = torch.empty((m, 1), dtype=torch.float32, device=dev)
    err = torch.empty((1,), dtype=torch.float32, device=dev)
    mom = float(momentum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sinkhorn_block_launch(
            xi.data_ptr(), zeta.data_ptr(), int(xi.dtype == torch.bfloat16),
            a.data_ptr(), b.data_ptr(), u0.data_ptr(), v0.data_ptr(),
            s0.data_ptr(), u.data_ptr(), v.data_ptr(), s.data_ptr(),
            err.data_ptr(), n, m, r, int(inner_steps), mom, 1.0 - mom,
            int(mom != 1.0), stream)
    build.check_launch(_lib(), code, "sinkhorn_block")
    sinkhorn_block.launches += 1
    return u, v, s, err[0]


def log_sinkhorn_block(log_xi: torch.Tensor, log_zeta: torch.Tensor,
                       loga: torch.Tensor, logb: torch.Tensor,
                       b: torch.Tensor, f0: torch.Tensor, g0: torch.Tensor,
                       t0: torch.Tensor, *, inner_steps: int, eps: float,
                       momentum: float = 1.0):
    """``inner_steps`` log-domain iterations: ``(f, g, t, err)``.

    ``log_xi`` (n, r) and ``log_zeta`` (m, r) are float32 or bfloat16;
    ``loga``/``f0`` (n, B), ``logb``/``b``/``g0`` (m, B) and ``t0`` (r, B)
    float32 (``-inf`` marks a dead atom). On a CUDA tensor this launches
    the kernel, which takes B = 1; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_sinkhorn_block_ref` (any B).
    ``err`` is a 0-d tensor."""
    dev = log_xi.device
    check_operand(log_xi, "log_xi", 2, dev, factor=True)
    check_operand(log_zeta, "log_zeta", 2, dev, factor=True)
    for name, t in (("loga", loga), ("logb", logb), ("b", b), ("f0", f0),
                    ("g0", g0), ("t0", t0)):
        check_operand(t, name, 2, dev)
    n, r = log_xi.shape
    m = log_zeta.shape[0]
    B = loga.shape[1]
    if (log_zeta.dtype != log_xi.dtype or log_zeta.shape[1] != r
            or tuple(f0.shape) != (n, B) or tuple(loga.shape) != (n, B)
            or any(tuple(v.shape) != (m, B) for v in (logb, b, g0))
            or tuple(t0.shape) != (r, B)):
        raise ValueError(
            f"shape mismatch: log_xi {tuple(log_xi.shape)} {log_xi.dtype}, "
            f"log_zeta {tuple(log_zeta.shape)} {log_zeta.dtype}, loga "
            f"{tuple(loga.shape)}, logb {tuple(logb.shape)}, b "
            f"{tuple(b.shape)}, f0 {tuple(f0.shape)}, g0 {tuple(g0.shape)}, "
            f"t0 {tuple(t0.shape)}")
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if dev.type == "cpu":
        return log_sinkhorn_block_ref(log_xi, log_zeta, loga, logb, b, f0, g0,
                                      t0, inner_steps=inner_steps, eps=eps,
                                      momentum=momentum)
    if B != 1:
        raise ValueError(f"log_sinkhorn_block kernel takes B = 1 column, "
                         f"got {B}")
    _check_block_shape("log_sinkhorn_block", n, m, r, log_xi.dtype, "log")
    f = torch.empty((n, 1), dtype=torch.float32, device=dev)
    g = torch.empty((m, 1), dtype=torch.float32, device=dev)
    t = torch.empty((r, 1), dtype=torch.float32, device=dev)
    err = torch.empty((1,), dtype=torch.float32, device=dev)
    mom = float(momentum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_sinkhorn_block_launch(
            log_xi.data_ptr(), log_zeta.data_ptr(),
            int(log_xi.dtype == torch.bfloat16), loga.data_ptr(),
            logb.data_ptr(), b.data_ptr(), f0.data_ptr(), g0.data_ptr(),
            t0.data_ptr(), f.data_ptr(), g.data_ptr(), t.data_ptr(),
            err.data_ptr(), n, m, r, int(inner_steps), float(eps), mom,
            1.0 - mom, int(mom != 1.0), stream)
    build.check_launch(_lib(), code, "log_sinkhorn_block")
    log_sinkhorn_block.launches += 1
    return f, g, t, err[0]


sinkhorn_block.launches = 0
log_sinkhorn_block.launches = 0
