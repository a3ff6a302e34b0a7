"""Scaling-space Sinkhorn operators: wrappers of ``csrc/kermatvec.cu``.

One half-step ``v <- b / (Zeta (Xi^T u))`` splits into

* :func:`feature_contract` — ``t = Xi^T u``, (n, r), (n, B) -> (r, B), a
  reduction over n. On the card: split-n partial sums into a
  ``(n_splits, r, B)`` scratch buffer, then a fixed-order combine (no
  atomics, so reruns are bit-identical);
* :func:`sinkhorn_halfstep` — ``out = marg / (Xi t)``, the matvec and the
  marginal divide fused, shape (n, B);
* :func:`feature_matvec` — ``out = Xi t`` without the divide (the
  convergence check's column marginal, and the u-update under momentum).

``xi`` is stored as float32 or bfloat16 (``precision="bf16"``); the kernels
widen it on load and accumulate in float32, as the plain versions do. Any
B >= 1 runs; the row kernels keep ``t`` (r x B float32) in shared memory,
so ``r * B * 4`` bytes must fit one CTA. Counterpart of
``repro.kernels.kermatvec``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .backend import check_operand, sm_count
from .logmatvec import (
    _contract_vectorized,
    _split_rows,
    _vec_width,
    _vectorized,
)
from .ref import (
    feature_contract_ref,
    feature_matvec_ref,
    sinkhorn_halfstep_ref,
)

__all__ = ["feature_contract", "sinkhorn_halfstep", "feature_matvec"]

_ROW_WARPS = 8                  # rows per row-kernel CTA (one per warp)
_MAX_SMEM = 227 * 1024          # dynamic shared memory of one CTA (t)


@functools.cache
def _lib():
    lib = build.load("kermatvec")
    c = lib.feature_contract_launch
    c.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    c.restype = ctypes.c_int
    h = lib.sinkhorn_halfstep_launch
    h.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    h.restype = ctypes.c_int
    v = lib.feature_matvec_launch
    v.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    v.restype = ctypes.c_int
    return lib


def feature_contract(xi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """t = Xi^T u, shape (r, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.feature_contract_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(u, "u", 2, dev)
    n, r = xi.shape
    B = u.shape[1]
    if u.shape[0] != n:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, u "
                         f"{tuple(u.shape)}")
    if dev.type == "cpu":
        return feature_contract_ref(xi, u)
    if min(n, r, B) < 1:
        raise ValueError(f"feature_contract kernel takes n, r, B >= 1, got "
                         f"n={n}, r={r}, B={B}")
    vec = _contract_vectorized(xi, B)
    n_splits, rows = _split_rows(n, r, _vec_width(xi) if vec else 0, dev)
    partial = torch.empty((n_splits, r, B), dtype=torch.float32, device=dev)
    t = torch.empty((r, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().feature_contract_launch(
            xi.data_ptr(), int(xi.dtype == torch.bfloat16), u.data_ptr(),
            partial.data_ptr(), t.data_ptr(), n, r, B, n_splits, rows,
            int(vec), stream)
    build.check_launch(_lib(), code, "feature_contract")
    feature_contract.launches += 1
    return t


def _check_rows(xi, t, what):
    n, r = xi.shape
    B = t.shape[1]
    if min(n, r, B) < 1 or r * B * 4 > _MAX_SMEM:
        raise ValueError(f"{what} kernel takes n, r, B >= 1 and r * B * 4 "
                         f"<= {_MAX_SMEM} bytes of t; got n={n}, r={r}, B={B}")
    return min(-(-n // _ROW_WARPS), 4 * sm_count(xi.device))


def sinkhorn_halfstep(xi: torch.Tensor, t: torch.Tensor,
                      marg: torch.Tensor) -> torch.Tensor:
    """out = marg / (Xi t), shape (n, B), float32 (IEEE divide).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.sinkhorn_halfstep_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    check_operand(marg, "marg", 2, dev)
    n, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r or tuple(marg.shape) != (n, B):
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}, marg {tuple(marg.shape)}")
    if dev.type == "cpu":
        return sinkhorn_halfstep_ref(xi, t, marg)
    grid = _check_rows(xi, t, "sinkhorn_halfstep")
    out = torch.empty((n, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sinkhorn_halfstep_launch(
            xi.data_ptr(), int(xi.dtype == torch.bfloat16), t.data_ptr(),
            marg.data_ptr(), out.data_ptr(), n, r, B,
            int(_vectorized(xi, B)), grid, stream)
    build.check_launch(_lib(), code, "sinkhorn_halfstep")
    sinkhorn_halfstep.launches += 1
    return out


def feature_matvec(xi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out = Xi t, shape (n, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.feature_matvec_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    n, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}")
    if dev.type == "cpu":
        return feature_matvec_ref(xi, t)
    grid = _check_rows(xi, t, "feature_matvec")
    out = torch.empty((n, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().feature_matvec_launch(
            xi.data_ptr(), int(xi.dtype == torch.bfloat16), t.data_ptr(),
            out.data_ptr(), n, r, B, int(_vectorized(xi, B)), grid, stream)
    build.check_launch(_lib(), code, "feature_matvec")
    feature_matvec.launches += 1
    return out


feature_contract.launches = 0
sinkhorn_halfstep.launches = 0
feature_matvec.launches = 0
