"""Fused Gaussian positive-feature map (Lemma 1): wrapper of ``csrc/feature_map.cu``.

    log Xi[i, k] = log_const[k] - 2/eps ||x_i - u_k||^2
                 = u2c[k] - 2/eps x2[i] + 4/eps <x_i, u_k>

The wrapper precomputes the rank-1 terms ``x2`` and ``u2c`` (as the TPU
wrapper does) and the kernel fuses the dot products, the norm epilogue and,
unless ``log_space``, the ``exp``: the (n, r) squared-distance matrix never
reaches device memory. The d axis is a loop inside each CTA, so any point
dimension runs fused (the JAX package's ``fused_map_max_d`` refusal has no
counterpart here). Counterpart of ``repro.kernels.feature_map``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .backend import check_operand
from .ref import gaussian_feature_map_ref, gaussian_norm_terms

__all__ = ["gaussian_feature_map"]

_MAX_ROW_TILES = 65535      # gridDim.y of the launch, 32 points per tile


@functools.cache
def _launcher():
    fn = build.load("feature_map").gaussian_feature_map_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gaussian_feature_map(x: torch.Tensor, anchors: torch.Tensor,
                         log_const: torch.Tensor, *, inv_eps: float,
                         log_space: bool = False) -> torch.Tensor:
    """Xi (or log Xi with ``log_space=True``), shape (n, r), float32.

    ``x`` (n, d), ``anchors`` (r, d), ``log_const`` (r,) float32 on one
    device. On a CUDA tensor this launches the kernel; on a CPU tensor it
    runs :func:`~repro_torch.kernels.ref.gaussian_feature_map_ref`.
    """
    dev = x.device
    check_operand(x, "x", 2, dev)
    check_operand(anchors, "anchors", 2, dev)
    check_operand(log_const, "log_const", 1, dev)
    n, d = x.shape
    r = anchors.shape[0]
    if anchors.shape[1] != d or log_const.shape[0] != r:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, anchors "
            f"{tuple(anchors.shape)}, log_const {tuple(log_const.shape)}")
    if dev.type == "cpu":
        return gaussian_feature_map_ref(x, anchors, log_const,
                                        inv_eps=inv_eps, log_space=log_space)
    if min(n, r, d) < 1 or (n + 31) // 32 > _MAX_ROW_TILES:
        raise ValueError(f"gaussian_feature_map kernel takes 1 <= n <= "
                         f"{32 * _MAX_ROW_TILES}, r, d >= 1; got n={n}, "
                         f"r={r}, d={d}")
    x2, u2c = gaussian_norm_terms(x, anchors, log_const, inv_eps)
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _launcher()(
            x.data_ptr(), anchors.data_ptr(), x2.data_ptr(), u2c.data_ptr(),
            out.data_ptr(), n, r, d, 2.0 * inv_eps, 4.0 * inv_eps,
            int(bool(log_space)), stream)
    build.check_launch(build.load("feature_map"), code, "gaussian_feature_map")
    gaussian_feature_map.launches += 1
    return out


gaussian_feature_map.launches = 0
