"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

int8 with one float32 scale per block of 256 values cuts the wire bytes
of a gradient all-reduce about 4x against bf16. Error feedback
(Karimireddy et al. '19) keeps the residual on each rank, so the
compression's bias vanishes over steps.

:func:`compressed_psum` is the pattern on a mesh axis: each rank
quantizes its contribution, the scales meet at an all-reduce MAX, each
rank re-expresses its int8 values on the shared scales, and the integers
are summed as int32 (exact), then dequantized. The train step keeps it
off, as the JAX package's does (``grad_compression``); it is wired and
tested. ``torch.round`` rounds half to even as ``jnp.round`` does, so a
quantization is bit-equal to the JAX package's. Counterpart of
``repro.optim.compression``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..distributed.sharding import MeshAxis
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "QuantizedGrad",
    "quantize_int8",
    "dequantize_int8",
    "ef_compress_tree",
    "init_error_buffers",
    "compressed_psum",
]

_BLOCK = 256


class QuantizedGrad(NamedTuple):
    q: torch.Tensor       # int8, (blocks, 256): the padded flat values
    scale: torch.Tensor   # float32, one a block
    n: int                # the original size


def quantize_int8(x: torch.Tensor) -> QuantizedGrad:
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return QuantizedGrad(q, scale[:, 0], n)


def dequantize_int8(qg: QuantizedGrad, shape) -> torch.Tensor:
    flat = qg.q.float() * qg.scale[:, None]
    return flat.reshape(-1)[:qg.n].reshape(shape)


def ef_compress_tree(grads, error_buf):
    """Error-feedback compression of a gradient tree: ``(the dequantized
    gradients to apply, the new error buffers)``. Every replica applies
    the dequantized value, so replicas stay bit-identical; the residual
    ``g + e - deq`` stays on the rank."""
    def one(g, e):
        target = g.float() + e
        deq = dequantize_int8(quantize_int8(target), g.shape)
        return deq.to(g.dtype), target - deq

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(error_buf))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error_buffers(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The int8-quantized sum of ``x`` over the ranks of ``axis``, on
    every rank: each rank's values on the largest scale of each block
    (all-reduce MAX), summed as int32 (all-reduce SUM), dequantized."""
    group = axis.group
    qg = quantize_int8(x)
    s_max = qg.scale.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # the local ints on the shared scale, so the integer sum is exact
    ratio = qg.scale / s_max
    total = torch.round(qg.q.float() * ratio[:, None]).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    flat = total.float() * s_max[:, None]
    return flat.reshape(-1)[:qg.n].reshape(x.shape)
