"""The mesh axis of a sharded solve and its collectives.

A port "mesh" is a ``torch.distributed.device_mesh.DeviceMesh``; a sharded
solve runs over one of its named dimensions (``"data"`` by default), whose
process group carries every collective: NCCL on the card, gloo on the CPU.
:class:`MeshAxis` is that dimension as the solvers see it: the group, its
size p and this rank's index, the rows of a padded support this rank
holds, and the collectives of the sharded plans (in place, no autograd).

:func:`psum_logsumexp` is the distributed log-sum-exp over a row-sharded
axis: an all-reduce MAX of the detached local maxima, the shift pinned to
0 where the global maximum is ``-inf`` (an all ``-inf`` slice, the
log-features of padded atoms, gives a clean ``-inf``, never NaN), an
all-reduce SUM of the shifted local sums and a log. Only the sum is
differentiable: the shift cancels out of the exact identity, so its
gradient is stopped, as in the JAX package. The sum's backward is the
transpose of a sum over ranks, as ``psum``'s is: the input's gradient is
the all-reduce SUM of the ranks' cotangents. That is the gradient where
each rank's cotangent is its own share of the loss: the envelope VJP
differentiates each rank's share of the correlation (its rows). A loss
that every rank holds WHOLE enters with 1/p of its cotangent on each
rank, as the JAX package's ``shard_map`` divides a replicated output's
cotangent by the axis size; seeded whole on every rank, each term would
count p times.

:func:`shard_rows` and :func:`replicate` are the boundaries of a sharded
computation, differentiable both: a rank's rows of a global tensor (the
backward gathers every rank's rows, so the global tensor's gradient is
the same on every rank), and a tensor every rank holds whole (the
backward sums the ranks' contributions). Counterpart of
``repro.distributed.sharding`` (``shard_map``'s in-specs ``P(axis)`` and
``P()``, and ``psum_logsumexp``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshAxis", "psum_logsumexp", "shard_rows", "replicate"]


class MeshAxis:
    """One named dimension of a ``DeviceMesh``: the process group of this
    rank's slice along it, its size and this rank's index on it. A mesh
    without the dimension raises ``ValueError``."""

    def __init__(self, mesh, axis: str = "data"):
        names = getattr(mesh, "mesh_dim_names", None)
        if not names or axis not in names:
            raise ValueError(
                f"mesh has axes {names}, no axis named {axis!r}")
        dim = names.index(axis)
        self.axis = axis
        self.group = mesh.get_group(dim)
        self.size = int(mesh.size(dim))
        self.rank = int(mesh.get_local_rank(dim))

    def __repr__(self) -> str:
        return f"MeshAxis({self.axis!r}, rank {self.rank} of {self.size})"

    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of p: each rank holds as many
        rows."""
        return -(-n // self.size) * self.size

    def rows(self, total: int) -> Tuple[int, int]:
        """Rows [begin, end) of this rank in a padded axis of ``total``."""
        chunk = total // self.size
        return self.rank * chunk, (self.rank + 1) * chunk

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM of ``t`` in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce MAX of ``t`` in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def combine_lse(self, t: torch.Tensor) -> torch.Tensor:
        """The global LSE from each rank's LSE over its rows (the log
        contract's output): ``M = max_p t_p`` (0 where ``-inf``), then
        ``M + log sum_p exp(t_p - M)``; two collectives on t's shape."""
        shift = self.max_(t.clone())
        shift = torch.where(torch.isfinite(shift), shift,
                            torch.zeros_like(shift))
        return shift + torch.log(self.sum_(torch.exp(t - shift)))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) in rank order,
        concatenated along dim 0, on every rank."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward sums the ranks' cotangents (the
    module doc says when that is the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def psum_logsumexp(x: torch.Tensor, group: Optional[object] = None, *,
                   dim: int = 0) -> torch.Tensor:
    """LSE of ``x`` over its local ``dim`` AND the ranks of ``group`` (a
    process group, or a :class:`MeshAxis`), replicated on every rank: for
    the factored Sinkhorn kernel one r-vector, the method's whole traffic.
    Differentiable in ``x`` (see the module doc)."""
    if isinstance(group, MeshAxis):
        group = group.group
    local_max = torch.amax(x.detach(), dim=dim)
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    shift = torch.where(torch.isfinite(local_max), local_max,
                        torch.zeros_like(local_max))
    local_sum = torch.sum(torch.exp(x - shift.unsqueeze(dim)), dim=dim)
    return shift + torch.log(_AllReduceSum.apply(local_sum, group))


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        begin, end = axis.rows(x.shape[0])
        return x[begin:end].clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.gather_rows(grad), None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.sum_(grad.clone()), None


def shard_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """This rank's rows of ``x``, whose dim 0 is a multiple of p; the
    gradient of ``x`` gathers every rank's rows."""
    return _ShardRows.apply(x, axis)


def replicate(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x`` as every rank holds it; the gradient of ``x`` sums every
    rank's contribution, so it is the same on every rank."""
    return _Replicate.apply(x, axis)
