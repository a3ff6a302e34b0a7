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

The LM models' logical axes: a :class:`MeshContext` over a ``DeviceMesh``
with dimensions ``("data", "model")`` or ``("pod", "data", "model")``
maps the model's logical axes onto mesh dimensions as the JAX package
does (``batch`` -> ``("pod", "data")`` or ``("data",)``; ``seq``,
``kvseq``, ``vocab``, ``expert`` and ``heads`` -> ``"model"``; ``fsdp``
-> ``"data"``), and :func:`use_mesh_context` makes one current for the
code it encloses. The port runs such a mesh in explicit SPMD: every rank
runs the step on its own shards and calls its collectives itself, so
:func:`shard` is a layout's name, not a constraint; the JAX package's
``shard_map`` bodies (expert parallelism, the SSD's context parallelism)
call the differentiable collectives :func:`all_gather`,
:func:`all_to_all`, :func:`psum` and :func:`pmean` over a
:class:`MeshAxis` (one dimension, or the ``batch`` axes flattened into
one group). Their backwards are the adjoints of their forwards: a sum of
every rank's loss is differentiated, so a gather's backward sums the
ranks' cotangents of a block and an all-to-all's is the mirrored
all-to-all.
"""
from __future__ import annotations

import contextlib
import copy
import math
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["MeshAxis", "MeshContext", "PartitionSpec", "all_gather",
           "all_to_all", "current_mesh_context", "from_previous",
           "gather_spec", "logical_spec", "mesh_context", "pmean",
           "psum", "psum_logsumexp", "replicate", "resolve_logical",
           "rows_axis", "seq_axis", "shard", "shard_rows",
           "use_mesh_context"]

AxisName = Union[str, Tuple[str, ...]]


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

    @classmethod
    def of_group(cls, axis: AxisName, group, size: int,
                 rank: int) -> "MeshAxis":
        """The axis of an existing process group (several mesh dimensions
        flattened into one, as ``MeshContext.axis`` builds them)."""
        self = cls.__new__(cls)
        self.axis, self.group, self.size, self.rank = axis, group, size, rank
        return self

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


# ---------------------------------------------------------------------------
# Differentiable collectives over a mesh axis (the shard_map bodies' lax.*)
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # the adjoint: every rank's cotangent of this rank's block, summed
        return _reduce_scatter(grad, ctx.axis, ctx.dim, ctx.n), None, None


def _reduce_scatter(grad: torch.Tensor, axis: MeshAxis, dim: int,
                    n: int) -> torch.Tensor:
    """Block ``axis.rank`` (``n`` wide along ``dim``) of the sum of every
    rank's ``grad``: a reduce-scatter (``reduce_scatter_tensor``; on gloo
    an all-reduce and a slice)."""
    if dist.get_backend(axis.group) == "gloo":
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=axis.group)
        return grad.narrow(dim, axis.rank * n, n).contiguous()
    lead = grad.movedim(dim, 0).contiguous()
    out = lead.new_empty((n,) + lead.shape[1:])
    dist.reduce_scatter_tensor(out, lead, op=dist.ReduceOp.SUM,
                               group=axis.group)
    return out.movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.axis), None


def _exchange(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along ``dim`` in
    rank order, on every rank (``lax.all_gather(..., tiled=True)``)."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim)


def all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x`` of shape (p, ...): block j goes to rank j, and block j of the
    result came from rank j (``lax.all_to_all(x, axis, 0, 0)``)."""
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all of leading dim {x.shape[0]} over "
                         f"{axis.size} ranks")
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis)


def from_previous(x: torch.Tensor, axis: MeshAxis, n: int,
                  dim: int = 1) -> torch.Tensor:
    """The last ``n`` entries along ``dim`` of the previous rank's ``x``
    (zeros on rank 0): the halo of a causal window over a sequence split
    in rank order. Differentiable: the backward hands each rank's
    cotangent of its halo to the rank it came from. Every rank's graph
    holds the gather, so the backwards' collectives pair up."""
    if x.shape[dim] < n:
        raise ValueError(f"a halo of {n} from segments of {x.shape[dim]}")
    tail = x.narrow(dim, x.shape[dim] - n, n)
    tails = all_gather(tail[None], axis, dim=0)            # (R, ...)
    shifted = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])
    return shifted[axis.rank]


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum over the axis' ranks, on every rank (``lax.psum``)."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis.group)


def pmean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The mean over the axis' ranks, on every rank (``lax.pmean``)."""
    return psum(x, axis) / axis.size


# ---------------------------------------------------------------------------
# Logical axes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry a dimension: a mesh dimension's name, a tuple of names
    (the ``batch`` axes), or ``None`` (replicated); ``jax.sharding.
    PartitionSpec``'s counterpart, which also reads a tuple of one name as
    the name. A leaf of ``torch.utils._pytree``, so a tree of specs has
    the structure of the tree it describes."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def resolve_logical(logical: Optional[str], names: Sequence[str]):
    """The mesh dimension(s) of a logical axis on a mesh with dimensions
    ``names`` (``None``: replicated); an unknown name raises ``KeyError``."""
    if logical is None:
        return None
    if logical == "batch":
        dp = tuple(a for a in ("pod", "data") if a in names)
        return dp if dp else None
    if logical in ("seq", "kvseq", "vocab", "expert", "heads"):
        return "model" if "model" in names else None
    if logical == "fsdp":
        return "data" if "data" in names else None
    raise KeyError(f"unknown logical axis {logical!r}")


def _dims(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


class MeshContext:
    """The logical-to-mesh map of one run over a ``DeviceMesh``, and the
    process groups of its axes. Building one is collective: every rank of
    the mesh builds it, in the same order (the ``batch`` axes of a
    ``("pod", "data", "model")`` mesh get a group of their own).
    :func:`mesh_context` shares one a mesh, so its groups are built once."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.dp_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.tp_axis: Optional[str] = "model" if "model" in names else None
        self.sizes = _dims(mesh)
        self._axes: Dict[Tuple[str, ...], MeshAxis] = {}
        # the activations' layout: the batch rows over the data axes and
        # the sequence over "model" (the inputs' specs where they divide)
        self.rows_split = True
        self.seq_split = True
        for key in (self.dp_axes, names):
            if key:
                self.axis(key)

    def laid_out(self, rows: bool, seq: bool) -> "MeshContext":
        """This context (its groups shared) with the activations' layout
        of one step: the batch rows split over the data axes or not, the
        sequence over ``"model"`` or not."""
        out = copy.copy(self)
        out.rows_split, out.seq_split = bool(rows), bool(seq)
        return out

    def resolve(self, logical: Optional[str]):
        return resolve_logical(logical, tuple(self.sizes))

    @property
    def world(self) -> MeshAxis:
        """Every rank of the mesh as one axis."""
        return self.axis(tuple(self.mesh.mesh_dim_names))

    @property
    def dp(self) -> MeshAxis:
        """The batch axes (``("pod", "data")`` flattened, or ``"data"``)."""
        return self.axis(self.dp_axes)

    def axis(self, axis: AxisName) -> MeshAxis:
        """The :class:`MeshAxis` of a dimension or of several flattened
        (row-major, as ``P(("pod", "data"))`` lays the batch out)."""
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        if key not in self._axes:
            self._axes[key] = self._build(key)
        return self._axes[key]

    def coord(self, axis: Optional[AxisName]) -> int:
        """This rank's index on an axis (0 on ``None``)."""
        return 0 if axis is None else self.axis(axis).rank

    def size(self, axis: Optional[AxisName]) -> int:
        if axis is None:
            return 1
        names = (axis,) if isinstance(axis, str) else axis
        return math.prod(self.sizes[a] for a in names)

    def _build(self, key: Tuple[str, ...]) -> MeshAxis:
        names = tuple(self.mesh.mesh_dim_names)
        unknown = [a for a in key if a not in names]
        if unknown:
            raise ValueError(f"mesh has axes {names}, not {unknown}")
        if len(key) == 1:
            return MeshAxis(self.mesh, key[0])
        rank = 0
        for a in key:
            rank = rank * self.sizes[a] + int(self.mesh.get_local_rank(a))
        size = self.size(key)
        if size == self.mesh.size() and size == dist.get_world_size():
            group = dist.group.WORLD
        else:
            ranks = self.mesh.mesh.permute(
                [names.index(a) for a in names if a not in key]
                + [names.index(a) for a in key]).reshape(-1, size)
            group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        return MeshAxis.of_group(key, group, size, rank)


# the current context, process-wide: autograd runs a CUDA backward, and a
# checkpointed layer's recomputation in it, on threads of its own, which
# must see the context the forward ran under
_current: Dict[str, Optional[MeshContext]] = {"ctx": None}
_CONTEXTS: Dict[int, Tuple[weakref.ref, MeshContext]] = {}


def mesh_context(mesh) -> MeshContext:
    """The one :class:`MeshContext` of ``mesh`` (this very object: a new
    mesh of a new world gets its own), built on first use. Collective
    there, as building a context is."""
    hit = _CONTEXTS.get(id(mesh))
    if hit is not None and hit[0]() is mesh:
        return hit[1]
    for key in [k for k, (ref, _) in _CONTEXTS.items() if ref() is None]:
        del _CONTEXTS[key]
    ctx = MeshContext(mesh)
    _CONTEXTS[id(mesh)] = (weakref.ref(mesh), ctx)
    return ctx


@contextlib.contextmanager
def use_mesh_context(ctx: Optional[MeshContext]):
    """Make ``ctx`` current for the enclosed code (``None``: no mesh), on
    every thread of the process (autograd's too)."""
    prev = _current["ctx"]
    _current["ctx"] = ctx
    try:
        yield ctx
    finally:
        _current["ctx"] = prev


def current_mesh_context() -> Optional[MeshContext]:
    return _current["ctx"]


def seq_axis(ctx: Optional[MeshContext] = None) -> Optional[MeshAxis]:
    """The ``"model"`` axis when the context (the current one by default)
    splits the sequence over it and it has more than one rank: then a
    rank holds the contiguous S / tp segment of every one of its rows."""
    ctx = current_mesh_context() if ctx is None else ctx
    if ctx is None or ctx.tp_axis is None or not ctx.seq_split or \
            ctx.size(ctx.tp_axis) == 1:
        return None
    return ctx.axis(ctx.tp_axis)


def rows_axis(ctx: Optional[MeshContext] = None) -> Optional[MeshAxis]:
    """The batch axes when the context (the current one by default)
    splits the batch rows over them and they have more than one rank."""
    ctx = current_mesh_context() if ctx is None else ctx
    if ctx is None or not ctx.dp_axes or not ctx.rows_split or \
            ctx.dp.size == 1:
        return None
    return ctx.dp


def gather_spec(t: torch.Tensor, spec: Sequence,
                ctx: MeshContext) -> torch.Tensor:
    """The whole leaf from this rank's shard ``t`` of a leaf laid out by
    ``spec``: every rank's block along each sharded dimension, in rank
    order. Differentiable: the backward reduce-scatters the cotangent over
    the same axes, so each rank's shard receives the sum of every rank's
    cotangent of its block."""
    for dim, axis in enumerate(spec):
        if axis is not None and ctx.size(axis) > 1:
            t = all_gather(t, ctx.axis(axis), dim)
    return t


def logical_spec(*axes: Optional[str]) -> Optional[PartitionSpec]:
    """The mesh spec of logical ``axes`` under the current context, or
    ``None`` without one. The steps lay their inputs out by these names
    (``launch.specs.input_shardings``, ``batch_block``): each rank is
    handed its block and computes on it, so nothing constrains a tensor
    here; they give the JAX package's names to code that holds the two
    layouts side by side, as the tests do."""
    ctx = current_mesh_context()
    if ctx is None:
        return None
    return PartitionSpec(*(ctx.resolve(a) for a in axes))


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` laid out by logical ``axes`` (one a dimension): in explicit
    SPMD each rank already holds its block (its rows, its segment of the
    sequence), so this names the layout (an unknown logical axis raises
    ``KeyError``) and returns ``x``."""
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes for a {x.dim()}-d tensor")
    logical_spec(*axes)
    return x
