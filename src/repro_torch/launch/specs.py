"""Input and cache specs of an LM cell, and the sharding rules of its
parameters, inputs and caches on a mesh.

``input_specs`` / ``cache_specs`` give the shapes and dtypes of every
model input and of the decode caches as tensors on the ``meta`` device,
with nothing allocated. Tokens and labels are int64 (the port's index
type).

``param_shardings`` maps every parameter leaf onto a ``("data",
"model")`` or ``("pod", "data", "model")`` mesh by the JAX package's
rules, one :class:`~repro_torch.distributed.sharding.PartitionSpec` a
leaf:

  experts  (L, E, d, f)  ->  E over 'model' (EP), then d / f over 'data'
                             under ``zero3`` (FSDP)
  embed    (V, d)        ->  vocab over 'model', d over 'data'
  lm_head  (d, V)        ->  d over 'data', vocab over 'model'
  generic  (..., a, b)   ->  'data' on the first divisible of the last two
                             dimensions (ZeRO weight shards)
  1-D, small (< 65536) and router leaves  ->  replicated

'data' spans ``("pod", "data")`` on the multi-pod mesh. The rules match
names as the reference's do, by substring of the '/'-joined path, so its
quirks carry over (every leaf of a MoE group contains "up", in "groups",
so the router's layer axis goes over 'model' where it divides).
Optimizer moments take their parameter's spec. ``input_shardings`` and
``cache_shardings`` give the batch over the data axes and the sequence
(train, prefill) or the KV sequence and SSD heads (decode) over 'model'.

A mesh here is a ``DeviceMesh`` or a mapping of dimension names to sizes
(the rules need only the sizes). :func:`shard_tree` cuts a global tree
to this rank's shards by a tree of specs, :func:`gather_tree` gathers the
shards back, and :func:`batch_block` cuts a global batch to the block a
rank's step takes (its rows of every micro-batch, its segment of the
sequence). Counterpart of ``repro.launch.specs``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence

import torch

from ..configs import ArchConfig, ShapeSpec
from ..distributed.sharding import MeshContext, PartitionSpec, \
    gather_spec, resolve_logical
from ..models import cache_logical_axes, init_caches
from ..tree import named_leaves, tree_leaves, tree_unflatten

__all__ = [
    "input_specs",
    "cache_specs",
    "input_shardings",
    "param_shardings",
    "cache_shardings",
    "batch_block",
    "shard_tree",
    "gather_tree",
]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for the (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    tok = torch.int64
    if shape.mode == "train":
        if cfg.input_kind == "embeds":
            return {"embeds": _meta((B, S, d), cfg.cdtype),
                    "labels": _meta((B, S), tok)}
        if cfg.input_kind == "encdec":
            return {"enc_embeds": _meta((B, S, d), cfg.cdtype),
                    "tokens": _meta((B, S), tok),
                    "labels": _meta((B, S), tok)}
        return {"tokens": _meta((B, S), tok), "labels": _meta((B, S), tok)}
    if shape.mode == "prefill":
        if cfg.input_kind == "embeds":
            return {"embeds": _meta((B, S, d), cfg.cdtype)}
        if cfg.input_kind == "encdec":
            return {"enc_embeds": _meta((B, S, d), cfg.cdtype),
                    "tokens": _meta((B, S), tok)}
        return {"tokens": _meta((B, S), tok)}
    # decode: one new token against an S-long cache
    out: Dict[str, Any] = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = _meta((B, 1, d), cfg.cdtype)
    else:
        out["tokens"] = _meta((B, 1), tok)
    if cfg.input_kind == "encdec":
        kv = (cfg.n_layers, B, S, cfg.n_heads, cfg.head_dim)
        out["enc_kv"] = {"k": _meta(kv, cfg.cdtype),
                         "v": _meta(kv, cfg.cdtype)}
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> List[Any]:
    """The decode caches of the cell, on ``meta``."""
    return init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, MeshContext):
        return dict(mesh.sizes)
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _axis_size(sizes: Dict[str, int], axis) -> int:
    names = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(sizes[a] for a in names)


def _axis_ok(sizes: Dict[str, int], axis, size: int) -> bool:
    return axis is None or size % _axis_size(sizes, axis) == 0


def input_shardings(mesh, cfg: ArchConfig, shape: ShapeSpec,
                    specs: Dict[str, Any]) -> Dict[str, Any]:
    """A :class:`PartitionSpec` for every leaf of ``input_specs``."""
    sizes = _sizes(mesh)
    dp = resolve_logical("batch", tuple(sizes))
    tp = resolve_logical("seq", tuple(sizes))

    def batch_axis(B):
        return dp if (dp and _axis_ok(sizes, dp, B)) else None

    def spec_for(path: str, s) -> PartitionSpec:
        dims = tuple(s.shape)
        if path in ("tokens", "labels"):
            ax = [batch_axis(dims[0])] + [None] * (len(dims) - 1)
            if shape.mode != "decode" and len(dims) > 1 and \
                    _axis_ok(sizes, tp, dims[1]):
                ax[1] = tp
            return PartitionSpec(*ax)
        if path in ("embeds", "enc_embeds"):
            ax = [batch_axis(dims[0]), None, None]
            if shape.mode != "decode" and _axis_ok(sizes, tp, dims[1]):
                ax[1] = tp
            return PartitionSpec(*ax)
        if path in ("enc_kv.k", "enc_kv.v"):
            # (L, B, S, H, D): the encoder length over 'model'
            return PartitionSpec(None, batch_axis(dims[1]),
                                 tp if _axis_ok(sizes, tp, dims[2]) else None,
                                 None, None)
        return PartitionSpec()

    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = {kk: spec_for(f"{k}.{kk}", vv) for kk, vv in v.items()}
        else:
            out[k] = spec_for(k, v)
    return out


def cache_shardings(mesh, cfg: ArchConfig, shape: ShapeSpec) -> List[Any]:
    """The caches of ``cache_specs``, each field a :class:`PartitionSpec`
    (the decode contract: the batch over the data axes, the KV sequence
    and the SSD heads over 'model'; ``length`` replicated)."""
    sizes = _sizes(mesh)
    out = []
    for cache, logical in zip(cache_specs(cfg, shape),
                              cache_logical_axes(cfg)):
        fields = []
        for leaf, lg in zip(cache, logical):
            if lg == "skip":
                fields.append(PartitionSpec(*([None] * leaf.dim())))
                continue
            ax = []
            for dim, name in zip(leaf.shape, lg):
                a = resolve_logical(name, tuple(sizes))
                ax.append(a if _axis_ok(sizes, a, dim) else None)
            fields.append(PartitionSpec(*ax))
        out.append(type(cache)(*fields))
    return out


def param_shardings(mesh, cfg: ArchConfig, params_shape) -> Any:
    """A :class:`PartitionSpec` for every parameter (or optimizer moment)
    leaf of ``params_shape``, in its tree's structure. The ZeRO 'data'
    direction spans ``("pod", "data")`` on the multi-pod mesh, so
    parameter and moment shards shrink with the whole data-parallel
    world."""
    sizes = _sizes(mesh)
    model_ok = "model" in sizes
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)

    def rule(name: str, leaf) -> PartitionSpec:
        dims = tuple(leaf.shape)
        ax: list = [None] * len(dims)

        def try_assign(dim_idx: int, axis) -> bool:
            if axis == "data":
                if not dp_axes:
                    return False
                axis = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            elif axis == "model" and not model_ok:
                return False
            if ax[dim_idx] is not None:
                return False
            size = _axis_size(sizes, axis)
            if dims[dim_idx] % size == 0 and dims[dim_idx] >= size:
                ax[dim_idx] = axis
                return True
            return False

        if "moe" in name and any(k in name for k in ("up", "gate", "down")):
            # (L, E, d, f) or (E, d, f): E -> model (EP), then FSDP on d/f
            try_assign(len(dims) - 3, "model")
            if cfg.zero3:
                if "down" in name:
                    try_assign(len(dims) - 1, "data")   # (f, d): shard d
                else:
                    try_assign(len(dims) - 2, "data")   # (d, f): shard d
            return PartitionSpec(*ax)
        if "embed" in name and "table" in name:
            try_assign(0, "model")
            try_assign(1, "data")
            return PartitionSpec(*ax)
        if "lm_head" in name:
            if len(dims) == 2:
                try_assign(1, "model")
                try_assign(0, "data")
            return PartitionSpec(*ax)
        if "router" in name or len(dims) <= 1 or \
                math.prod(dims) < 65536:
            return PartitionSpec(*ax)
        # generic FSDP: 'data' on the first divisible trailing dim
        for dim_idx in range(len(dims) - 2, len(dims)):
            if try_assign(dim_idx, "data"):
                break
        return PartitionSpec(*ax)

    return tree_unflatten(params_shape, [rule(name, leaf) for name, leaf in
                                         named_leaves(params_shape)])


# ---------------------------------------------------------------------------
# A rank's shards
# ---------------------------------------------------------------------------


def cut(t: torch.Tensor, spec: Sequence, ctx: MeshContext) -> torch.Tensor:
    """This rank's block of ``t`` by ``spec``, a tensor of its own."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = ctx.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                             f"not divide over {axis} ({n} ranks)")
        chunk = t.shape[dim] // n
        t = t.narrow(dim, ctx.coord(axis) * chunk, chunk)
    return t.clone()


def batch_block(batch: Dict[str, Any], specs: Dict[str, Any],
                ctx: MeshContext, *, micro_batches: int = 1,
                seq: bool = True) -> Dict[str, Any]:
    """This rank's block of a global batch laid out by ``specs`` (the
    inputs' :func:`input_shardings`), tensors of its own: every dimension
    on the batch axes cut to this rank's rows, every dimension on
    ``"model"`` (the sequence; ``enc_kv``'s encoder length) to its
    contiguous segment, unless ``seq`` is False (decode keeps the sequence
    whole).

    With ``micro_batches`` M > 1 a step cuts the global batch into M
    micro-batches of consecutive rows, as the reference reshapes it to
    (M, B / M), and each micro-batch's rows are split over the data axes:
    the rank's rows are its share of each micro-batch, in micro-batch
    order, not one contiguous block."""
    tp = ctx.tp_axis

    def cut_leaf(t: torch.Tensor, spec) -> torch.Tensor:
        for dim, axis in enumerate(spec):
            n = ctx.size(axis)
            if axis is None or n == 1 or (axis == tp and not seq):
                continue
            r = ctx.coord(axis)
            parts = 1 if axis == tp else micro_batches
            if t.shape[dim] % (parts * n):
                raise ValueError(
                    f"dimension {dim} of {tuple(t.shape)} does not divide "
                    f"into {parts} x {n} blocks over {axis}")
            each = t.shape[dim] // parts
            k = each // n
            blocks = [t.narrow(dim, i * each + r * k, k)
                      for i in range(parts)]
            t = blocks[0] if parts == 1 else torch.cat(blocks, dim=dim)
        return t.clone()

    return {k: batch_block(v, specs[k], ctx, micro_batches=micro_batches,
                           seq=seq) if isinstance(v, dict)
            else cut_leaf(v, specs[k]) for k, v in batch.items()}


def shard_tree(tree, specs, ctx: MeshContext):
    """This rank's shards of a global tree (parameters or moments) by a
    tree of specs of the same structure (:func:`param_shardings`)."""
    return tree_unflatten(tree, [
        cut(t, s, ctx) for t, s in zip(tree_leaves(tree),
                                       tree_leaves(specs))])


def gather_tree(tree, specs, ctx: MeshContext):
    """The global tree from every rank's shards (collective: every rank
    calls it; not differentiable)."""
    with torch.no_grad():
        return tree_unflatten(tree, [
            gather_spec(t, s, ctx) for t, s in zip(tree_leaves(tree),
                                                   tree_leaves(specs))])
