"""Train and serve step factories, on one card or on a mesh.

:func:`make_train_step` builds the run's one OT execution policy
(``ExecutionPolicy.from_config``), the warmup-cosine schedule and the
step: forward, cross-entropy and the OT prototype loss, gradients by
autograd (through the OT loss's envelope VJP, never through the Sinkhorn
loop), ``micro_batches`` gradient accumulation (on for ``zero3``
configs), then AdamW. A step is functional: it returns new parameters and
optimizer state and leaves its inputs as they were.

With ``mesh=None`` the step runs on one card. With a ``DeviceMesh`` of
dimensions ``("data", "model")`` or ``("pod", "data", "model")`` (one
rank included) it runs in explicit SPMD on every rank of the mesh:

* parameters and AdamW moments are the rank's shards by
  ``specs.param_shardings`` (ZeRO); each step gathers them whole, but the
  experts, which stay the rank's own (E over ``"model"``, and d over the
  data axes for ``zero3`` configs, gathered one expert at a time inside
  the layer);
* the step takes the GLOBAL batch and each rank runs its rows of every
  micro-batch (the batch over the data axes); the MoE layers run expert
  parallel and the SSD context parallel over ``"model"``
  (``models.model``), and the OT loss gathers its global sample and
  solves sharded where ``cfg.ot_shard`` says (auto: on whenever the mesh
  has more than one rank);
* each rank differentiates its own loss; the gradients are summed over
  the ranks that computed them (an all-reduce over the mesh, or over the
  data axes for the experts, then a slice to the rank's shard) and
  divided by the mesh size, so they are those of the mean of the ranks'
  losses, the reference's global objective;
* AdamW updates the shards, its global-norm clip summing the squares of
  every leaf once across the shards (:func:`global_norm`); the metrics
  are global and the same on every rank.

Counterpart of ``repro.launch.steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..configs import ArchConfig, ShapeSpec
from ..core.objective import ExecutionPolicy
from ..distributed.sharding import MeshContext, mesh_context, \
    use_mesh_context
from ..models import decode_step, init_params, prefill, train_loss
from ..models.model import check_ported, effective_window
from ..optim import AdamWConfig, adamw_update, init_adamw, \
    linear_warmup_cosine
from ..tree import named_leaves, tree_leaves, tree_map, tree_unflatten
from . import specs as S

__all__ = ["make_train_step", "make_serve_step", "abstract_state",
           "global_norm"]

_EXPERTS = ("moe/up", "moe/gate", "moe/down")


def abstract_state(cfg: ArchConfig, opt: Optional[AdamWConfig] = None):
    """(params, opt_state) as ``meta`` tensors: no allocation."""
    p_shape = init_params(cfg, device="meta")
    if opt is None:
        return p_shape, None
    return p_shape, init_adamw(p_shape, opt)


def loss_and_grads(params, cfg: ArchConfig, batch: Dict,
                   policy: ExecutionPolicy):
    """``(grads, metrics)`` of ``train_loss`` at ``params`` (detached)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = train_loss(tree_unflatten(params, leaves), cfg, batch,
                               policy=policy)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# Shards on a mesh
# ---------------------------------------------------------------------------


def _expert_flags(tree) -> List[bool]:
    return [name.endswith(_EXPERTS) for name, _ in named_leaves(tree)]


def _check_experts(cfg: ArchConfig, ctx: MeshContext, specs) -> None:
    """The experts' shards must be the layer's own: E over ``"model"``,
    and d over the data axes where they gather lazily."""
    lazy = cfg.zero3 and ctx.dp.size > 1
    for (name, _), spec in zip(named_leaves(specs), tree_leaves(specs)):
        if not name.endswith(_EXPERTS):
            continue
        d_dim = len(spec) - (1 if name.endswith("down") else 2)
        if spec[len(spec) - 3] != ctx.tp_axis or \
                (lazy and spec[d_dim] is None):
            raise ValueError(
                f"{name}: spec {spec} does not put the experts over "
                f"'model'{' and d over the data axes' if lazy else ''}")


def _compute_view(shards, specs, ctx: MeshContext):
    """The parameters a rank computes with: every leaf gathered whole but
    the experts, which stay its shards."""
    return tree_unflatten(shards, [
        t if expert else S.gathered(t, spec, ctx)
        for t, spec, expert in zip(tree_leaves(shards), tree_leaves(specs),
                                   _expert_flags(shards))])


def _sum_(tensors: List[torch.Tensor], group) -> None:
    """All-reduce SUM of ``tensors`` in place, one flat buffer a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def _reduce_grads(grads, specs, ctx: MeshContext, lazy: bool):
    """Each leaf's gradient summed over the ranks that computed it, divided
    by the mesh size, as the rank's shard: the whole leaves over the mesh,
    then sliced; the experts over the data axes (where the lazy gather's
    backward has not summed them already)."""
    leaves = [g.contiguous() for g in tree_leaves(grads)]
    flags = _expert_flags(grads)
    if ctx.world.size > 1:
        _sum_([g for g, e in zip(leaves, flags) if not e], ctx.world.group)
    if ctx.dp.size > 1 and not lazy:
        _sum_([g for g, e in zip(leaves, flags) if e], ctx.dp.group)
    inv = 1.0 / ctx.world.size
    return tree_unflatten(grads, [
        (g if e else S.cut(g, spec, ctx)) * inv
        for g, spec, e in zip(leaves, tree_leaves(specs), flags)])


def global_norm(shards, specs, ctx: MeshContext) -> torch.Tensor:
    """The global norm of a sharded tree: each leaf's squares summed on
    the ranks at index 0 of every mesh axis it is replicated over (so a
    replicated leaf counts once), then over the mesh. The leaves' sums
    add as ``optim.global_norm`` adds them, so on one rank the two norms
    (and the steps) are the same bits."""
    sums = []
    for t, spec in zip(tree_leaves(shards), tree_leaves(specs)):
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if any(ctx.coord(a) for a in ctx.sizes if a not in used):
            continue
        sums.append(torch.sum(torch.square(t.float())))
    total = (torch.sum(torch.stack(sums)) if sums else torch.zeros(
        (), device=tree_leaves(shards)[0].device))
    if ctx.world.size > 1:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.world.group)
    return torch.sqrt(total)


def _global_metrics(metrics: Dict[str, torch.Tensor],
                    ctx: MeshContext) -> Dict[str, torch.Tensor]:
    """The mean of every rank's metrics (each rank's ``ce`` is over its
    rows; ``aux`` and ``ot`` are global already)."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    if ctx.world.size > 1:
        dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=ctx.world.group)
    vals = vals / ctx.world.size
    return {k: vals[i] for i, k in enumerate(keys)}


def _rows(batch: Dict, lo: int, n: int, dim: int = 0) -> Dict:
    """Rows [lo, lo + n) of every input: its dim 0, or dim 1 of a nested
    input's leaves (``enc_kv``'s (L, B, T, H, D))."""
    return {k: _rows(v, lo, n, 1) if isinstance(v, dict)
            else v.narrow(dim, lo, n) for k, v in batch.items()}


def _split(n_rows: int, ctx: MeshContext):
    """(rows a rank, this rank's first row) of a batch of ``n_rows`` over
    the data axes, which must divide it."""
    dp = ctx.dp
    if n_rows % dp.size:
        raise ValueError(f"a batch of {n_rows} does not divide over "
                         f"{dp.size} data-parallel ranks")
    n = n_rows // dp.size
    return n, dp.rank * n


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, mesh=None,
                    shape: Optional[ShapeSpec] = None,
                    opt: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10000, micro_batches: int = 0):
    """Returns ``(step, (p_shape, o_shape, in_specs))``; the step is
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``, and
    its attributes ``micro_batches`` and ``opt`` are the ones it runs
    (initialise the optimizer state with ``step.opt``), and on a mesh
    ``context`` (its :class:`MeshContext`) and ``shardings``: the
    parameters', moments' and inputs' specs. On a mesh ``params`` and
    ``opt_state`` are the rank's shards (``specs.shard_tree`` of the
    global tree by ``step.shardings[0]``; ``init_adamw`` of the shards)
    and ``batch`` the global batch, the same on every rank; build the
    step on every rank, in the same order (the first factory call on a
    mesh creates its process groups).

    ``micro_batches`` > 1 splits the batch on its leading dim and
    accumulates the gradients (the metrics are their mean), cutting
    activation memory by about M; 0 = auto (4 for ``zero3`` configs, else
    1), halved until it divides the batch into micro-batches that divide
    over the data axes. The OT solves run on the hidden states' device."""
    check_ported(cfg)
    ctx = None if mesh is None else mesh_context(mesh)
    want_shard = (cfg.ot_shard if cfg.ot_shard is not None
                  else mesh is not None and mesh.size() > 1)
    if want_shard and mesh is None:
        raise ValueError("ot_shard=True shards the OT loss over a mesh: "
                         "pass one")
    # ONE OT execution policy per run: every training-time solve shares it
    ot_policy = ExecutionPolicy.from_config(
        cfg, mesh=mesh if want_shard else None)
    if cfg.ot_loss_weight > 0 or cfg.router == "sinkhorn":
        print(f"[steps] ot-policy {ot_policy.describe()}")
    sched = linear_warmup_cosine(opt.lr, min(200, total_steps // 10 + 1),
                                 total_steps)
    if cfg.zero3 and opt.moment_dtype == "float32":
        # optimizer memory is the binding constraint at 100B+ scale
        opt = dataclasses.replace(opt, moment_dtype="bfloat16")
    if micro_batches == 0:
        micro_batches = 4 if cfg.zero3 else 1
    shape = shape if shape is not None else ShapeSpec("cli", 256, 8, "train")
    B = shape.global_batch
    dp_size = 1 if ctx is None else ctx.dp.size
    # each micro-batch's rows must still divide over the data axes
    while micro_batches > 1 and (B % micro_batches != 0
                                 or (B // micro_batches) % dp_size != 0):
        micro_batches //= 2
    if ctx is not None:
        _split(B // micro_batches, ctx)
    p_shape, o_shape = abstract_state(cfg, opt)
    in_specs = S.input_specs(cfg, shape)
    if ctx is not None:
        p_specs = S.param_shardings(mesh, cfg, p_shape)
        _check_experts(cfg, ctx, p_specs)
    lazy = ctx is not None and cfg.zero3 and bool(ctx.dp_axes)

    def accumulate(params, batch, rows_of):
        mb = batch[next(iter(batch))].shape[0] // micro_batches
        grads, metrics = None, {}
        for i in range(micro_batches):
            g, m = loss_and_grads(params, cfg, rows_of(batch, i * mb, mb),
                                  ot_policy)
            if micro_batches == 1:
                return g, m
            grads = tree_map(lambda a: torch.zeros(a.shape, dtype=cfg.dtype,
                                                   device=a.device),
                             g) if grads is None else grads
            grads = tree_map(lambda a, b_: a + b_.to(a.dtype), grads, g)
            metrics = m if not metrics else {
                k: metrics[k] + m[k] for k in metrics}
        inv = 1.0 / micro_batches
        return (tree_map(lambda g_: g_ * inv, grads),
                {k: v * inv for k, v in metrics.items()})

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if ctx is None:
            grads, metrics = accumulate(params, batch, _rows)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt, lr_schedule=sched)
            metrics.update(om)
            return params, opt_state, metrics

        def rows_of(b, lo, n):
            n_loc, first = _split(n, ctx)
            return _rows(b, lo + first, n_loc)

        with use_mesh_context(ctx):
            full = _compute_view(params, p_specs, ctx)
            grads, metrics = accumulate(full, batch, rows_of)
            del full
            grads = _reduce_grads(grads, p_specs, ctx, lazy)
            metrics = _global_metrics(metrics, ctx)
            params, opt_state, om = adamw_update(
                params, grads, opt_state, opt, lr_schedule=sched,
                norm_fn=lambda g: global_norm(g, p_specs, ctx))
        metrics.update(om)
        return params, opt_state, metrics

    step.micro_batches = micro_batches     # after the auto rule and halving
    step.opt = opt                         # bf16 moments for zero3 configs
    if ctx is not None:
        step.context = ctx
        step.shardings = (p_specs, p_specs,
                          S.input_shardings(mesh, cfg, shape, in_specs))
    return step, (p_shape, o_shape, in_specs)


def make_serve_step(cfg: ArchConfig, mesh, shape: ShapeSpec):
    """The prefill step ``(params, batch) -> last logits`` or the decode
    step ``(params, batch, caches) -> (logits, caches)`` of the serving
    shape, under ``torch.no_grad``, and its specs: ``(p_shape, in_specs)``
    or ``(p_shape, in_specs, cache_specs)``. Decode writes the caches in
    place (``models.decode_step``).

    On a mesh (``step.context``, ``step.shardings``: the parameters' and
    inputs' specs, and for decode the caches') ``params`` are the rank's
    shards, ``batch`` the global batch, and the caches the rank's batch
    rows (``models.shard_caches`` of the global caches under
    ``step.context``); each rank runs its rows and the logits come back
    whole on every rank. Prefill runs the experts parallel over
    ``"model"``; decode gathers them and runs them dense, as the
    reference's decode does. A batch that does not divide over the data
    axes (``long_500k``'s one row) is replicated, as the reference lays it
    out: each rank gathers the whole tree and runs the whole batch as one
    card does, with the caches whole."""
    check_ported(cfg)
    ctx = None if mesh is None else mesh_context(mesh)
    p_shape, _ = abstract_state(cfg, None)
    in_specs = S.input_specs(cfg, shape)
    p_specs = None if ctx is None else S.param_shardings(mesh, cfg, p_shape)

    def on_rows(fn, params, batch, *rest, experts_local: bool):
        if ctx is None:
            return fn(params, batch, *rest)
        n = batch[next(iter(batch))].shape[0]
        whole = n % ctx.dp.size != 0
        with use_mesh_context(ctx):
            full = (_compute_view(params, p_specs, ctx)
                    if experts_local and not whole
                    else S.gather_tree(params, p_specs, ctx))
        if whole:
            return fn(full, batch, *rest)
        with use_mesh_context(ctx):
            n_loc, first = _split(n, ctx)
            out = fn(full, _rows(batch, first, n_loc), *rest)
        if isinstance(out, tuple):
            return (ctx.dp.gather_rows(out[0]),) + out[1:]
        return ctx.dp.gather_rows(out)

    if shape.mode == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return on_rows(lambda p, b: prefill(p, cfg, b), params, batch,
                           experts_local=True)
        if ctx is not None:
            _check_experts(cfg, ctx, p_specs)
            prefill_step.context = ctx
            prefill_step.shardings = (p_specs, S.input_shardings(
                mesh, cfg, shape, in_specs))
        return prefill_step, (p_shape, in_specs)

    win = effective_window(cfg, shape.seq_len)

    @torch.no_grad()
    def decode(params, batch, caches):
        return on_rows(lambda p, b, c: decode_step(p, cfg, b, c, window=win),
                       params, batch, caches, experts_local=False)

    if ctx is not None:
        decode.context = ctx
        decode.shardings = (p_specs, S.input_shardings(mesh, cfg, shape,
                                                       in_specs),
                            S.cache_shardings(mesh, cfg, shape))
    return decode, (p_shape, in_specs, S.cache_specs(cfg, shape))
