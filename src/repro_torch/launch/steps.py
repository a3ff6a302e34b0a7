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
rank included) it runs in explicit SPMD on every rank of the mesh, in
the reference's layout:

* parameters and AdamW moments are the rank's shards by
  ``specs.param_shardings`` (ZeRO). Each is gathered whole where the
  model uses it (``models.model.forward``'s ``specs``): a stacked
  group's a layer at a time inside the layer's checkpoint, so the
  recomputation gathers again and one layer is whole at a time; the
  experts stay the rank's own (E over ``"model"``, and d over the data
  axes for ``zero3`` configs, gathered one expert at a time inside the
  layer);
* the step takes this rank's BLOCK of the batch (``step.block`` of the
  global batch, ``specs.batch_block``): its rows of every micro-batch
  over the data axes, and the contiguous S / tp segment of the sequence
  over ``"model"`` where it divides. A batch that does not divide over
  the data axes is replicated, as the reference lays it out: every rank
  runs all its rows. The activations stay split by sequence from the
  embedding to the final norm (``models.model``); the OT loss gathers
  its global sample and solves sharded where ``cfg.ot_shard`` says
  (auto: on whenever the mesh has more than one rank);
* each rank differentiates its own share of the loss; the gathers'
  backwards reduce-scatter each leaf's gradient to its shards over the
  axes it is sharded on, the rest is summed over the axes it is not
  sharded on (``"model"`` for the ZeRO shards, whose ranks saw other
  tokens; the whole mesh for replicated leaves), and everything is
  divided by the mesh size: the gradient of the mean of the ranks'
  losses, the reference's global objective;
* AdamW updates the shards, its global-norm clip summing the squares of
  every leaf once across the shards (:func:`global_norm`); the metrics
  are global and the same on every rank.

Counterpart of ``repro.launch.steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs import ArchConfig, ShapeSpec
from ..core.objective import ExecutionPolicy
from ..distributed.sharding import MeshContext, mesh_context, \
    use_mesh_context
from ..models import decode_step, init_params, prefill, train_loss
from ..models.model import _EXPERTS, check_ported, effective_window
from ..optim import AdamWConfig, adamw_update, init_adamw, \
    linear_warmup_cosine
from ..tree import named_leaves, tree_leaves, tree_map, tree_unflatten
from . import specs as S

__all__ = ["make_train_step", "make_serve_step", "abstract_state",
           "global_norm"]

def abstract_state(cfg: ArchConfig, opt: Optional[AdamWConfig] = None):
    """(params, opt_state) as ``meta`` tensors: no allocation."""
    p_shape = init_params(cfg, device="meta")
    if opt is None:
        return p_shape, None
    return p_shape, init_adamw(p_shape, opt)


def loss_and_grads(params, cfg: ArchConfig, batch: Dict,
                   policy: ExecutionPolicy, specs=None):
    """``(grads, metrics)`` of ``train_loss`` at ``params`` (detached);
    with ``specs`` the parameters are the rank's shards and so are the
    gradients."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = train_loss(tree_unflatten(params, leaves), cfg, batch,
                               policy=policy, specs=specs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# Shards on a mesh
# ---------------------------------------------------------------------------


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


def _unsharded(spec, ctx: MeshContext) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that ``spec`` does not shard
    on: the ranks that computed a leaf's gradient apart."""
    used = {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in ctx.mesh.mesh_dim_names
                 if a not in used and ctx.sizes[a] > 1)


def _reduce_grads(grads, specs, ctx: MeshContext):
    """The rank's shards of the gradients (the gathers' backwards have
    summed each over the axes it is sharded on) summed over the axes it is
    not sharded on, leaves grouped by those axes, and divided by the mesh
    size."""
    leaves = [g.contiguous() for g in tree_leaves(grads)]
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for g, spec in zip(leaves, tree_leaves(specs)):
        axes = _unsharded(spec, ctx)
        if axes:
            groups.setdefault(axes, []).append(g)
    for axes, gs in groups.items():
        _sum_(gs, ctx.axis(axes).group)
    inv = 1.0 / ctx.world.size
    return tree_unflatten(grads, [g * inv for g in leaves])


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


def _laid_out(ctx: MeshContext, in_sh: Dict, seq: bool = True):
    """The step's context: ``ctx`` with the activations' layout of its
    inputs' specs (the rows split where the batch axes shard the first
    input, the sequence where ``"model"`` shards its dim 1 and ``seq``)."""
    lead = next(v for k, v in in_sh.items()
                if k in ("tokens", "embeds"))
    return ctx.laid_out(rows=lead[0] is not None,
                        seq=seq and len(lead) > 1 and lead[1] is not None)


def _block_fn(in_specs: Dict, in_sh: Dict, ctx: MeshContext,
              micro_batches: int, seq: bool):
    """``(block, check)``: the rank's block of a global batch, and a check
    that a batch has the block's shapes."""
    def block(batch: Dict) -> Dict:
        return S.batch_block(batch, in_sh, ctx, micro_batches=micro_batches,
                             seq=seq)

    want = {name: tuple(t.shape)
            for name, t in named_leaves(block(in_specs))}

    def check(batch: Dict) -> None:
        for name, t in named_leaves(batch):
            if name in want and tuple(t.shape) != want[name]:
                raise ValueError(
                    f"{name} of shape {tuple(t.shape)}: a mesh step takes "
                    f"this rank's block of the batch, {want[name]} "
                    "(step.block of the global batch)")
    return block, check


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
    parameters', moments' and inputs' specs, and ``block``, which cuts a
    global batch to this rank's block. On a mesh ``params`` and
    ``opt_state`` are the rank's shards (``specs.shard_tree`` of the
    global tree by ``step.shardings[0]``; ``init_adamw`` of the shards)
    and ``batch`` is the rank's block (``step.block(global_batch)``: its
    rows of every micro-batch, its segment of the sequence); build the
    step on every rank, in the same order (the first factory call on a
    mesh creates its process groups). Without a mesh ``step.block`` is
    the identity.

    ``micro_batches`` > 1 splits the batch on its leading dim and
    accumulates the gradients (the metrics are their mean), cutting
    activation memory by about M; 0 = auto (4 for ``zero3`` configs, else
    1), halved until it divides the batch into micro-batches that divide
    over the data axes (or to 1, where the batch does not divide and is
    replicated). The OT solves run on the hidden states' device."""
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
    p_shape, o_shape = abstract_state(cfg, opt)
    in_specs = S.input_specs(cfg, shape)
    p_specs = None
    if ctx is not None:
        p_specs = S.param_shardings(mesh, cfg, p_shape)
        _check_experts(cfg, ctx, p_specs)
        in_sh = S.input_shardings(mesh, cfg, shape, in_specs)
        step_ctx = _laid_out(ctx, in_sh)
        block, check = _block_fn(in_specs, in_sh, ctx, micro_batches, True)
        # the groups of the gradients' sums, built on every rank in order
        for spec in tree_leaves(p_specs):
            if _unsharded(spec, ctx):
                ctx.axis(_unsharded(spec, ctx))

    def accumulate(params, batch):
        mb = batch[next(iter(batch))].shape[0] // micro_batches
        grads, metrics = None, {}
        for i in range(micro_batches):
            g, m = loss_and_grads(params, cfg, _rows(batch, i * mb, mb),
                                  ot_policy, p_specs)
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
            grads, metrics = accumulate(params, batch)
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt, lr_schedule=sched)
            metrics.update(om)
            return params, opt_state, metrics
        check(batch)
        with use_mesh_context(step_ctx):
            grads, metrics = accumulate(params, batch)
            grads = _reduce_grads(grads, p_specs, ctx)
            metrics = _global_metrics(metrics, ctx)
            params, opt_state, om = adamw_update(
                params, grads, opt_state, opt, lr_schedule=sched,
                norm_fn=lambda g: global_norm(g, p_specs, ctx))
        metrics.update(om)
        return params, opt_state, metrics

    step.micro_batches = micro_batches     # after the auto rule and halving
    step.opt = opt                         # bf16 moments for zero3 configs
    step.block = lambda batch: batch
    if ctx is not None:
        step.context = ctx
        step.shardings = (p_specs, p_specs, in_sh)
        step.block = block
    return step, (p_shape, o_shape, in_specs)


def make_serve_step(cfg: ArchConfig, mesh, shape: ShapeSpec):
    """The prefill step ``(params, batch) -> last logits`` or the decode
    step ``(params, batch, caches) -> (logits, caches)`` of the serving
    shape, under ``torch.no_grad``, and its specs: ``(p_shape, in_specs)``
    or ``(p_shape, in_specs, cache_specs)``. Decode writes the caches in
    place (``models.decode_step``).

    On a mesh (``step.context``, ``step.shardings``: the parameters' and
    inputs' specs, and for decode the caches') ``params`` are the rank's
    shards and ``batch`` the rank's block (``step.block`` of the global
    batch); the logits come back whole on every rank. Prefill takes the
    train step's layout: its rows over the data axes, its segment of the
    sequence over ``"model"``, the parameters gathered a layer at a time,
    the experts parallel over ``"model"``; the last position's logits
    are the last ``"model"`` rank's. Decode takes the rank's batch rows
    and the caches' (``models.shard_caches`` of the global caches under
    ``step.context``), gathers the whole tree and runs the experts dense,
    as the reference's decode does. A batch that does not divide over the
    data axes (``long_500k``'s one row) is replicated, as the reference
    lays it out: each rank runs the whole batch, with the caches whole."""
    check_ported(cfg)
    ctx = None if mesh is None else mesh_context(mesh)
    p_shape, _ = abstract_state(cfg, None)
    in_specs = S.input_specs(cfg, shape)
    p_specs = None if ctx is None else S.param_shardings(mesh, cfg, p_shape)
    seq = shape.mode == "prefill"
    if ctx is not None:
        in_sh = S.input_shardings(mesh, cfg, shape, in_specs)
        step_ctx = _laid_out(ctx, in_sh, seq)
        block, check = _block_fn(in_specs, in_sh, ctx, 1, seq)

    def on_block(fn, params, batch, *rest):
        if ctx is None:
            return fn(params, batch, *rest, None)
        check(batch)
        with use_mesh_context(step_ctx):
            if seq:
                out = fn(params, batch, *rest, p_specs)
            else:
                out = fn(S.gather_tree(params, p_specs, ctx), batch, *rest,
                         None)
        if not step_ctx.rows_split:
            return out
        if isinstance(out, tuple):
            return (ctx.dp.gather_rows(out[0]),) + out[1:]
        return ctx.dp.gather_rows(out)

    def mark(fn, shardings):
        fn.block = lambda batch: batch
        if ctx is not None:
            fn.context, fn.shardings, fn.block = ctx, shardings, block
        return fn

    if seq:
        @torch.no_grad()
        def prefill_step(params, batch):
            return on_block(lambda p, b, sp: prefill(p, cfg, b, sp), params,
                            batch)
        if ctx is not None:
            _check_experts(cfg, ctx, p_specs)
        return mark(prefill_step, None if ctx is None else (
            p_specs, in_sh)), (p_shape, in_specs)

    win = effective_window(cfg, shape.seq_len)

    @torch.no_grad()
    def decode(params, batch, caches):
        return on_block(lambda p, b, c, _: decode_step(p, cfg, b, c,
                                                       window=win),
                        params, batch, caches)

    return mark(decode, None if ctx is None else (
        p_specs, in_sh, S.cache_shardings(mesh, cfg, shape))), \
        (p_shape, in_specs, S.cache_specs(cfg, shape))
