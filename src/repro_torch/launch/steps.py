"""Train and serve step factories for one card.

:func:`make_train_step` builds the run's one OT execution policy
(``ExecutionPolicy.from_config``), the warmup-cosine schedule and the
step: forward, cross-entropy and the OT prototype loss, gradients by
autograd (through the OT loss's envelope VJP, never through the Sinkhorn
loop), ``micro_batches`` gradient accumulation (on for ``zero3``
configs), then AdamW. A step is functional: it returns new parameters and
optimizer state and leaves its inputs as they were.

The port runs on a 1 x 1 mesh (``mesh=None`` or a one-rank
``DeviceMesh`` of ``launch.mesh.make_local_mesh``): no collective runs and
``cfg.ot_shard`` auto resolves to off. A larger mesh raises
``NotImplementedError``: sharded LM training waits for the multi-card
slice (ROADMAP.md §A item 8d). Counterpart of ``repro.launch.steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs import ArchConfig, ShapeSpec
from ..core.objective import ExecutionPolicy
from ..models import decode_step, init_params, prefill, train_loss
from ..models.model import check_ported, effective_window
from ..optim import AdamWConfig, adamw_update, init_adamw, \
    linear_warmup_cosine
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import specs as S

__all__ = ["make_train_step", "make_serve_step", "abstract_state",
           "check_local_mesh"]


def abstract_state(cfg: ArchConfig, opt: Optional[AdamWConfig] = None):
    """(params, opt_state) as ``meta`` tensors: no allocation."""
    p_shape = init_params(cfg, device="meta")
    if opt is None:
        return p_shape, None
    return p_shape, init_adamw(p_shape, opt)


def check_local_mesh(mesh) -> None:
    """Accept ``None`` or a one-rank mesh; refuse anything larger."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size()} ranks: sharded LM training and "
            "serving wait for the multi-card slice (ROADMAP.md §A item 8d); "
            "the port runs them on one card (mesh=None or 1 x 1)")


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


def make_train_step(cfg: ArchConfig, mesh=None,
                    shape: Optional[ShapeSpec] = None,
                    opt: AdamWConfig = AdamWConfig(),
                    total_steps: int = 10000, micro_batches: int = 0):
    """Returns ``(step, (p_shape, o_shape, in_specs))``; the step is
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``, and
    its attributes ``micro_batches`` and ``opt`` are the ones it runs
    (initialise the optimizer state with ``step.opt``).

    ``micro_batches`` > 1 splits the batch on its leading dim and
    accumulates the gradients (the metrics are their mean), cutting
    activation memory by about M; 0 = auto (4 for ``zero3`` configs, else
    1), halved until it divides the batch. The OT solves run on the
    hidden states' device."""
    check_ported(cfg)
    check_local_mesh(mesh)
    if cfg.ot_shard:
        raise NotImplementedError(
            "ot_shard=True: sharded OT losses in training wait for the "
            "multi-card slice (ROADMAP.md §A item 8d)")
    # ONE OT execution policy per run: every training-time solve shares it
    ot_policy = ExecutionPolicy.from_config(cfg)
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
    while micro_batches > 1 and B % micro_batches != 0:
        micro_batches //= 2

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if micro_batches > 1:
            mb = batch[next(iter(batch))].shape[0] // micro_batches
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.dtype,
                                                   device=p.device), params)
            metrics: Dict[str, Any] = {}
            for i in range(micro_batches):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = loss_and_grads(params, cfg, micro, ot_policy)
                grads = tree_map(lambda a, b_: a + b_.to(a.dtype), grads, g)
                metrics = m if not metrics else {
                    k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / micro_batches
            grads = tree_map(lambda g_: g_ * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            grads, metrics = loss_and_grads(params, cfg, batch, ot_policy)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt,
                                             lr_schedule=sched)
        metrics.update(om)
        return params, opt_state, metrics

    step.micro_batches = micro_batches     # after the auto rule and halving
    step.opt = opt                         # bf16 moments for zero3 configs
    p_shape, o_shape = abstract_state(cfg, opt)
    return step, (p_shape, o_shape, S.input_specs(cfg, shape))


def make_serve_step(cfg: ArchConfig, mesh, shape: ShapeSpec):
    """The prefill step ``(params, batch) -> last logits`` or the decode
    step ``(params, batch, caches) -> (logits, caches)`` of the serving
    shape, under ``torch.no_grad``, and its specs: ``(p_shape, in_specs)``
    or ``(p_shape, in_specs, cache_specs)``. Decode writes the caches in
    place (``models.decode_step``)."""
    check_ported(cfg)
    check_local_mesh(mesh)
    p_shape, _ = abstract_state(cfg, None)
    in_specs = S.input_specs(cfg, shape)
    if shape.mode == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return prefill(params, cfg, batch)
        return prefill_step, (p_shape, in_specs)

    win = effective_window(cfg, shape.seq_len)

    @torch.no_grad()
    def decode(params, batch, caches):
        return decode_step(params, cfg, batch, caches, window=win)

    return decode, (p_shape, in_specs, S.cache_specs(cfg, shape))
