"""AdamW, schedules and global-norm clipping over trees of tensors.

A functional update, as the JAX package's: :func:`adamw_update` returns
new parameters and a new state and leaves its inputs as they were (a
checkpoint of the old state stays valid). Moments can be stored in
bfloat16 (``moment_dtype``); the arithmetic is float32. Weight decay is
masked off 1-D leaves (norm scales, biases) — in the layer groups' stacked
layout those are 2-D and ARE decayed, as in the reference. Step, learning
rate and bias corrections are device tensors, so an update reads nothing
to the host. Counterpart of ``repro.optim.adamw``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..configs.base import torch_dtype
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "init_adamw",
    "adamw_update",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    m: Any
    v: Any


def _decay_mask(params):
    # decay everything except 1-D leaves (norm scales / biases)
    return tree_map(lambda p: p.dim() > 1, params)


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.moment_dtype)
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
    )


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm (``norm``: one computed elsewhere, a sharded tree's across its
    ranks)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr_schedule: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]] = None, *,
                 norm_fn: Optional[Callable[[Any], torch.Tensor]] = None):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``.
    ``norm_fn(grads)`` gives the global norm where the tree is one rank's
    shards (``launch.specs.global_norm``); by default :func:`global_norm`."""
    gnorm = (global_norm if norm_fn is None else norm_fn)(grads)
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, gnorm)
    step = state.step + 1
    stepf = step.float()
    lr = (torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
          if lr_schedule is None else lr_schedule(step))
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)
    mdt = torch_dtype(cfg.moment_dtype)

    def upd(p, g, m, v, decay):
        g32 = g.float()
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = [upd(*leaf) for leaf in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v), tree_leaves(_decay_mask(params)))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr.float()}
    return new_p, AdamWState(step, new_m, new_v), metrics


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step)
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + torch.cos(math.pi * t)))
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def fn(step):
        step = torch.as_tensor(step)
        warm = base_lr * step.float() / max(warmup, 1)
        return torch.where(step <= warmup, warm, cos(step - warmup))
    return fn
