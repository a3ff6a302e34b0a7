"""Sinkhorn-balanced MoE routing built on the paper's solver.

Expert assignment is an entropic OT problem between tokens (uniform
marginal ``a``) and experts (capacity marginal ``b``). The router's Gibbs
kernel ``K = exp(logits / eps)`` is positive by construction, and with E
(the number of experts) at most a few hundred the exact (T, E) kernel is
affordable: a :class:`~repro_torch.core.geometry.DenseCost` on
``max(logits) - logits`` (the exact kernel-first cost), solved through the
same :class:`~repro_torch.core.objective.OTObjective` as the OT losses.
A dense cost has no fused plan, so the solve runs the plain torch
operators, as the reference's XLA operators do.

The plan is a constant (the solve and the plan run under
``torch.no_grad`` on detached logits, the reference's ``stop_gradient``);
gradients reach the logits through the straight-through combine weights,
a softmax of the logits restricted to the dispatched experts.

Top-k takes a stable descending sort (:func:`stable_top_k`), never
``torch.topk``: it ranks NaN above every number and breaks ties by the
lower index, as ``jax.lax.top_k`` does, so a plan with non-finite rows
(at deepseek-v3's width ``C / eps`` reaches about 300 and ``exp``
underflows) dispatches the experts the reference dispatches.

Used by the deepseek-v2-236b / deepseek-v3-671b configs through
``router="sinkhorn"``. Counterpart of ``repro.core.routing``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import DenseCost
from .objective import ExecutionPolicy, OTObjective
from .sinkhorn import SinkhornResult

__all__ = ["SinkhornRouting", "sinkhorn_route", "balanced_plan",
           "stable_top_k"]


class SinkhornRouting(NamedTuple):
    combine: torch.Tensor       # (T, E) combine weights, zero off dispatch
    dispatch: torch.Tensor      # (T, E) 0 / 1 dispatch mask, logits' dtype
    balance_loss: torch.Tensor  # 0-d load-balance residual


def stable_top_k(x: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row in
    ``jax.lax.top_k``'s order: NaN first, ties by the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _policy(policy: Optional[ExecutionPolicy],
            n_iter: int) -> ExecutionPolicy:
    """The router's policy: with ``tol = 0`` the error check is dead
    weight, so a policy that sets neither cadence checks once a solve."""
    if policy is None:
        return ExecutionPolicy()
    if policy.check_every is None and policy.inner_steps is None:
        return ExecutionPolicy(device=policy.device,
                               precision=policy.precision,
                               use_pallas=policy.use_pallas,
                               check_every=n_iter)
    return policy


@torch.no_grad()
def balanced_plan(logits: torch.Tensor, *, eps: float = 0.05,
                  n_iter: int = 8,
                  policy: Optional[ExecutionPolicy] = None
                  ) -> Tuple[SinkhornResult, torch.Tensor]:
    """``(result, plan)``: the balanced solve on the detached logits
    (T, E) and its (T, E) plan ``u K v``, built from the float32 kernel
    whatever the policy's storage precision."""
    logits = logits.detach()
    T, E = logits.shape
    a = torch.full((T,), 1.0 / T, dtype=logits.dtype, device=logits.device)
    b = torch.full((E,), 1.0 / E, dtype=logits.dtype, device=logits.device)
    obj = OTObjective(eps=eps, tol=0.0, max_iter=n_iter,
                      policy=_policy(policy, n_iter))
    geom = DenseCost(torch.max(logits) - logits, eps)
    res = obj.solve(geom, a, b)
    return res, res.u[:, None] * geom.dense_kernel() * res.v[None, :]


def sinkhorn_route(logits: torch.Tensor, *, top_k: int, eps: float = 0.05,
                   n_iter: int = 8,
                   policy: Optional[ExecutionPolicy] = None
                   ) -> SinkhornRouting:
    """Balanced top-k assignment from an entropic OT plan: ``n_iter``
    iterations at tol 0 under ``policy`` (the run-wide OT policy; ``None``
    checks every iteration in float32), the top ``top_k`` experts of each
    token under the plan, straight-through combine weights and the balance
    loss ``E * sum((load - 1 / E)^2)``."""
    T, E = logits.shape
    _, plan = balanced_plan(logits, eps=eps, n_iter=n_iter, policy=policy)
    _, idx = stable_top_k(plan, top_k)
    dispatch = torch.zeros((T, E), dtype=logits.dtype,
                           device=logits.device).scatter_(1, idx, 1.0)
    on = dispatch > 0
    masked = torch.where(on, logits, -torch.inf)
    combine = torch.where(on, torch.softmax(masked, dim=-1), 0.0)
    load = torch.mean(dispatch, dim=0)
    balance = E * torch.sum(torch.square(load - 1.0 / E))
    return SinkhornRouting(combine, dispatch, balance)
