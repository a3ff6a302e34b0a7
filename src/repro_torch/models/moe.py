"""Mixture-of-Experts layer: top-k routing and the dense expert path.

Routing is classic softmax top-k or the paper-integrated ``sinkhorn``
balanced assignment (``core.routing``): the linear-Sinkhorn solver reused
as a router. Both take their top-k through ``core.routing.stable_top_k``,
the reference's order (NaN first, ties by the lower index).

:func:`moe_dense` runs every token through every expert and weights the
outputs by the combine weights. Its last contraction folds the combine
weights into the (E, T, f) activations first and then takes one
``(T, E f) @ (E f, d)`` product, so no (T, E, d) temporary is built (3.8
GiB at deepseek-v3's width and 1024 tokens); the reference contracts the
same sum in another order, so the two agree to float32 rounding. A large
product that the reference computes outside Pallas stays
``torch.matmul``. The reference's expert-parallel path (``moe_ep_local``,
a ``shard_map`` body, and ``_expert_ffn``, the one expert's FFN it loops
over) waits for the multi-card slice (ROADMAP.md §A item 8d).
Counterpart of ``repro.models.moe``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.objective import ExecutionPolicy
from ..core.routing import sinkhorn_route, stable_top_k
from .layers import trunc_normal

__all__ = ["init_moe", "moe_dense", "router_probs"]


def init_moe(generator, d_model: int, d_ff: int, n_experts: int, *,
             dtype=torch.float32, device=None,
             lead=()) -> Dict[str, torch.Tensor]:
    """``{"router" (d, E) float32, "up" / "gate" (E, d, f), "down" (E, f,
    d)}`` in ``dtype``: the router's math stays float32."""
    kw = dict(generator=generator, device=device)
    out_std = 0.02 / (2.0 ** 0.5)
    return {
        "router": trunc_normal(lead + (d_model, n_experts), 0.02,
                               dtype=torch.float32, **kw),
        "up": trunc_normal(lead + (n_experts, d_model, d_ff), 0.02,
                           dtype=dtype, **kw),
        "gate": trunc_normal(lead + (n_experts, d_model, d_ff), 0.02,
                             dtype=dtype, **kw),
        "down": trunc_normal(lead + (n_experts, d_ff, d_model), out_std,
                             dtype=dtype, **kw),
    }


def router_probs(p, x: torch.Tensor, *, top_k: int, router: str = "softmax",
                 sinkhorn_eps: float = 0.05,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> ``(combine (T, E), aux)``, float32; combine is zero off
    the top-k. ``policy`` (the run-wide OT policy) shapes only the
    ``sinkhorn`` router's solve."""
    logits = x.float() @ p["router"]
    T, E = logits.shape
    if router == "sinkhorn":
        r = sinkhorn_route(logits, top_k=top_k, eps=sinkhorn_eps,
                           policy=policy)
        return r.combine, r.balance_loss
    probs = torch.softmax(logits, dim=-1)
    gates, idx = stable_top_k(probs, top_k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    combine = torch.zeros((T, E), dtype=torch.float32,
                          device=x.device).scatter(1, idx, gates)
    # the Switch-style load balance loss
    load = torch.mean((combine > 0).float(), dim=0)
    imp = torch.mean(probs, dim=0)
    return combine, E * torch.sum(load * imp)


def moe_dense(p, x: torch.Tensor, *, top_k: int, router: str = "softmax",
              policy: Optional[ExecutionPolicy] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token through every expert, combine-weighted: x (T, d) ->
    ``(out (T, d), aux)``. Cost O(T E d f)."""
    combine, aux = router_probs(p, x, top_k=top_k, router=router,
                                policy=policy)
    T, d = x.shape
    E, _, f = p["gate"].shape
    h = torch.matmul(x, p["gate"].to(x.dtype))             # (E, T, f)
    u = torch.matmul(x, p["up"].to(x.dtype))
    y = F.silu(h) * u * combine.T.to(x.dtype)[:, :, None]
    y = y.transpose(0, 1).reshape(T, E * f)
    return y @ p["down"].to(x.dtype).reshape(E * f, d), aux
