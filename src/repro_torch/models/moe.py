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
``torch.matmul``.

:func:`moe_ep_local` is the expert-parallel body that runs on every rank
of a mesh axis (the reference's ``shard_map`` body, in explicit SPMD):
rank r owns experts [r E_loc, (r + 1) E_loc). Each rank buckets its
(token, expert) assignments by destination rank into capacity-bounded
send buffers, exchanges them with one all-to-all, runs each local
expert's FFN (:func:`_expert_ffn`) on the rows it received (up to a
capacity of its own), and sends the outputs back with the mirrored
all-to-all; an assignment past either capacity is dropped, to the
integer of the reference's rule. The combine sums each token's k
contributions in a fixed order, ``(T, k, d).sum(1)``, and its backward
sums each token's k gradients so too (an expand, not a gather): never a
scatter with float atomics. Counterpart of ``repro.models.moe``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.objective import ExecutionPolicy
from ..core.routing import sinkhorn_route, stable_top_k
from ..distributed.sharding import MeshAxis, all_gather, all_to_all, pmean
from .layers import trunc_normal

__all__ = ["init_moe", "moe_dense", "moe_ep_local", "router_probs",
           "capacity"]


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


def _expert_ffn(w_up, w_gate, w_down, x):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def capacity(rows: int, buckets: int, capacity_factor: float) -> int:
    """The reference's capacity of a bucket: ``ceil(rows / buckets)``
    times the factor, truncated, rounded up to a multiple of 8 (at least
    8)."""
    c = int(-(-rows // max(buckets, 1)) * capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def _positions(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's position among the earlier entries with its id (the
    cumulative one-hot count)."""
    onehot = F.one_hot(ids, n)
    return torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=1)


def moe_ep_local(p_local, x: torch.Tensor, *, top_k: int, n_experts: int,
                 axis: MeshAxis, router: str = "softmax",
                 capacity_factor: float = 1.25,
                 fsdp_axis: Optional[MeshAxis] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 stats: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE on this rank of ``axis``: ``p_local`` holds
    the replicated router and this rank's experts (E_loc, d, f) / (E_loc,
    f, d), ``x`` (T, d) this rank's tokens. Returns ``(out (T, d), aux)``,
    aux averaged over the axis. Every rank of ``axis`` calls it with the
    same T.

    With ``fsdp_axis`` the expert weights arrive sharded over it on d as
    well and are gathered lazily, one expert at a time (the gathered
    weights live as one expert's, not E_loc's). ``stats`` (a dict, given
    on every rank or on none) receives ``kept``, the (T, k) assignments
    that passed both capacities (one more all-to-all)."""
    T, d = x.shape
    n_ranks = axis.size
    E_loc = n_experts // n_ranks
    if E_loc * n_ranks != n_experts or p_local["up"].shape[0] != E_loc:
        raise ValueError(f"{n_experts} experts over {n_ranks} ranks: expert "
                         f"stacks of {p_local['up'].shape[0]} given")
    combine, aux = router_probs(p_local, x, top_k=top_k, router=router,
                                policy=policy)
    aux = pmean(aux, axis)

    # (token, k) assignments, token-major: tok_id = repeat(arange(T), k)
    gates_k, idx_k = stable_top_k(combine, top_k)              # (T, k)
    exp_id = idx_k.reshape(-1)
    gate = gates_k.reshape(-1)
    dest = exp_id // E_loc                                     # target rank
    e_loc = exp_id % E_loc                                     # its expert
    # one row per assignment, token-major (tok_id = repeat(arange(T), k)):
    # an expand, so the backward sums each token's k rows in a fixed order
    # where a gather by tok_id would scatter-add them
    x_rep = x[:, None].expand(T, top_k, d).reshape(T * top_k, d)

    # capacity-bounded send buckets
    c_send = capacity(T * top_k, n_ranks, capacity_factor)
    keep = _positions(dest, n_ranks) < c_send
    slot = dest * c_send + _positions(dest, n_ranks)
    kept_slot, kept_at = slot[keep], keep.nonzero()[:, 0]
    send_x = x.new_zeros((n_ranks * c_send, d)).index_copy(
        0, kept_slot, x_rep[kept_at])
    send_e = torch.full((n_ranks * c_send,), E_loc, dtype=torch.int64,
                        device=x.device).index_copy(0, kept_slot,
                                                    e_loc[kept_at])

    # exchange: row blocks become (source rank, c_send)
    Rn = n_ranks * c_send
    recv_x = all_to_all(send_x.reshape(n_ranks, c_send, d), axis).reshape(
        Rn, d)
    recv_e = all_to_all(send_e.reshape(n_ranks, c_send), axis).reshape(Rn)

    # local experts: each one's rows up to its capacity, in received order
    c_exp = capacity(Rn, E_loc, capacity_factor)
    valid = (recv_e < E_loc) & (_positions(recv_e, E_loc + 1) < c_exp)
    rows, outs = [], []
    for e in range(E_loc):
        # every expert runs (and gathers its weights) on every rank, so
        # the collectives of the lazy gathers match in number and order
        rows_e = ((recv_e == e) & valid).nonzero()[:, 0]
        # at most c_exp rows: the bound a dry run counts this size at
        torch._check(rows_e.shape[0] <= c_exp)
        wu, wg, wd = (p_local[k][e].to(x.dtype) for k in ("up", "gate",
                                                          "down"))
        if fsdp_axis is not None:
            wu = all_gather(wu, fsdp_axis, dim=0)
            wg = all_gather(wg, fsdp_axis, dim=0)
            wd = all_gather(wd, fsdp_axis, dim=1)
        rows.append(rows_e)
        outs.append(_expert_ffn(wu, wg, wd, recv_x[rows_e]))
    out_rows = x.new_zeros((Rn, d)).index_copy(0, torch.cat(rows),
                                               torch.cat(outs))

    # exchange back (the mirror) and un-permute with this rank's indices
    back = all_to_all(out_rows.reshape(n_ranks, c_send, d), axis).reshape(
        Rn, d)
    contrib = x.new_zeros((T * top_k, d)).index_copy(0, kept_at,
                                                     back[kept_slot])
    contrib = contrib * gate[:, None].to(x.dtype)
    if stats is not None:
        returned = all_to_all(valid.to(torch.int32).reshape(n_ranks, c_send),
                              axis).reshape(Rn)
        kept = torch.zeros(T * top_k, dtype=torch.bool, device=x.device)
        kept[kept_at] = returned[kept_slot] > 0
        stats["kept"] = kept.reshape(T, top_k)
    return contrib.reshape(T, top_k, d).sum(1), aux
