"""Carry the JAX package's problem state into the port.

A JAX ``GaussianPointCloud`` / ``FactoredPositive`` / ``DenseCost`` /
``ArcCosinePointCloud`` / ``NystromLowRank`` / ``GridSeparable`` /
``OTProblem`` holds a few arrays and scalars: ``x``, ``y``, ``anchors``,
``eps``, ``R``, ``s``, ``sigma``, ``kappa``, ``(log_)xi``, ``(log_)zeta``,
``C``, ``L``, ``Rt``, ``axes_x``, ``axes_y``, ``a``, ``b``. Each
function here takes those as numpy arrays (``np.asarray`` of the JAX
arrays) and builds the port's object on ``device`` (default: the card), so
one set of arrays can be handed to both packages. :func:`mlp_stack` and
:func:`gan_params` carry the JAX OT-GAN example's parameters (lists of
``{"w": (d_in, d_out), "b": (d_out,)}`` layers) into the port's modules;
:func:`paged_factored` and :func:`streaming_distribution` carry a paged
geometry and a streaming store's state, slot for slot;
:func:`solve_spec` and :func:`recovery_policy` carry a ``SolveSpec`` and
its ``RecoveryPolicy`` field by field; :func:`lm_params` and
:func:`adamw_state` carry an LM's parameter pytree and its AdamW state
leaf by leaf (the port keeps the JAX layouts, stacked layer groups and
``x @ w`` weights, so no leaf is transposed). Stacked inputs of the batched
engine are carried one problem at a time through :func:`factored_positive`
and :func:`ot_problem`, then stacked.
"""
from __future__ import annotations

from typing import Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.api import EpsSchedule, OTProblem
from .core.geometry import (
    ArcCosinePointCloud,
    DenseCost,
    FactoredPositive,
    GaussianPointCloud,
    GridSeparable,
    NystromLowRank,
)
from .core.objective import ExecutionPolicy
from .core.paged import PagedFactored
from .core.spec import SolveSpec
from .examples.ot_gan import MLP, OTGAN
from .kernels.backend import as_f32, resolve_device
from .models import init_params
from .models.layers import init_device
from .optim.adamw import AdamWState
from .resilience.policy import RUNGS, RecoveryPolicy
from .streaming import PagedFeatureStore, StreamingDistribution
from .tree import named_leaves, tree_map, tree_unflatten

__all__ = [
    "gaussian_point_cloud",
    "factored_positive",
    "dense_cost",
    "arccos_point_cloud",
    "nystrom_low_rank",
    "grid_separable",
    "ot_problem",
    "mlp_stack",
    "gan_params",
    "paged_factored",
    "streaming_distribution",
    "recovery_policy",
    "solve_spec",
    "lm_params",
    "adamw_state",
]


def gaussian_point_cloud(x, y, anchors, *, eps: float,
                         R: Optional[float] = None,
                         device=None) -> GaussianPointCloud:
    dev = resolve_device(device)
    return GaussianPointCloud.build(as_f32(x, dev), as_f32(y, dev),
                                    as_f32(anchors, dev), eps=eps, R=R)


def factored_positive(*, eps: float, xi=None, zeta=None, log_xi=None,
                      log_zeta=None, device=None) -> FactoredPositive:
    dev = resolve_device(device)

    def conv(arr):
        return None if arr is None else as_f32(arr, dev)

    return FactoredPositive(xi=conv(xi), zeta=conv(zeta), log_xi=conv(log_xi),
                            log_zeta=conv(log_zeta), eps=float(eps))


def dense_cost(C, *, eps: float, device=None) -> DenseCost:
    return DenseCost(as_f32(C, resolve_device(device)), float(eps))


def arccos_point_cloud(x, y, anchors, *, eps: float, s: int = 1,
                       sigma: float = 1.5, kappa: float = 1e-3,
                       device=None) -> ArcCosinePointCloud:
    dev = resolve_device(device)
    return ArcCosinePointCloud(as_f32(x, dev), as_f32(y, dev),
                               as_f32(anchors, dev), eps=float(eps), s=int(s),
                               sigma=float(sigma), kappa=float(kappa))


def nystrom_low_rank(L, Rt, *, eps: float, device=None) -> NystromLowRank:
    dev = resolve_device(device)
    return NystromLowRank(L=as_f32(L, dev), Rt=as_f32(Rt, dev),
                          eps=float(eps))


def grid_separable(axes_x, axes_y, *, eps: float,
                   device=None) -> GridSeparable:
    """A :class:`GridSeparable` from the JAX geometry's per-axis
    coordinate vectors (``axes_y`` may be the same arrays)."""
    dev = resolve_device(device)
    return GridSeparable(axes_x=tuple(as_f32(t, dev) for t in axes_x),
                         axes_y=tuple(as_f32(t, dev) for t in axes_y),
                         eps=float(eps))


def ot_problem(geometry, a=None, b=None, *, device=None) -> OTProblem:
    """An :class:`OTProblem` on ``geometry`` (a port geometry already on
    ``device``) with weights ``a``/``b`` (uniform when ``None``)."""
    return OTProblem.from_geometry(geometry, a, b, device=device)


def mlp_stack(params: Sequence[Mapping], *, device=None):
    """The port's :class:`~repro_torch.examples.ot_gan.MLP` holding a JAX
    layer list; the JAX layer is ``x @ w + b``, so ``weight = w.T``."""
    dev = resolve_device(device)
    ws = [as_f32(p["w"], dev) for p in params]
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    mlp = MLP(dims, device=dev)
    with torch.no_grad():
        for lin, w, p in zip(mlp.layers, ws, params):
            lin.weight.copy_(w.T)
            lin.bias.copy_(as_f32(p["b"], dev))
    return mlp


def gan_params(params: Mapping, *, device=None):
    """The port's :class:`~repro_torch.examples.ot_gan.OTGAN` from the JAX
    example's ``{"gen", "emb", "anchors"}`` parameter dict."""
    dev = resolve_device(device)
    return OTGAN(mlp_stack(params["gen"], device=dev),
                 mlp_stack(params["emb"], device=dev),
                 as_f32(params["anchors"], dev))


def paged_factored(*, eps: float, page_live_x, page_live_y,
                   page_size: int = 64, xi=None, zeta=None, log_xi=None,
                   log_zeta=None, device=None) -> PagedFactored:
    """A :class:`PagedFactored` from numpy factors (one pair, linear or
    log) and the per-page live counts."""
    dev = resolve_device(device)

    def conv(arr):
        return None if arr is None else as_f32(arr, dev)

    def live(arr):
        return torch.as_tensor(np.asarray(arr), dtype=torch.int32,
                               device=dev).contiguous()

    return PagedFactored(xi=conv(xi), zeta=conv(zeta), log_xi=conv(log_xi),
                         log_zeta=conv(log_zeta),
                         page_live_x=live(page_live_x),
                         page_live_y=live(page_live_y),
                         page_size=int(page_size), eps=float(eps))


def streaming_distribution(feats, weights, live, slot_of: Mapping[
        Hashable, int], page_live, alloc_order: Sequence[int], *,
        page_size: int, eps: float, device=None) -> StreamingDistribution:
    """The port's :class:`StreamingDistribution` holding a JAX store's
    state slot for slot: its ``(capacity, rank)`` feature buffer, weights,
    live mask, ``_slot`` (id -> slot, in insertion order), ``page_live``
    and ``_alloc_order`` (pages in first-touch order). Nothing is on the
    device yet: the first flush uploads the whole buffer."""
    feats = np.asarray(feats, np.float32)
    capacity, rank = feats.shape
    store = PagedFeatureStore(rank, capacity, page_size=page_size,
                              device=device)
    store._feats = feats.copy()
    store._weights = np.asarray(weights, np.float32).copy()
    store._live = np.asarray(live, bool).copy()
    store._page_live = np.asarray(page_live, np.int32).copy()
    store._slot = dict(slot_of)
    store._alloc_order = [int(p) for p in alloc_order]
    return StreamingDistribution(store, eps=eps)


def recovery_policy(*, rungs: Sequence[str] = RUNGS, max_attempts: int = 4,
                    deadline_s: Optional[float] = None,
                    eps_scale: float = 10.0,
                    accept: Sequence[str] = ("ok", "maxed_out")
                    ) -> RecoveryPolicy:
    """A :class:`RecoveryPolicy` from the JAX record's fields (validated
    as the JAX package validates them)."""
    return RecoveryPolicy(rungs=tuple(rungs), max_attempts=int(max_attempts),
                          deadline_s=deadline_s, eps_scale=float(eps_scale),
                          accept=tuple(accept))


def solve_spec(geometry, a=None, b=None, *, method: str = "auto",
               schedule: Optional[Mapping] = None, tol: float = 1e-6,
               max_iter: int = 2000, momentum: float = 1.0,
               precision: str = "highest",
               use_pallas: Optional[bool] = None,
               inner_steps: Optional[int] = None,
               check_every: Optional[int] = None,
               rank: Optional[int] = None, seed: Optional[int] = None,
               recovery: Optional[Mapping] = None,
               device=None) -> SolveSpec:
    """A :class:`SolveSpec` from a JAX spec's fields: ``geometry`` a port
    geometry already on ``device`` (built by the functions above),
    ``a``/``b`` numpy weights (``None``: uniform), ``schedule`` the
    ``EpsSchedule`` fields as a mapping, the ``ExecutionPolicy`` knobs one
    by one (the JAX ``backend`` pin has no counterpart: the geometry's
    device is the policy's), ``seed`` for the ``key`` (a CPU
    ``torch.Generator`` seeded with it; the JAX ``PRNGKey`` draws other
    numbers) and ``recovery`` the ``RecoveryPolicy`` fields as a
    mapping."""
    dev = resolve_device(device)
    return SolveSpec(
        geometry=geometry,
        a=None if a is None else as_f32(a, dev),
        b=None if b is None else as_f32(b, dev),
        method=method,
        schedule=None if schedule is None else EpsSchedule(**schedule),
        tol=float(tol), max_iter=int(max_iter), momentum=float(momentum),
        policy=ExecutionPolicy(precision=precision, use_pallas=use_pallas,
                               inner_steps=inner_steps,
                               check_every=check_every),
        rank=rank,
        key=None if seed is None else torch.Generator().manual_seed(
            int(seed)),
        recovery=None if recovery is None else recovery_policy(**recovery))


def _leaf(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """One numpy leaf as a tensor of ``dtype``: bfloat16 arrays (numpy's
    ``ml_dtypes`` extension type) go through float32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype).contiguous()


def _port_layout(tree_np):
    """The reference's tree in the port's layout: a hybrid's shared-block
    group is ``None`` there (a subtree without leaves in JAX's pytrees, a
    leaf in ``torch.utils._pytree``) and ``{}`` in the port."""
    return tree_map(lambda x: {} if x is None else x, tree_np)


def _like(template, tree_np, device, *, moments: bool = False):
    """``tree_np``'s leaves as tensors in the structure and shapes of the
    port's tree ``template``, each in the template leaf's dtype (for
    ``moments``, in its own: bfloat16 or float32); the names must match."""
    want = named_leaves(template)
    have = dict(named_leaves(_port_layout(tree_np)))
    names = {name for name, _ in want}
    if set(have) != names:
        raise ValueError(f"names differ: only in the port "
                         f"{sorted(names - set(have))}, only in the input "
                         f"{sorted(set(have) - names)}")
    leaves = []
    for name, like in want:
        arr = np.asarray(have[name])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {arr.shape}, the port's is "
                             f"{tuple(like.shape)}")
        dtype = like.dtype if not moments else (
            torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
        leaves.append(_leaf(arr, dtype, device))
    return tree_unflatten(template, leaves)


def lm_params(params_np, cfg, *, device=None):
    """The port's LM parameters from the JAX ``init_params`` pytree with
    numpy leaves (``jax.tree.map(np.asarray, params)``): the same nested
    dicts and lists, names and shapes checked against the port's own
    ``init_params(cfg)``, each leaf in its dtype there, on ``device``."""
    dev = init_device(device)
    return _like(init_params(cfg, device="meta"), params_np, dev)


def adamw_state(state_np, params, *, device=None) -> AdamWState:
    """The port's :class:`~repro_torch.optim.adamw.AdamWState` from the JAX
    state with numpy leaves ``(step, m, v)``; ``params`` are the port's
    parameters (their structure and shapes; the moments keep the dtypes of
    ``state_np``)."""
    dev = init_device(device)
    step, m, v = state_np
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=dev),
                      m=_like(params, m, dev, moments=True),
                      v=_like(params, v, dev, moments=True))
