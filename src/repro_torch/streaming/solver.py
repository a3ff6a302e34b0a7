"""Incremental re-solves over paged streaming distributions.

:class:`StreamingSolver` re-solves a tracked pair through :func:`run_paged`:
normalization, the :class:`~repro_torch.core.paged.PagedFactored`
geometry, the warm start and the Sinkhorn loop, at the stores' fixed
buffer shapes. As in the JAX package, the solver keeps an LRU of runners,
one a bucket cell, bounded by ``max_runners``: each a captured loop
(``core.runners``) whose static buffers a solve copies the stores' device
buffers, weights and start potentials into. The cell key refines the
reference's :data:`RunnerKey` ``(C_x, C_y, r, page_size, eps, method)``
with the solver's fixed settings (precision, momentum, cadence), so a
RunnerKey maps to one runner, shared by every pair in that cell; a bucket
crossing changes the capacity and so the cell. :attr:`StreamingSolver.traces`
is the reference's retrace gate: captures across live runners, flat after
warmup however many updates flow through.

Warm-start contract:

* scaling method: :func:`run_paged` builds
  ``u0 = where(a > 0, exp(f0 / eps), 0)``, so a cold start (``f0 = 0``) is
  ``u0 = live mask``: the trajectory of the compact solve from ``u0 = 1``,
  with dead slots exactly 0 throughout;
* log method: ``f0`` goes into the solver's init, which pins dead slots to
  ``-inf``;
* between solves the potentials of each pair are kept on the host at full
  capacity; newly live slots and non-finite entries restart at 0 (cold for
  that slot), and a bucket crossing remaps them through the store's slot
  permutation.

Per update the host sends the dirty pages, the weights, the start
potentials and ``page_live`` (int32, once per solve) to the store's
device; everything else is host numpy. A ``precision="bf16"`` scaling
solve asks the stores for bfloat16 device buffers, the storage its kernels
read, so no solve casts a whole buffer; log solves store their
log-factors in bf16 and read float32 buffers. Counterpart of
``repro.streaming.solver``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.paged import PagedFactored
from ..core.runners import RunnerCache
from ..core.sinkhorn import (
    SinkhornResult,
    sinkhorn_geometry,
    sinkhorn_log_geometry,
)
from ..resilience.health import SolveHealth, classify
from .store import StreamingDistribution

__all__ = ["RunnerKey", "StreamingPair", "StreamingSolver", "run_paged"]

METHODS = ("scaling", "log")

# (C_x, C_y, r, page_size, eps, method)
RunnerKey = Tuple[int, int, int, int, float, str]


class StreamingPair:
    """One tracked OT problem between two streaming distributions, with its
    saved warm-start potentials (host numpy, full capacity)."""

    __slots__ = ("name", "x", "y", "f", "g", "n_solves", "n_warm",
                 "last_health")

    def __init__(self, name: str, x: StreamingDistribution,
                 y: StreamingDistribution):
        if x.eps != y.eps:
            raise ValueError(
                f"pair sides drawn at different eps: {x.eps} vs {y.eps}")
        if x.device != y.device:
            raise ValueError(
                f"pair sides on different devices: {x.device} vs {y.device}")
        self.name = name
        self.x = x
        self.y = y
        self.f: Optional[np.ndarray] = None
        self.g: Optional[np.ndarray] = None
        self.n_solves = 0
        self.n_warm = 0
        self.last_health: Optional[SolveHealth] = None

    @property
    def eps(self) -> float:
        return self.x.eps


def _prep_init(saved: Optional[np.ndarray], live: np.ndarray,
               remap: Optional[np.ndarray], capacity: int
               ) -> Tuple[np.ndarray, int]:
    """Warm-start preparation on the host: remap through a bucket crossing,
    then reset dead, newly live and non-finite slots to 0 (cold). Returns
    ``(f0, n_reset)``, ``n_reset`` counting the live slots whose saved
    potential was not finite (the solver's ``warm_resets``)."""
    f0 = np.zeros((capacity,), np.float32)
    if saved is None:
        return f0, 0
    if remap is not None:
        moved = remap >= 0
        f0[moved] = saved[remap[moved]]
    elif saved.shape[0] == capacity:
        f0[:] = saved
    else:                       # shape drifted without a remap: cold
        return f0, 0
    n_reset = int(np.sum(live & ~np.isfinite(f0)))
    f0 = np.where(live & np.isfinite(f0), f0, 0.0).astype(np.float32)
    return f0, n_reset


def run_paged(xi: torch.Tensor, zeta: torch.Tensor, live_x: np.ndarray,
              live_y: np.ndarray, wa: np.ndarray, wb: np.ndarray,
              f0: np.ndarray, g0: np.ndarray, *, page_size: int, eps: float,
              method: str, tol: float, max_iter: int, momentum: float,
              use_pallas: Optional[bool], precision: str,
              runners: Optional[RunnerCache] = None) -> SinkhornResult:
    """One solve over paged buffers: ``xi`` / ``zeta`` are the stores'
    device factors, the rest host numpy (page tables, weights, start
    potentials), sent to the factors' device here. A fused plan's loop
    runs through its cell's runner of ``runners``."""
    dev = xi.device

    def put(arr, dtype=torch.float32):
        return torch.as_tensor(arr, dtype=dtype, device=dev)

    wa, wb = put(wa), put(wb)
    a, b = wa / torch.sum(wa), wb / torch.sum(wb)
    geom = PagedFactored(
        xi=xi, zeta=zeta, page_live_x=put(live_x, torch.int32),
        page_live_y=put(live_y, torch.int32), page_size=page_size, eps=eps)
    if method == "log":
        # the log init pins dead (a == 0) slots to -inf
        return sinkhorn_log_geometry(
            geom, a, b, tol=tol, max_iter=max_iter, momentum=momentum,
            f_init=put(f0), g_init=put(g0), use_pallas=use_pallas,
            precision=precision, runners=runners)
    # the scaling iteration starts on the v-update: u0 alone seeds it
    u0 = torch.where(a > 0, torch.exp(put(f0) / eps), torch.zeros_like(a))
    return sinkhorn_geometry(
        geom, a, b, tol=tol, max_iter=max_iter, momentum=momentum,
        u_init=u0, use_pallas=use_pallas, precision=precision,
        runners=runners)


class StreamingSolver:
    """Warm-started incremental Sinkhorn over paged supports.

    The knobs are :func:`~repro_torch.core.sinkhorn.sinkhorn_geometry`'s;
    ``method`` picks the iteration domain ("scaling" | "log"). With the
    fused plan (``use_pallas`` not ``False``) scaling solves run the paged
    kernels and log solves the log plan on the paged buffers. One instance
    serves many pairs; runners are shared across pairs that land in the
    same bucket cell, at most ``max_runners`` of them.
    """

    def __init__(self, *, method: str = "scaling", tol: float = 1e-6,
                 max_iter: int = 2000, momentum: float = 1.0,
                 use_pallas: Optional[bool] = None,
                 precision: str = "highest", max_runners: int = 8):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, "
                             f"got {method!r}")
        self.method = method
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.momentum = float(momentum)
        self.use_pallas = use_pallas
        self.precision = precision
        self.max_runners = int(max_runners)
        self._runners = RunnerCache(self.max_runners)
        self._pairs: Dict[str, StreamingPair] = {}
        self.warmups = 0
        # resilience accounting (see _solve)
        self.diverged = 0        # solves that ended non-finite (terminal)
        self.cold_fallbacks = 0  # warm failures retried cold
        self.state_resets = 0    # pairs whose saved potentials were dropped
        self.warm_resets = 0     # live slots with non-finite saved warm state

    # -- pair registry -------------------------------------------------

    def register(self, name: str, x: StreamingDistribution,
                 y: StreamingDistribution) -> StreamingPair:
        if name in self._pairs:
            raise ValueError(f"pair {name!r} already registered")
        pair = StreamingPair(name, x, y)
        self._pairs[name] = pair
        return pair

    def pair(self, name: str) -> StreamingPair:
        return self._pairs[name]

    @property
    def pairs(self) -> Tuple[str, ...]:
        return tuple(self._pairs)

    # -- solving -------------------------------------------------------

    @property
    def storage_dtype(self) -> torch.dtype:
        """The dtype of the stores' device buffers this solver reads:
        bfloat16 for a bf16 scaling solve, else float32."""
        if self.method == "scaling" and self.precision == "bf16":
            return torch.bfloat16
        return torch.float32

    def _run(self, pair: StreamingPair, *operands) -> SinkhornResult:
        sx, sy = pair.x.store, pair.y.store
        if sx.rank != sy.rank:
            raise ValueError(f"rank mismatch: {sx.rank} vs {sy.rank}")
        if sx.page_size != sy.page_size:
            raise ValueError(
                f"page_size mismatch: {sx.page_size} vs {sy.page_size}")
        return run_paged(
            *operands, page_size=sx.page_size, eps=pair.eps,
            method=self.method, tol=self.tol, max_iter=self.max_iter,
            momentum=self.momentum, use_pallas=self.use_pallas,
            precision=self.precision, runners=self._runners)

    @property
    def runner_keys(self) -> Tuple[RunnerKey, ...]:
        """The :data:`RunnerKey` of each live runner, least recently used
        first."""
        return tuple((k.n, k.m, k.r, k.page_size, k.eps, self.method)
                     for k in self._runners.keys())

    @property
    def traces(self) -> int:
        """Captures across live runners, the retrace gate: flat after
        warmup, no matter how many updates flow through."""
        return self._runners.live_captures

    def warmup(self, pair: StreamingPair) -> None:
        """Run the pair's solve once on uniform all-live operands at its
        buffer shapes (they converge in a few iterations), which builds
        the kernels and captures the pair's runner, so that the first
        real update replays it."""
        C_x, C_y = pair.x.capacity, pair.y.capacity
        r, page_size = pair.x.store.rank, pair.x.store.page_size
        dev, dtype = pair.x.device, self.storage_dtype
        self._run(pair,
                  torch.ones((C_x, r), dtype=dtype, device=dev),
                  torch.ones((C_y, r), dtype=dtype, device=dev),
                  np.full((C_x // page_size,), page_size, np.int32),
                  np.full((C_y // page_size,), page_size, np.int32),
                  np.ones((C_x,), np.float32), np.ones((C_y,), np.float32),
                  np.zeros((C_x,), np.float32), np.zeros((C_y,), np.float32))
        self.warmups += 1

    def _solve(self, pair: StreamingPair, warm: bool) -> SinkhornResult:
        dx, dy = pair.x, pair.y
        remap_x, remap_y = dx.take_remap(), dy.take_remap()
        live_x, live_y = dx.live_mask(), dy.live_mask()
        warm_used = warm and pair.f is not None
        if warm_used:
            f0, rf = _prep_init(pair.f, live_x, remap_x, dx.capacity)
            g0, rg = _prep_init(pair.g, live_y, remap_y, dy.capacity)
            self.warm_resets += rf + rg
            pair.n_warm += 1
        else:
            f0 = np.zeros((dx.capacity,), np.float32)
            g0 = np.zeros((dy.capacity,), np.float32)
        operands = (dx.device_features(self.storage_dtype),
                    dy.device_features(self.storage_dtype),
                    dx.page_live(), dy.page_live(),
                    dx.weights_host(), dy.weights_host())
        res = self._run(pair, *operands, f0, g0)
        health = classify(res)
        if health.failed and warm_used:
            # the warm re-solve went non-finite: the saved potentials no
            # longer fit the mutated state. Retry cold through the same
            # runner: zero start potentials cost iterations, never a
            # capture.
            self.cold_fallbacks += 1
            res = self._run(pair, *operands,
                     np.zeros((dx.capacity,), np.float32),
                     np.zeros((dy.capacity,), np.float32))
            health = classify(res)
        pair.n_solves += 1
        pair.last_health = health
        if health.failed:
            # terminal divergence: drop the saved potentials so the next
            # solve starts cold instead of inheriting poison
            self.diverged += 1
            if pair.f is not None:
                self.state_resets += 1
            pair.f = pair.g = None
            return res
        pair.f = res.f.cpu().numpy()
        pair.g = res.g.cpu().numpy()
        return res

    def re_solve(self, pair: StreamingPair) -> SinkhornResult:
        """Warm-started solve from the pair's saved potentials."""
        return self._solve(pair, warm=True)

    def cold_solve(self, pair: StreamingPair) -> SinkhornResult:
        """Zero-start solve (no warm start)."""
        return self._solve(pair, warm=False)

    def update(self, pair: StreamingPair, *,
               add_x: Optional[dict] = None,
               remove_x=None,
               add_y: Optional[dict] = None,
               remove_y=None) -> SinkhornResult:
        """Apply mutations to both sides, evictions first, then one warm
        re-solve. ``add_x`` / ``add_y`` are keyword dicts for
        :meth:`StreamingDistribution.add`; ``remove_*`` id sequences."""
        if remove_x is not None:
            pair.x.remove(remove_x)
        if remove_y is not None:
            pair.y.remove(remove_y)
        if add_x is not None:
            pair.x.add(**add_x)
        if add_y is not None:
            pair.y.add(**add_y)
        return self.re_solve(pair)

    def stats(self) -> Dict[str, object]:
        return {
            "pairs": len(self._pairs),
            "runners": len(self._runners),
            "traces": self.traces,
            "warmups": self.warmups,
            "method": self.method,
            "diverged": self.diverged,
            "cold_fallbacks": self.cold_fallbacks,
            "state_resets": self.state_resets,
            "warm_resets": self.warm_resets,
        }
