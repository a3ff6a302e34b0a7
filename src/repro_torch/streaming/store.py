"""Paged feature storage for streaming (mutable) distributions.

A :class:`PagedFeatureStore` keeps one distribution's positive feature rows
in a fixed-capacity buffer carved into pages of ``page_size`` rows. Insert
and evict write pages and flip weights; the buffer's shape never changes
between bucket crossings.

Invariants the rest of the stack leans on:

* **Dead slots carry zero weight.** Every solver masks zero-weight atoms
  exactly (``u = 0`` / ``f = -inf``), so stale rows in evicted slots
  change nothing.
* **Feature rows stay strictly positive**, live or dead: the buffer starts
  at ones and is only overwritten with rows of a positive feature map, so
  no masked path divides by 0 or takes ``log 0``.
* **Per-page live counts** (``page_live``, int32) let the paged kernels
  (``repro_torch.kernels.paged``) skip every page with no live slot.

Bookkeeping is host numpy and dicts. The device mirror is a
``(capacity, rank)`` tensor on the store's ``device`` (the card unless the
caller passes ``device="cpu"``), float32, or bfloat16 where the solver
asks for it (a ``precision="bf16"`` scaling solve reads the buffer as it
is, not a cast of the whole of it). The first :meth:`flush` uploads the
whole buffer, each later one copies only the dirty pages, one page copy
each, in place. Evictions write nothing. Counterpart of
``repro.streaming.store``.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from ..configs.shapes import ot_bucket
from ..core.features import gaussian_features
from ..kernels.backend import resolve_device

__all__ = ["PagedFeatureStore", "StreamingDistribution", "bucket_capacity"]


def bucket_capacity(n: int, page_size: int) -> int:
    """Bucketed store capacity for ``n`` expected live rows: the
    ``ot_bucket`` of ``n`` plus one headroom page, rounded up to a whole
    number of pages (the paged kernels take exact multiples)."""
    cap = ot_bucket(max(1, n) + page_size)
    return ((cap + page_size - 1) // page_size) * page_size


class PagedFeatureStore:
    """Fixed-capacity paged buffer of positive feature rows + weights.

    ``capacity`` must be a multiple of ``page_size``. Rows are addressed by
    caller-chosen hashable ids; ``add`` on an existing id overwrites its
    row in place (same slot), ``remove`` flips its weight to zero and frees
    the slot. The device mirror is synced by :meth:`flush` (called by
    :meth:`device_features`), page by page.
    """

    def __init__(self, rank: int, capacity: int, *, page_size: int = 64,
                 dtype=np.float32, device=None):
        if page_size < 1 or page_size % 8 != 0:
            raise ValueError(
                f"page_size must be a positive multiple of 8, got "
                f"{page_size}")
        if capacity < page_size or capacity % page_size != 0:
            raise ValueError(
                f"capacity {capacity} must be a positive multiple of "
                f"page_size {page_size}")
        self.device = resolve_device(device)
        self.rank = int(rank)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.n_pages = capacity // page_size
        self.dtype = np.dtype(dtype)
        # ones, not zeros: dead rows must stay strictly positive so the
        # masked linear/log operators never see log(0) or divide into 0
        self._feats = np.ones((capacity, rank), self.dtype)
        self._weights = np.zeros((capacity,), self.dtype)
        self._live = np.zeros((capacity,), bool)
        self._page_live = np.zeros((self.n_pages,), np.int32)
        self._slot: Dict[Hashable, int] = {}
        self._alloc_order: List[int] = []   # pages in first-touch order
        self._dirty: set = set()            # page ids pending device sync
        self._dev_feats: Optional[torch.Tensor] = None
        self._dev_dtype = torch.float32     # the mirror's storage
        self.version = 0                    # bumps on every mutation

    # -- occupancy / page table ---------------------------------------

    def __len__(self) -> int:
        return len(self._slot)

    @property
    def n_live(self) -> int:
        return len(self._slot)

    @property
    def page_live(self) -> np.ndarray:
        """Per-page live-slot counts, int32 ``(n_pages,)`` (copy)."""
        return self._page_live.copy()

    @property
    def page_indices(self) -> np.ndarray:
        """Ids of the pages holding at least one live slot, in first-touch
        order (the page table as CSR, on the host)."""
        return np.asarray(
            [p for p in self._alloc_order if self._page_live[p] > 0],
            np.int32)

    @property
    def page_indptr(self) -> np.ndarray:
        """CSR offsets over :attr:`page_indices`: live slots
        ``page_indptr[i]:page_indptr[i+1]`` of the logical live ordering
        lie in page ``page_indices[i]``."""
        counts = self._page_live[self.page_indices]
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    @property
    def last_page_len(self) -> int:
        """Live count of the most recently touched live page."""
        idx = self.page_indices
        return int(self._page_live[idx[-1]]) if idx.size else 0

    def ids(self) -> List[Hashable]:
        return list(self._slot)

    def slot_of(self, id_) -> int:
        return self._slot[id_]

    def live_mask(self) -> np.ndarray:
        return self._live.copy()

    def weights_host(self) -> np.ndarray:
        return self._weights.copy()

    def stats(self) -> Dict[str, object]:
        live_pages = int(np.count_nonzero(self._page_live))
        return {
            "capacity": self.capacity,
            "rank": self.rank,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "n_live": self.n_live,
            "live_pages": live_pages,
            "occupancy": self.n_live / self.capacity,
            "page_occupancy": live_pages / self.n_pages,
            "version": self.version,
        }

    # -- mutation ------------------------------------------------------

    def _alloc_slot(self) -> int:
        """A dead slot: in the most-filled non-full page first (keeps live
        pages dense, so dead pages stay skippable), a fresh page last. The
        JAX package's policy, as numpy scans of the page table."""
        counts = self._page_live
        partial = (counts > 0) & (counts < self.page_size)
        if partial.any():
            # the first of the fullest partly filled pages
            best_page = int(np.argmax(np.where(partial, counts, -1)))
        else:
            # no partly filled page: open the first fully dead one
            dead = np.flatnonzero(counts == 0)
            if not dead.size:
                raise ValueError(
                    f"store full: capacity {self.capacity} exhausted "
                    "(grow via StreamingDistribution rebucketing)")
            best_page = int(dead[0])
        base = best_page * self.page_size
        free = np.flatnonzero(~self._live[base:base + self.page_size])
        if not free.size:
            raise AssertionError("page_live count out of sync with live "
                                 "mask")
        return base + int(free[0])

    def add(self, ids: Sequence[Hashable], feats, weights) -> None:
        """Insert (or overwrite in place) the rows of ``ids``.

        ``feats``: ``(k, rank)`` strictly positive finite rows;
        ``weights``: ``(k,)`` strictly positive finite masses. Raises
        before mutating if the batch does not fit the free capacity."""
        feats = np.asarray(feats, self.dtype)
        weights = np.asarray(weights, self.dtype)
        if feats.shape != (len(ids), self.rank):
            raise ValueError(
                f"feats shape {feats.shape} != ({len(ids)}, {self.rank})")
        if weights.shape != (len(ids),):
            raise ValueError(
                f"weights shape {weights.shape} != ({len(ids)},)")
        if np.any(weights <= 0) or not np.all(np.isfinite(weights)):
            raise ValueError("weights must be strictly positive and finite "
                             "(zero weight means dead: use remove)")
        # NaN passes a bare `<= 0` test, and a non-finite row on a live page
        # would reach the sums (0 * NaN = NaN), so both are refused here
        if np.any(feats <= 0) or not np.all(np.isfinite(feats)):
            raise ValueError("feature rows must be strictly positive and "
                             "finite (linear-space positive-feature "
                             "invariant)")
        n_new = sum(1 for i in ids if i not in self._slot)
        if self.n_live + n_new > self.capacity:
            raise ValueError(
                f"insert of {n_new} new rows overflows capacity "
                f"{self.capacity} (live: {self.n_live})")
        for j, id_ in enumerate(ids):
            slot = self._slot.get(id_)
            if slot is None:
                slot = self._alloc_slot()
                self._slot[id_] = slot
                self._live[slot] = True
                page = slot // self.page_size
                self._page_live[page] += 1
                if page not in self._alloc_order:
                    self._alloc_order.append(page)
            self._feats[slot] = feats[j]
            self._weights[slot] = weights[j]
            self._dirty.add(slot // self.page_size)
        self.version += 1

    def remove(self, ids: Sequence[Hashable]) -> None:
        """Evict rows: weight -> 0, slot freed; the stale (positive)
        feature row stays in place, masked out."""
        missing = [i for i in ids if i not in self._slot]
        if missing:
            raise KeyError(f"ids not in store: {missing[:5]}")
        for id_ in ids:
            slot = self._slot.pop(id_)
            self._live[slot] = False
            self._weights[slot] = 0.0
            self._page_live[slot // self.page_size] -= 1
            # no dirty mark: the stale feature bytes on the device are
            # already right
        self.version += 1

    def set_weights(self, ids: Sequence[Hashable], weights) -> None:
        """Reweight live rows in place (no feature write, no flush)."""
        weights = np.asarray(weights, self.dtype)
        if np.any(weights <= 0):
            raise ValueError("weights must be strictly positive")
        for id_, w in zip(ids, weights):
            self._weights[self._slot[id_]] = w
        self.version += 1

    # -- device sync ---------------------------------------------------

    def _write_page(self, page: int) -> None:
        """One dirty-page flush: copy the page's rows into the mirror. A
        bf16 mirror's rounding runs on the device, after a float32 copy,
        not on the host."""
        rows = slice(page * self.page_size, (page + 1) * self.page_size)
        src = torch.from_numpy(self._feats[rows])
        if self._dev_dtype != torch.float32:
            src = src.to(self.device)
        self._dev_feats[rows].copy_(src)

    def flush(self) -> int:
        """Sync dirty pages to the device mirror; returns pages written
        (the first flush uploads the whole buffer and returns the number
        of dirty pages it covered)."""
        n = len(self._dirty)
        if self._dev_feats is None:
            self._dev_feats = torch.from_numpy(self._feats).to(
                self.device, copy=True).to(self._dev_dtype)
        else:
            for page in sorted(self._dirty):
                self._write_page(page)
        self._dirty.clear()
        return n

    def device_features(self, dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
        """The ``(capacity, rank)`` device buffer at ``dtype`` (float32 or
        bfloat16), synced. Later flushes write into the same tensor; a
        change of ``dtype`` uploads the whole buffer again from the host's
        float32 rows."""
        if dtype != self._dev_dtype:
            if dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"device buffer dtype must be float32 or "
                                 f"bfloat16, got {dtype}")
            self._dev_dtype = dtype
            self._dev_feats = None
        self.flush()
        return self._dev_feats

    def compact_grow(self, new_capacity: int) -> np.ndarray:
        """Repack the live rows densely into a larger buffer (a bucket
        crossing). Returns ``perm``, ``(new_capacity,)`` int, with
        ``perm[new_slot] = old_slot`` for moved rows and ``-1`` for empty
        slots: callers remap per-slot state (warm-start potentials)
        through it."""
        if new_capacity < self.n_live:
            raise ValueError(
                f"new capacity {new_capacity} < {self.n_live} live rows")
        if new_capacity % self.page_size != 0:
            raise ValueError(
                f"new capacity {new_capacity} must be a multiple of "
                f"page_size {self.page_size}")
        perm = np.full((new_capacity,), -1, np.int64)
        feats = np.ones((new_capacity, self.rank), self.dtype)
        weights = np.zeros((new_capacity,), self.dtype)
        live = np.zeros((new_capacity,), bool)
        new_slot_of: Dict[Hashable, int] = {}
        for new_slot, (id_, old_slot) in enumerate(self._slot.items()):
            perm[new_slot] = old_slot
            feats[new_slot] = self._feats[old_slot]
            weights[new_slot] = self._weights[old_slot]
            live[new_slot] = True
            new_slot_of[id_] = new_slot
        self.capacity = int(new_capacity)
        self.n_pages = new_capacity // self.page_size
        self._feats, self._weights, self._live = feats, weights, live
        self._slot = new_slot_of
        self._page_live = live.reshape(self.n_pages, self.page_size).sum(
            axis=1).astype(np.int32)
        self._alloc_order = [p for p in range(self.n_pages)
                             if self._page_live[p] > 0]
        self._dirty = set()
        self._dev_feats = None      # full upload on the next flush
        self.version += 1
        return perm


class StreamingDistribution:
    """A mutable weighted point set backed by a :class:`PagedFeatureStore`.

    One side of a factored OT problem (the rows of ``Xi`` or ``Zeta`` and
    their masses) at bucketed capacity. Build it :meth:`from_features`
    (given positive rows) or :meth:`from_points` (points through the
    Lemma-1 Gaussian feature map at the distribution's eps, so later
    ``add`` calls may pass points). An ``add`` past capacity crosses a
    bucket: the store compact-grows to the next ``ot_bucket`` and the slot
    permutation waits for the solver (:meth:`take_remap`).
    """

    def __init__(self, store: PagedFeatureStore, *, eps: float,
                 featurize: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None):
        self.store = store
        self.eps = float(eps)
        self._featurize = featurize
        self._remaps: List[np.ndarray] = []

    # -- constructors --------------------------------------------------

    @classmethod
    def from_features(cls, ids: Sequence[Hashable], feats, weights, *,
                      eps: float, capacity: Optional[int] = None,
                      page_size: int = 64,
                      device=None) -> "StreamingDistribution":
        feats = np.asarray(feats)
        cap = capacity or bucket_capacity(len(ids), page_size)
        store = PagedFeatureStore(feats.shape[1], cap, page_size=page_size,
                                  device=device)
        dist = cls(store, eps=eps)
        if len(ids):
            dist.add(ids, feats=feats, weights=weights)
        return dist

    @classmethod
    def from_points(cls, ids: Sequence[Hashable], points, weights,
                    anchors, *, eps: float, q: float = 1.0,
                    capacity: Optional[int] = None, page_size: int = 64,
                    device=None) -> "StreamingDistribution":
        dev = resolve_device(device)
        anchors_t = torch.as_tensor(np.asarray(anchors, np.float32),
                                    device=dev)

        def featurize(pts: np.ndarray) -> np.ndarray:
            x = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
            return gaussian_features(x, anchors_t, eps=eps,
                                     q=q).cpu().numpy()

        cap = capacity or bucket_capacity(len(ids), page_size)
        store = PagedFeatureStore(anchors_t.shape[0], cap,
                                  page_size=page_size, device=dev)
        dist = cls(store, eps=eps, featurize=featurize)
        if len(ids):
            dist.add(ids, points=points, weights=weights)
        return dist

    # -- mutation ------------------------------------------------------

    def add(self, ids: Sequence[Hashable], *, feats=None, points=None,
            weights=None) -> None:
        """Insert or overwrite rows; pass ``feats`` (given rows) or
        ``points`` (featurized through the pinned map). Grows the store
        through the next bucket boundary when needed."""
        if (feats is None) == (points is None):
            raise ValueError("pass exactly one of feats= or points=")
        if points is not None:
            if self._featurize is None:
                raise ValueError(
                    "this distribution was built from_features; "
                    "pass feats=, not points=")
            feats = self._featurize(np.asarray(points))
        if weights is None:
            raise ValueError("weights= is required")
        n_new = sum(1 for i in ids if i not in self.store._slot)
        if self.store.n_live + n_new > self.store.capacity:
            self._grow(self.store.n_live + n_new)
        self.store.add(ids, feats, weights)

    def remove(self, ids: Sequence[Hashable]) -> None:
        self.store.remove(ids)

    def _grow(self, needed: int) -> None:
        new_cap = bucket_capacity(needed, self.store.page_size)
        self._remaps.append(self.store.compact_grow(new_cap))

    def take_remap(self) -> Optional[np.ndarray]:
        """The slot permutation composed since the last call (or
        ``None``): ``perm[new_slot] = oldest_slot``. The solver remaps its
        saved potentials through it after a bucket crossing."""
        if not self._remaps:
            return None
        perm = self._remaps[0]
        for nxt in self._remaps[1:]:
            keep = nxt >= 0
            composed = np.full_like(nxt, -1)
            composed[keep] = perm[nxt[keep]]
            perm = composed
        self._remaps = []
        return perm

    # -- solve-side views ----------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def capacity(self) -> int:
        return self.store.capacity

    @property
    def n_live(self) -> int:
        return self.store.n_live

    def device_features(self, dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
        return self.store.device_features(dtype)

    def page_live(self) -> np.ndarray:
        return self.store.page_live

    def weights_host(self) -> np.ndarray:
        return self.store.weights_host()

    def live_mask(self) -> np.ndarray:
        return self.store.live_mask()
