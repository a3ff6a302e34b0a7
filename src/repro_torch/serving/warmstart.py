"""Warm-start cache: fingerprinted potentials for repeat and near-repeat
pairs.

Service traffic is heavy-tailed: the same distribution pairs, and small
perturbations of them, recur. A converged solve's potentials ``(f, g)``
are the perfect warm start for a re-solve of the same pair (the solver
exits at its first check) and a good one for a nearby pair. This module
fingerprints a request's kernel data and weights and hands cached
potentials back to the engine's ``f_init``/``g_init`` path.

Two-level fingerprint
---------------------
* ``support_key``: a content hash of the quantised kernel data (features,
  log-features or dense cost). Quantisation (``round(x / quant)``) makes
  the hash robust to sub-``quant`` float fuzz from re-deriving the same
  features.
* ``full_key``: ``support_key`` extended with the quantised weights.

The cache is keyed on ``support_key``; a lookup whose stored ``full_key``
also matches is an EXACT hit (the same pair up to quantisation), otherwise
a NEAR hit (same supports, other weights: the potentials are only a good
start, and the solve still converges to its own fixed point).

The bytes hashed are the JAX package's (blake2b of the shapes and of the
int64 grid ``round(x / quant)``, ``+-inf`` and NaN pinned to ``+-2**61``),
so both packages give one array the same key. A CUDA tensor is quantised
on its device, in float64, and only the int64 grid comes to the host.

Poisoning defence
-----------------
A diverged solve's potentials are NaN; served as a warm start they poison
every later request for the pair. So the cache validates on both sides:

* **store** refuses potentials that are non-finite on any atom that
  carries mass (``-inf`` on a zero-weight atom is the log domain's
  dead-slot encoding and is sanitised to 0, so stored entries are always
  finite); a refusal keeps any earlier good entry.
* **lookup** re-validates the stored arrays and evicts a corrupt entry
  (``store(..., validate=False)``, the chaos lane's corrupted snapshot),
  counting the request as a miss: the caller solves cold.

Potentials are kept as host numpy arrays (the service reads each
megabatch's results to the host once). Counterpart of
``repro.serving.warmstart``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["fingerprint", "request_keys", "WarmHit", "WarmStartCache"]

# the value +-inf and NaN quantise to: far outside any real quantised
# feature range, the same on every platform
_BIG = float(2**61)


def _grid(arr, quant: float) -> Tuple[Tuple[int, ...], bytes]:
    """The shape of ``arr`` and the bytes of its int64 grid
    ``clip(nan_to_num(round(x / quant)), -BIG, BIG)``, computed in float64
    (numpy's IEEE ops, on the tensor's device) and read to the host."""
    x = arr if isinstance(arr, torch.Tensor) else \
        torch.as_tensor(np.asarray(arr))
    x = x.detach().to(torch.float64)
    q = torch.nan_to_num(torch.round(x / quant), nan=_BIG, posinf=_BIG,
                         neginf=-_BIG)
    q = q.clamp(-_BIG, _BIG).to(torch.int64)
    return tuple(x.shape), q.cpu().numpy().tobytes()


def fingerprint(arrays: Iterable, *, quant: float = 1e-6) -> bytes:
    """Content hash of quantised arrays (numpy arrays or tensors on any
    device): shapes plus ``round(x / quant)``.

    Deterministic across runs and processes (blake2b of the int64 grid),
    and invariant to perturbations that stay inside the same quantisation
    cells. ``quant`` trades near-repeat tolerance against collision
    radius."""
    if quant <= 0:
        raise ValueError(f"quant must be positive, got {quant}")
    h = hashlib.blake2b(digest_size=16)
    for arr in arrays:
        shape, grid = _grid(arr, quant)
        h.update(np.int64(len(shape)).tobytes())
        h.update(np.asarray(shape, np.int64).tobytes())
        h.update(grid)
    return h.digest()


def request_keys(ka, kb, a, b, *, quant: float = 1e-6) -> Tuple[bytes, bytes]:
    """(support_key, full_key) for one request's kernel data and weights."""
    support = fingerprint((ka, kb), quant=quant)
    h = hashlib.blake2b(digest_size=16)
    h.update(support)
    h.update(fingerprint((a, b), quant=quant))
    return support, h.digest()


@dataclasses.dataclass(frozen=True)
class WarmHit:
    """A warm-start lookup result: cached potentials and the hit class."""

    f: np.ndarray
    g: np.ndarray
    exact: bool          # full_key matched (same weights to quantisation)


class WarmStartCache:
    """LRU of converged potentials keyed by support fingerprint.

    ``lookup`` refreshes recency; ``store`` inserts or overwrites (a
    re-solve of the same supports refreshes the stored potentials and
    weights key). The counters are plain ints, the service's stats read
    them."""

    def __init__(self, *, capacity: int = 1024, quant: float = 1e-6):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.quant = quant
        self._entries: "OrderedDict[bytes, Tuple[bytes, np.ndarray, np.ndarray]]" = OrderedDict()
        self.exact_hits = 0
        self.near_hits = 0
        self.misses = 0
        self.evictions = 0
        self.poisoned_rejects = 0       # non-finite potentials refused on put
        self.poisoned_evictions = 0     # corrupt entries evicted on get

    def __len__(self) -> int:
        return len(self._entries)

    def keys_for(self, ka, kb, a, b) -> Tuple[bytes, bytes]:
        return request_keys(ka, kb, a, b, quant=self.quant)

    def lookup(self, support_key: bytes,
               full_key: bytes) -> Optional[WarmHit]:
        entry = self._entries.get(support_key)
        if entry is None:
            self.misses += 1
            return None
        stored_full, f, g = entry
        # stored entries are sanitised to be finite, so any non-finite
        # value is corruption: evict and solve cold
        if not (np.isfinite(f).all() and np.isfinite(g).all()):
            del self._entries[support_key]
            self.poisoned_evictions += 1
            self.misses += 1
            return None
        self._entries.move_to_end(support_key)
        exact = stored_full == full_key
        if exact:
            self.exact_hits += 1
        else:
            self.near_hits += 1
        return WarmHit(f=f, g=g, exact=exact)

    def store(self, support_key: bytes, full_key: bytes, f, g,
              a=None, b=None, *, validate: bool = True) -> bool:
        """Insert converged potentials; False when validation refuses them
        (a diverged solve: NaN or +inf anywhere, or ``-inf`` on an atom
        that carries mass when the weights are given). ``-inf`` on a
        zero-weight atom is sanitised to 0 (that atom's cold start), so
        stored entries are always finite. ``validate=False`` skips all of
        it: the chaos lane's corrupted snapshot."""
        f = np.asarray(f)
        g = np.asarray(g)
        if validate:
            fin_f, fin_g = np.isfinite(f), np.isfinite(g)
            dead_f = (np.asarray(a) <= 0) if a is not None \
                else np.zeros(f.shape, bool)
            dead_g = (np.asarray(b) <= 0) if b is not None \
                else np.zeros(g.shape, bool)
            if not ((fin_f | dead_f).all() and (fin_g | dead_g).all()):
                self.poisoned_rejects += 1
                return False
            if not fin_f.all():
                f = np.where(fin_f, f, 0.0).astype(f.dtype)
            if not fin_g.all():
                g = np.where(fin_g, g, 0.0).astype(g.dtype)
        self._entries[support_key] = (full_key, f, g)
        self._entries.move_to_end(support_key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return True

    @property
    def hits(self) -> int:
        return self.exact_hits + self.near_hits

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> Dict[str, float]:
        return dict(size=len(self), capacity=self.capacity,
                    exact_hits=self.exact_hits, near_hits=self.near_hits,
                    misses=self.misses, evictions=self.evictions,
                    poisoned_rejects=self.poisoned_rejects,
                    poisoned_evictions=self.poisoned_evictions,
                    hit_rate=self.hit_rate)
