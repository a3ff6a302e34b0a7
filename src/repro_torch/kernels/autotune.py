"""Measured launch-geometry autotuner for the CUDA kernels.

The planners of the kernel modules (``feature_map._map_plan``,
``kermatvec._contract_plan`` / ``_rows_plan``, ``logmatvec._contract_plan``
/ ``_halfstep_plan``, ``paged._paged_plan``, ``fused_loop._block_plan``)
choose each launch's geometry from the shape and the card: CTAs over rows,
slabs of a contract, CTAs an SM of a row kernel, the megakernels' cluster
size. One rule cannot be right at every (shape, dtype, card), so this
module makes the planner's answer the tuner's PRIOR rather than the
policy, as the JAX package's ``kernels/autotune.py`` does for its Pallas
block shapes (which have no meaning on the card; its knobs are these):

* deterministic by default: :func:`resolve` returns exactly the planner's
  plan (its knobs), times nothing and writes nothing, so every launch and
  every result bit is what the planner gives. Tuning is opt-in
  (``REPRO_TORCH_TUNE=1``, :func:`configure` or :func:`tuning`);
* with tuning on, the first resolve of a key times the candidates (the
  prior first, then its neighbours: one knob halved or doubled, clamped,
  and for a contract its one-slab plan, which needs no grid barrier; at
  most 8) on synthetic device buffers of the key's extents, by CUDA
  events, the median of 5 batches of 10 launches after a warmup, each
  batch queued behind a device spin so the events see device time; the
  winner is kept in memory and in a version-stamped JSON cache
  (``~/.cache/repro_torch/tuning.json``, or ``REPRO_TORCH_TUNING_CACHE``),
  which tolerates corrupt and stale files and survives an unwritable
  directory (the in-process winner is kept). The port keeps its own file
  and variables: were it to share the JAX package's, each would take the
  other's entries for a stale version and overwrite them;
* a key holds the kernel's name, the extents its planner reads (P, n, r,
  B, the element size, the 16-byte path, the SMs and the CTAs an SM that
  fit), the dtype, the card's name, SM count and compute capability and
  the cache version, so an entry written on another card never serves
  this one;
* a resolve that would time while the current stream captures a CUDA
  graph raises :class:`~repro_torch.kernels.build.KernelError`: plans
  resolve when a wrapper plans its launch, and a solve runner runs its
  first block eagerly before it captures, so a tuned plan is fixed before
  any capture;
* no candidate needs more CTAs than one wave where the kernel meets at a
  grid barrier (the cooperative launch would refuse it).

On the CPU the wrappers run their plain versions, which have no launch
geometry; :func:`resolve` there returns the static plan and counts it as
``static``. Kernel modules register their planner
(:func:`register_planner`) and a runner factory (:func:`register_runner`)
that launches the kernel once at given knobs on synthetic buffers; this
module imports them only when a kernel is first asked for, so there is no
import cycle. :func:`stats` counts ``trials`` (timed candidates),
``keys_tuned``, ``memory_hits``, ``disk_hits`` and ``static``: a run on a
warm cache makes zero trials. Counterpart of ``repro.kernels.autotune``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from .build import KernelError

__all__ = [
    "CACHE_VERSION",
    "CACHE_ENV",
    "TUNE_ENV",
    "Planner",
    "candidates",
    "cache_path",
    "card_key",
    "clear_cache",
    "configure",
    "halved_doubled",
    "pinned",
    "register_planner",
    "register_runner",
    "resolve",
    "reset_stats",
    "slab_neighbours",
    "static_plan",
    "stats",
    "tuning",
    "tuning_enabled",
]

CACHE_VERSION = 1
CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
TUNE_ENV = "REPRO_TORCH_TUNE"
_DEFAULT_CACHE = os.path.join("~", ".cache", "repro_torch", "tuning.json")
MAX_CANDIDATES = 8

# the device spin ahead of each timed batch (clock cycles), so the host has
# queued the batch before the device reaches it
_SPIN_CYCLES = 2_000_000
_BATCHES = 5
_PER_BATCH = 10


class Planner(NamedTuple):
    """A kernel's launch geometry as the tuner sees it: its ``knobs``, the
    planner's own choice (``prior(extents) -> knobs``) and the neighbours
    worth timing (``neighbours(extents, prior) -> knob dicts``, each
    already clamped to what the kernel runs)."""

    knobs: Tuple[str, ...]
    prior: Callable[[Dict[str, int]], Dict[str, int]]
    neighbours: Callable[[Dict[str, int], Dict[str, int]],
                         Iterable[Dict[str, int]]]


_PLANNERS: Dict[str, Planner] = {}
_RUNNERS: Dict[str, Callable] = {}
_PINNED: Dict[str, Dict[str, int]] = {}

_STATS = {
    "trials": 0,        # timed candidates (warmups excluded)
    "keys_tuned": 0,    # keys resolved by fresh timing
    "memory_hits": 0,   # keys served from the in-process cache
    "disk_hits": 0,     # keys served from the JSON cache
    "static": 0,        # resolves served by the planner (tuning off, CPU)
}

_CONFIG: Dict[str, Optional[object]] = {
    "deterministic": None,   # None: the environment variable decides
    "cache_path": None,      # None: the environment variable or the default
}

_MEMORY: Dict[str, Dict[str, int]] = {}
_DISK: Optional[Dict[str, Dict[str, int]]] = None   # the file, read lazily


# ---------------------------------------------------------------------------
# Configuration and counters
# ---------------------------------------------------------------------------


def configure(*, deterministic: Optional[bool] = None,
              cache_path: Optional[str] = None,
              _reset: bool = False) -> dict:
    """Set the tuner's policy and return the previous one.
    ``deterministic=False`` turns timing on; ``None`` leaves the choice to
    ``REPRO_TORCH_TUNE`` (tuning on where it is ``"1"``)."""
    previous = dict(_CONFIG)
    if _reset:
        _CONFIG.update(deterministic=None, cache_path=None)
    if deterministic is not None or _reset:
        _CONFIG["deterministic"] = deterministic
    if cache_path is not None or _reset:
        _CONFIG["cache_path"] = cache_path
        _invalidate_disk()
    return previous


def tuning_enabled() -> bool:
    det = _CONFIG["deterministic"]
    if det is not None:
        return not det
    return os.environ.get(TUNE_ENV, "0") == "1"


@contextlib.contextmanager
def tuning(*, deterministic: bool = False,
           cache_path: Optional[str] = None):
    """The tuner's policy for a scope: ``with autotune.tuning(cache_path=p):
    ...`` tunes into ``p``."""
    previous = configure(deterministic=deterministic, cache_path=cache_path)
    try:
        yield
    finally:
        _CONFIG.update(previous)
        _invalidate_disk()


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def clear_cache(*, memory: bool = True, disk_copy: bool = True) -> None:
    """Drop the in-process caches; ``disk_copy`` also forgets the file's
    contents, so the next resolve reads the file again (a fresh process)."""
    if memory:
        _MEMORY.clear()
    if disk_copy:
        _invalidate_disk()


def cache_path() -> str:
    path = _CONFIG["cache_path"] or os.environ.get(CACHE_ENV) \
        or _DEFAULT_CACHE
    return os.path.expanduser(str(path))


def register_planner(kernel: str, planner: Planner) -> None:
    """Register a kernel's :class:`Planner` (the kernel modules do, at
    import)."""
    _PLANNERS[kernel] = planner


def register_runner(kernel: str, factory: Callable) -> None:
    """Register ``factory(extents, dtype, device) -> run(knobs)`` for a
    kernel: ``run`` launches the kernel once at ``knobs`` on synthetic
    device buffers of the extents and returns its output, counting no
    launch on the wrapper."""
    _RUNNERS[kernel] = factory


@contextlib.contextmanager
def pinned(kernel: str, **knobs: int):
    """Explicit knobs for a scope: every resolve of ``kernel`` returns the
    prior with ``knobs`` in place, whatever the policy, counting nothing
    (``chip_smoke.py`` holds each candidate against the plain version on
    real inputs this way)."""
    previous = _PINNED.get(kernel)
    _PINNED[kernel] = {k: int(v) for k, v in knobs.items()}
    try:
        yield
    finally:
        if previous is None:
            _PINNED.pop(kernel, None)
        else:
            _PINNED[kernel] = previous


def _planner(kernel: str) -> Planner:
    if kernel not in _PLANNERS:
        # the kernel modules register at import; importing them here, not
        # at this module's import, keeps the two free of a cycle
        from . import feature_map, fused_loop, kermatvec, logmatvec, paged  # noqa: F401
    try:
        return _PLANNERS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}; tunable: "
                         f"{sorted(_PLANNERS)}") from None


# ---------------------------------------------------------------------------
# The prior and its candidates
# ---------------------------------------------------------------------------


def static_plan(kernel: str, extents: Dict[str, int]) -> Dict[str, int]:
    """The planner's knobs for ``extents``: the deterministic plan and the
    tuner's prior."""
    return dict(_planner(kernel).prior(extents))


def candidates(kernel: str, extents: Dict[str, int],
               limit: int = MAX_CANDIDATES) -> Tuple[Dict[str, int], ...]:
    """The knob dicts timed for one key: the static plan first (so the
    measured winner never loses to the prior), then its neighbours,
    without repeats, at most ``limit``."""
    pl = _planner(kernel)
    prior = pl.prior(extents)
    plans = [dict(prior)]
    for cand in pl.neighbours(extents, prior):
        cand = {k: int(cand[k]) for k in pl.knobs}
        if cand not in plans:
            plans.append(cand)
    return tuple(plans[:limit])


# ---------------------------------------------------------------------------
# The JSON cache
# ---------------------------------------------------------------------------


def _invalidate_disk() -> None:
    global _DISK
    _DISK = None


def _valid_entries(payload) -> Dict[str, Dict[str, int]]:
    """The entries of a cache payload of this version, each a dict of int
    knobs; a corrupt payload or another version gives none."""
    entries: Dict[str, Dict[str, int]] = {}
    if (isinstance(payload, dict)
            and payload.get("version") == CACHE_VERSION
            and isinstance(payload.get("entries"), dict)):
        for key, entry in payload["entries"].items():
            knobs = entry.get("knobs") if isinstance(entry, dict) else None
            if isinstance(knobs, dict) and knobs and all(
                    isinstance(v, int) and not isinstance(v, bool)
                    for v in knobs.values()):
                entries[key] = dict(knobs)
    return entries


def _read_file() -> dict:
    try:
        with open(cache_path()) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _load_disk() -> Dict[str, Dict[str, int]]:
    global _DISK
    if _DISK is None:
        _DISK = _valid_entries(_read_file())
    return _DISK


def _persist(key: str, knobs: Dict[str, int], us: float) -> None:
    """Add ``key`` to the file (its other valid entries kept); an
    unwritable directory leaves the in-process winner only."""
    payload = _read_file()
    entries = {k: payload["entries"][k] for k in _valid_entries(payload)}
    entries[key] = {"knobs": dict(knobs), "us": round(us, 3)}
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"version": CACHE_VERSION, "entries": entries}, fh,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        return
    _load_disk()[key] = dict(knobs)


def card_key(device: torch.device) -> str:
    """The card part of a key: its name, SM count and compute capability."""
    props = torch.cuda.get_device_properties(device)
    return (f"{torch.cuda.get_device_name(device)}/sm{props.multi_processor_count}"
            f"/cc{props.major}.{props.minor}")


def _key(kernel: str, extents: Dict[str, int], dtype: torch.dtype,
         device: torch.device) -> str:
    parts = [f"{k}={int(v)}" for k, v in sorted(extents.items())]
    return "|".join([kernel, *parts, f"dtype={str(dtype)[6:]}",
                     f"card={card_key(device)}", f"v{CACHE_VERSION}"])


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _time_us(run: Callable, knobs: Dict[str, int],
             device: torch.device) -> float:
    """Device microseconds of one launch at ``knobs``: the median over
    ``_BATCHES`` batches of the mean of ``_PER_BATCH`` launches between two
    CUDA events, after a warmup."""
    with torch.cuda.device(device):
        run(knobs)
        means = []
        for _ in range(_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            for _ in range(_PER_BATCH):
                run(knobs)
            end.record()
            end.synchronize()
            means.append(start.elapsed_time(end) * 1e3 / _PER_BATCH)
    return statistics.median(means)


def _tune(kernel: str, extents: Dict[str, int], dtype: torch.dtype,
          device: torch.device, key: str) -> Dict[str, int]:
    plans = candidates(kernel, extents)
    factory = _RUNNERS.get(kernel)
    if factory is None or len(plans) == 1:
        _STATS["static"] += 1
        return plans[0]
    if torch.cuda.is_current_stream_capturing():
        raise KernelError(
            f"autotune: {kernel} would time its candidates for {key} while "
            "a CUDA graph is captured; resolve the plan before the capture "
            "(run the solve's first block eagerly)")
    run = factory(extents, dtype, device)
    timed = []
    for i, plan in enumerate(plans):
        timed.append((_time_us(run, plan, device), i))
        _STATS["trials"] += 1
    us, best = min(timed)
    _STATS["keys_tuned"] += 1
    _persist(key, plans[best], us)
    return plans[best]


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def resolve(kernel: str, extents: Dict[str, int],
            dtype: torch.dtype = torch.float32,
            device: Optional[torch.device] = None, *,
            deterministic: Optional[bool] = None) -> Dict[str, int]:
    """The knobs of one launch: pinned knobs where :func:`pinned` set
    them; else, with tuning on and on a CUDA device, the measured winner
    (in-process cache, then the JSON cache, then a timing pass); else the
    planner's own knobs. Called by the wrappers as they plan a launch."""
    pin = _PINNED.get(kernel)
    if pin is not None:
        return {**static_plan(kernel, extents), **pin}
    det = (not tuning_enabled()) if deterministic is None else deterministic
    if det or device is None or torch.device(device).type != "cuda":
        _STATS["static"] += 1
        return static_plan(kernel, extents)
    device = torch.device(device)
    key = _key(kernel, extents, dtype, device)
    hit = _MEMORY.get(key)
    if hit is not None:
        _STATS["memory_hits"] += 1
        return dict(hit)
    disk = _load_disk().get(key)
    if disk is not None and set(disk) == set(_planner(kernel).knobs):
        _STATS["disk_hits"] += 1
        _MEMORY[key] = dict(disk)
        return dict(disk)
    knobs = _tune(kernel, extents, dtype, device, key)
    _MEMORY[key] = dict(knobs)
    return dict(knobs)


def halved_doubled(prior: Dict[str, int], knob: str, lo: int,
                   hi: int) -> Iterable[Dict[str, int]]:
    """The prior with ``knob`` halved and doubled, each clamped to
    ``[lo, hi]`` (a kernel module's neighbours)."""
    p = prior[knob]
    for v in (p // 2, p * 2):
        yield {**prior, knob: max(lo, min(hi, v))}


def slab_neighbours(plan_of: Callable) -> Callable:
    """The contracts' neighbours: the slabs halved and doubled, and one
    slab (no grid barrier), each clamped by the planner ``plan_of(extents,
    splits)`` (one wave, slabs of at least 16 rows)."""
    def neighbours(extents, prior):
        for k in (*halved_doubled(prior, "splits", 1, 2 * prior["splits"]),
                  {"splits": 1}):
            yield {"splits": plan_of(extents, k["splits"]).splits}
    return neighbours
