"""Captured solve loops, one per bucket cell: the port's jit caches.

The JAX package compiles a solve once per cell and replays the executable:
``jax.jit`` caches it on the shapes and the trace-time constants, the
annealing cascade keeps one runner a stage
(``repro.core.api._donating_stage_runner``), and ``StreamingSolver`` an
LRU of runners with a retrace gate. Here a :class:`Runner` holds one
cell's loop as a CUDA graph over static buffers:

* its buffers: the plan's operands (factors, page tables), the weights,
  and the loop state of ``core.sinkhorn`` (committed carry, iteration
  count, error, stop flag, ``tol``, ``max_iter``);
* its graph and the graph's private memory pool, where every
  intermediate of the captured blocks lives at a fixed address.

A solve copies its inputs into the buffers and replays the graph until
the stop flag is set. On the card the first solve of a cell runs its first
block eagerly on a side stream (which also builds the kernels and runs
their occupancy queries) and then captures; a capture that fails raises
``KernelError``, and nothing falls back to the host loop. On the CPU a
capture records the program for eager replay, so every count below means
the same on both.

:class:`RunnerCache` is an LRU of runners keyed by :class:`CellKey`,
bounded by ``max_runners`` as the reference's ``StreamingSolver`` bounds
its runners, and by ``MAX_BYTES`` of buffers. It counts ``captures``, ``replays``, ``hits`` and
host ``reads``. Its runners share what they can: the operand buffers of
one shape and dtype (a solve copies its operands in before its replays,
so the stages of an annealing schedule hold one copy of their factors
between them) and, on the card, one memory pool for every graph (no
tensor allocated in a capture outlives it, so the graphs' intermediates
may overlap). ``RUNNERS`` is the cache of every solve that is given none;
``clear()`` frees its buffers and graphs.

The kernel wrappers count their launches as they run, so a capture would
count launches that did not happen and a replay none of those that did:
a capture takes the launches it recorded off the counters and keeps them
as the graph's launches per replay, and each replay adds them back
(``kernels.add_launches``).
"""
from __future__ import annotations

import collections
import gc
import weakref
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ..kernels import add_launches, launch_counts, set_launch_counts
from ..kernels.build import KernelError

__all__ = ["CellKey", "Runner", "RunnerCache", "RUNNERS", "MAX_BYTES"]

# The buffers a cache's runners may hold: a few cells' factors (phase 4 of
# chip_smoke.py holds 129 MiB), a small share of an 80 GB card.
MAX_BYTES = 2 << 30


class CellKey(NamedTuple):
    """What a captured loop is specialised to. ``eps`` and ``momentum``
    are passed by value into the kernels, as the reference keys its jit
    caches on them; ``tol`` and ``max_iter`` are device scalars a solve
    writes before its replays and are not part of the key."""

    mode: str                   # "scaling" or "log"
    kind: str                   # the plan's spec kind
    n: int
    m: int
    r: int
    P: int                      # problems stacked on a leading axis (0: one
                                # problem's plan, no problem axis)
    dtype: torch.dtype          # factor storage
    page_size: int              # 0 for a flat plan
    eps: float
    momentum: float
    inner: int                  # iterations a step advances
    steps_per_check: int
    blocks: int                 # check blocks a replay runs (K)
    precision: str
    device: torch.device


class Runner:
    """One cell's solve loop over static buffers (see the module doc)."""

    def __init__(self, key: CellKey, cache: "RunnerCache"):
        self.key = key
        self.buffers: Dict[str, object] = {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.program: Optional[Callable[[], None]] = None
        self.per_replay: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        self._cache = cache

    @property
    def captured(self) -> bool:
        return self.program is not None

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor in the runner's buffers."""
        todo = list(self.buffers.values())
        while todo:
            item = todo.pop()
            if isinstance(item, torch.Tensor):
                yield item
            elif isinstance(item, (tuple, list)):
                todo.extend(item)

    def capture(self, program: Callable[[], None],
                warmup: Callable[[], None]) -> bool:
        """Record ``program``, which reads and writes only this runner's
        buffers. On a card ``warmup`` runs first, eagerly on a side stream
        (its launches are real and stay counted), and the capture follows
        on that stream, into the cache's pool; returns whether ``warmup``
        ran (not on the CPU). A capture that fails raises
        :class:`~repro_torch.kernels.build.KernelError`."""
        device = self.key.device
        warmed = device.type == "cuda"
        if warmed:
            with torch.cuda.device(device):
                current = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side):
                    warmup()
                    before = launch_counts()
                    # A dropped runner sits in a reference cycle (it and
                    # its cache), so the collector frees its graph when it
                    # runs; inside a capture that call is refused and
                    # invalidates the capture. Collect first, and not
                    # during the capture.
                    gc.collect()
                    collecting = gc.isenabled()
                    gc.disable()
                    try:
                        graph.capture_begin(pool=self._cache.pool(device))
                        try:
                            program()
                        finally:
                            graph.capture_end()
                    except Exception as exc:
                        raise KernelError(
                            f"capture of the solve loop of cell {self.key} "
                            f"failed: {exc}") from exc
                    finally:
                        if collecting:
                            gc.enable()
                        after = launch_counts()
                        set_launch_counts(before)
                current.wait_stream(side)
            self.per_replay = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
            self.graph = graph
        self.program = program
        self.captures += 1
        self._cache.captures += 1
        self._cache.trim(keep=self)
        return warmed

    def replay(self) -> None:
        """Run the captured program once: a graph launch on the card (its
        kernels added to the launch counters), an eager call on the
        CPU."""
        if self.graph is not None:
            with torch.cuda.device(self.key.device):
                self.graph.replay()
            add_launches(self.per_replay)
        else:
            self.program()
        self.replays += 1
        self._cache.replays += 1


class RunnerCache:
    """LRU of :class:`Runner` s keyed by :class:`CellKey`.

    ``captures`` / ``replays`` / ``hits`` / ``reads`` count over the
    cache's life (evicted runners included); :attr:`live_captures` is the
    captures of the runners it holds, the reference's ``traces``."""

    def __init__(self, max_runners: int = 8):
        if max_runners < 1:
            raise ValueError(f"max_runners must be >= 1, got {max_runners}")
        self.max_runners = int(max_runners)
        self._runners: "collections.OrderedDict[CellKey, Runner]" = \
            collections.OrderedDict()
        self._slots: "weakref.WeakValueDictionary[tuple, torch.Tensor]" = \
            weakref.WeakValueDictionary()
        self._pools: Dict[torch.device, tuple] = {}
        self.captures = 0
        self.replays = 0
        self.hits = 0
        self.reads = 0

    def __len__(self) -> int:
        return len(self._runners)

    def keys(self) -> Tuple[CellKey, ...]:
        return tuple(self._runners)

    def get(self, key: CellKey) -> Runner:
        """The runner of ``key`` (most recently used now), a new empty one
        on a miss; the least recently used goes past ``max_runners``."""
        runner = self._runners.get(key)
        if runner is not None and runner.captured:
            self.hits += 1
            self._runners.move_to_end(key)
            return runner
        if runner is None:
            runner = Runner(key, self)
            self._runners[key] = runner
            while len(self._runners) > self.max_runners:
                self._runners.popitem(last=False)
        return runner

    def slots(self, like: Tuple[torch.Tensor, ...]
              ) -> Tuple[torch.Tensor, ...]:
        """Buffers shaped like ``like``, one a position, shared by the
        runners that ask for the same shapes and dtypes; each lives while a
        runner holds it."""
        out = []
        for i, t in enumerate(like):
            k = (i, tuple(t.shape), t.dtype, t.device)
            buf = self._slots.get(k)
            if buf is None:
                buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
                self._slots[k] = buf
            out.append(buf)
        return tuple(out)

    def pool(self, device: torch.device) -> tuple:
        """The memory pool the graphs of ``device`` capture into: the one
        the cache's live graphs share, a new one where none is live (a
        pool that no graph holds any more is released and takes no
        further captures)."""
        if not any(r.graph is not None and r.key.device == device
                   for r in self._runners.values()):
            self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    def trim(self, keep: Optional[Runner] = None) -> None:
        """Drop the least recently used runners, never ``keep``, while the
        buffers of those left hold more than ``MAX_BYTES``."""
        for key in list(self._runners):
            if self.nbytes <= MAX_BYTES:
                return
            if self._runners[key] is not keep:
                del self._runners[key]

    @property
    def nbytes(self) -> int:
        """The memory of the runners' buffers, each shared buffer once
        (their graphs' pool not included)."""
        seen = {}
        for runner in self._runners.values():
            for t in runner.tensors():
                storage = t.untyped_storage()
                seen[(t.device, storage.data_ptr())] = storage.nbytes()
        return sum(seen.values())

    @property
    def live_captures(self) -> int:
        return sum(r.captures for r in self._runners.values())

    def stats(self) -> Dict[str, int]:
        return {"runners": len(self._runners), "captures": self.captures,
                "replays": self.replays, "hits": self.hits,
                "reads": self.reads, "bytes": self.nbytes}

    def clear(self) -> None:
        """Drop every runner (their graphs and buffers)."""
        self._runners.clear()


# The solves' cache: room for an annealing schedule's stages and more (a
# stage's runner holds O(n) floats beside the factors its shape shares).
RUNNERS = RunnerCache(max_runners=64)
