"""Bucket-keyed runner cache: pre-captured, warmed-up solve loops.

The batched engine captures one CUDA graph a (stacked shape, problem
count, eps) cell at the cell's first solve (``core.runners``). For serving
that first solve, a capture of ~14 ms of host time, must not land inside a
request's latency. The runner cache pays it ahead of traffic: each
:class:`BucketRunner` is pinned to one ``(OTBatchShape, B)`` bucket cell
and solved once at build time on synthetic data, so steady-state
dispatches only replay.

Each runner owns a one-runner :class:`~repro_torch.core.runners.RunnerCache`
that its stacked solve captures into, where the JAX package gives each
runner its own ``jax.jit``: evicting a runner ``clear()``s that cache and
frees its graph and buffers, and a service with more cells than the
engine's shared cache holds, or ``solve_many`` callers sharing the engine
through ``get_engine``, never evict it.

Every dispatch passes initial potentials, zeros when cold: ``f = 0`` is
``u = 1`` and the log solver starts from zeros before pinning dead atoms,
so one capture serves cold and warm megabatches alike (``CellKey`` holds no
initial values).

Accounting: ``misses`` counts runners built, ``hits`` steady-state reuse,
and ``extra_traces`` the captures a runner made beyond its first (a key
field that drifts per call: always a bug). Runners of the plain operators
(``use_pallas=False``, the quadratic methods, ``accelerated``) capture
nothing. Counterpart of ``repro.serving.runner_cache``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..configs.shapes import OTBatchShape, ot_batch_bucket
from ..core import runners as core_runners
from ..core.api import BatchedSinkhorn
from ..core.sinkhorn import SinkhornResult
from ..kernels.backend import resolve_device

__all__ = ["BucketRunner", "RunnerCache"]


@dataclasses.dataclass(frozen=True)
class _Cell:
    """One runner's fixed shapes."""

    shape: OTBatchShape
    batch: int

    def data_shapes(self, quadratic: bool):
        n, m, r = self.shape.n_pad, self.shape.m_pad, self.shape.r
        if quadratic:
            ka = kb = (self.batch, n, m)
        else:
            ka, kb = (self.batch, n, r), (self.batch, m, r)
        return ka, kb, (self.batch, n), (self.batch, m)


class BucketRunner:
    """The solve loop of one ``(OTBatchShape, B)`` cell, captured in the
    runner's own one-runner cache (see the module doc)."""

    def __init__(self, engine: BatchedSinkhorn, shape: OTBatchShape,
                 batch: int, *, dtype=torch.float32, device=None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.engine = engine
        self.cell = _Cell(shape, batch)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.quadratic = engine.method in engine._QUADRATIC
        self.loops = core_runners.RunnerCache(max_runners=1)
        self.calls = 0
        self._warm = False

    @property
    def traces(self) -> int:
        """Captures this runner's loop made (1 after a clean warmup on a
        fused plan, 0 on the plain operators; more is a re-capture)."""
        return self.loops.captures

    def expected_shapes(self):
        return self.cell.data_shapes(self.quadratic)

    def warmup(self) -> "BucketRunner":
        """Capture and run the cell once on synthetic data that converges
        at once (a constant kernel, uniform weights, zero potentials), so
        the first real request pays neither the capture nor the first
        launches."""
        if self._warm:
            return self
        ka_s, kb_s, a_s, b_s = self.expected_shapes()
        kw = dict(dtype=self.dtype, device=self.device)
        if self.quadratic:
            ka = kb = torch.zeros(ka_s, **kw)                 # C = 0: K = 1
        elif self.engine.method == "factored":
            ka, kb = torch.ones(ka_s, **kw), torch.ones(kb_s, **kw)
        else:                                                 # log features
            ka, kb = torch.zeros(ka_s, **kw), torch.zeros(kb_s, **kw)
        a = torch.full(a_s, 1.0 / a_s[1], **kw)
        b = torch.full(b_s, 1.0 / b_s[1], **kw)
        self.engine.solve_stacked(ka, kb, a, b, torch.zeros(a_s, **kw),
                                  torch.zeros(b_s, **kw), runners=self.loops)
        self._warm = True
        return self

    def run(self, ka, kb, a, b, f0, g0) -> SinkhornResult:
        """Solve one bucket-padded megabatch; returns when the loop has
        stopped (its last host read), the result on the device."""
        expect = self.expected_shapes()
        got = tuple(tuple(x.shape) for x in (ka, kb, a, b))
        if got != expect:
            raise ValueError(
                f"runner cell {self.cell} expects shapes {expect}, got {got}")
        self.calls += 1
        return self.engine.solve_stacked(ka, kb, a, b, f0, g0,
                                         runners=self.loops)

    def close(self) -> None:
        """Free the runner's graph and buffers."""
        self.loops.clear()


class RunnerCache:
    """LRU of :class:`BucketRunner` s keyed by ``(OTBatchShape, B)``.

    ``get`` builds and warms up a runner on a miss (the only place serving
    captures happen); ``warm`` pre-plans a set of cells ahead of traffic.
    An evicted runner's graph and buffers are freed with it."""

    def __init__(self, engine: BatchedSinkhorn, *, capacity: int = 32,
                 max_batch: int = 8, dtype=torch.float32, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.capacity = capacity
        self.max_batch = max_batch
        self.dtype = dtype
        self.device = resolve_device(device)
        self._runners: "OrderedDict[Tuple[OTBatchShape, int], BucketRunner]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._runners)

    def runners(self) -> Tuple[BucketRunner, ...]:
        return tuple(self._runners.values())

    def batch_buckets(self) -> Tuple[int, ...]:
        """Every batch-count cell traffic can land in: powers of two up to
        ``max_batch``, and ``max_batch`` itself."""
        out = []
        boundary = 1
        while boundary < self.max_batch:
            out.append(boundary)
            boundary *= 2
        out.append(self.max_batch)
        return tuple(out)

    def get(self, shape: OTBatchShape, batch: int) -> BucketRunner:
        key = (shape, ot_batch_bucket(batch, self.max_batch))
        runner = self._runners.get(key)
        if runner is not None:
            self.hits += 1
            self._runners.move_to_end(key)
            return runner
        self.misses += 1
        runner = BucketRunner(self.engine, key[0], key[1], dtype=self.dtype,
                              device=self.device).warmup()
        self._runners[key] = runner
        while len(self._runners) > self.capacity:
            _, old = self._runners.popitem(last=False)
            old.close()
            self.evictions += 1
        return runner

    def warm(self, shapes: Iterable[OTBatchShape],
             batches: Optional[Iterable[int]] = None) -> int:
        """Pre-plan every (shape x batch bucket) cell; returns the runners
        built (captures paid now rather than under traffic)."""
        built = 0
        for shape in shapes:
            for b in (self.batch_buckets() if batches is None else batches):
                before = self.misses
                self.get(shape, b)
                built += self.misses > before
        return built

    @property
    def extra_traces(self) -> int:
        """Captures beyond each live runner's first: any steady-state
        re-capture shows up here."""
        return sum(max(r.traces - 1, 0) for r in self._runners.values())

    def loop_stats(self) -> Dict[str, int]:
        """The live runners' loop counters summed: captures, replays and
        host reads (``core.runners.RunnerCache.stats``)."""
        out = {"captures": 0, "replays": 0, "reads": 0}
        for r in self._runners.values():
            for k in out:
                out[k] += getattr(r.loops, k)
        return out

    def snapshot(self) -> Dict[str, float]:
        return dict(size=len(self), capacity=self.capacity,
                    hits=self.hits, misses=self.misses,
                    evictions=self.evictions,
                    extra_traces=self.extra_traces,
                    dispatches=sum(r.calls for r in self._runners.values()))
