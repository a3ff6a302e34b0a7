"""FLOP, byte, memory and collective counts of one step, and its roofline.

The port's counterpart of both ``repro.launch.hlo_analysis`` (the
hardware model, the collectives' ring factors and the roofline terms) and
``repro.launch.hlo_loops`` (the loop-aware FLOP and collective counts).
There is no HLO to parse: :class:`StepCounter` is a ``TorchDispatchMode``
that sees every op a step dispatches, on real tensors or on the fake
tensors of a dry run (``launch.dryrun``).

Loop awareness comes free in eager mode: a loop's body dispatches on every
trip (the layers, the micro-batches, the chunked losses, the Sinkhorn
iterations: a dry run's solve runs its check blocks up to ``max_iter``,
``core.sinkhorn.is_dry``), so nothing is multiplied by a trip count. That
is how the port answers ``hlo_loops``, whose ``_trip_count`` reads the
largest constant of a loop's condition.

What the counter records, per device:

* **dot FLOPs**, by the reference's rule (``hlo_loops.analyze_hlo``): a
  matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``: what ``einsum``, ``matmul`` and ``linear`` reach) counts
  2 * numel(out) * K, K its contracted extent; a convolution counts
  2 * numel(out), the reference's lower bound. ``raw_flops`` is the count
  of ``torch.utils.flop_counter.FlopCounterMode``'s table, the nearest
  counterpart of XLA's ``cost_analysis``.
* **HBM bytes**: each op's tensor inputs and outputs, read once and written
  once; views and collectives count nothing. An eager, unfused count: a
  fused program moves less.
* **collectives**: each ``c10d`` op under the reference's kind name, its
  result's bytes and its wire bytes by the ring factors of
  :func:`wire_bytes`, the group size the process group's ``size()``.
* **live bytes**: every storage from the op that makes it to its release
  (a weakref callback), each rounded up to the card's 512-byte allocation
  unit, over the tensors handed to :meth:`StepCounter.track` (a step's
  arguments) and those made inside; ``peak_bytes`` is the most at once.

A size that depends on the data (a dry run's ``nonzero``, an unbacked
symbol of its ``ShapeEnv``) is counted at its upper bound.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = [
    "HW",
    "CollectiveStats",
    "StepCounter",
    "wire_bytes",
    "roofline_terms",
    "report",
]

ALLOC_UNIT = 512            # the CUDA caching allocator's rounding, bytes


@dataclasses.dataclass(frozen=True)
class HW:
    """One card: the data sheet of the NVIDIA H100 80GB HBM3 (SXM5, 700 W).

    One link rate stands for every mesh axis, as in the reference. A 16 x
    16 mesh spans 32 nodes of 8 cards, so most of its axes cross nodes
    (InfiniBand, ~50 GB/s a card) where this term assumes NVLink: the
    collective term is a lower bound there."""

    peak_flops: float = 989.4e12      # bf16 dense tensor core, H100 SXM5 700 W
    hbm_bw: float = 3.35e12           # B/s, HBM3, H100 SXM5 80GB
    link_bw: float = 450e9            # B/s, NVLink 4 per direction, H100 SXM5
    hbm_bytes: int = 80 * 2 ** 30     # the card's HBM, H100 80GB


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]   # result bytes (per device)
    wire_bytes: float                 # ring-model bytes on the wire / device


def wire_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """The ring model's bytes on the wire a device for a collective of
    ``kind`` whose result is ``result_bytes`` over ``group_size`` ranks
    (the reference's factors)."""
    g = group_size
    frac = (g - 1) / max(g, 1)
    if kind == "all-gather":
        return result_bytes * frac        # result is the gathered buffer
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)     # result is the scattered shard
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac  # ring RS+AG
    if kind == "all-to-all":
        return result_bytes * frac
    return result_bytes                   # collective-permute


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    wire_bytes_per_device: float,
    hw: HW = HW(),
) -> Dict[str, float]:
    """The three roofline terms, in seconds (per step, per device)."""
    compute_s = flops_per_device / hw.peak_flops
    memory_s = hbm_bytes_per_device / hw.hbm_bw
    collective_s = wire_bytes_per_device / hw.link_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }


def size_hint(n) -> int:
    """An int, or a symbolic size at its upper bound."""
    if isinstance(n, torch.SymInt):
        node = n.node
        return int(node.shape_env.bound_sympy(node.expr).upper)
    return int(n)


def _numel(t: torch.Tensor) -> int:
    return size_hint(t.numel())


def _nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


_aten = torch.ops.aten
# K of a product: the rhs's contracted extent (mm, bmm, mv, dot: the
# second argument; addmm, baddbmm: the third, after the bias)
_DOTS = {
    _aten.mm: lambda a: a[1].shape[-2],
    _aten.bmm: lambda a: a[1].shape[-2],
    _aten.addmm: lambda a: a[2].shape[-2],
    _aten.baddbmm: lambda a: a[2].shape[-2],
    _aten.mv: lambda a: a[1].shape[0],
    _aten.dot: lambda a: a[1].shape[0],
}
_CONVS = (_aten.convolution,)

# c10d op -> the reference's kind; the result is the op's first argument
_COLLECTIVES = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}
# ops that move no bytes: a view by another name, and allocations
_NO_TRAFFIC = {_aten._unsafe_view, _aten.empty, _aten.empty_like,
               _aten.empty_strided, _aten.new_empty}
# a receive is the other end of a send's permute: it adds nothing
_SILENT = {"recv_", "recv_any_source_", "barrier", "monitored_barrier_"}


def _group_size(func, args, kwargs) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "process_group":
            pg = args[i] if i < len(args) else kwargs[arg.name]
            return int(ProcessGroup.unbox(pg).size())
    raise ValueError(f"{func} takes no process group")


class StepCounter(TorchDispatchMode):
    """Counts every op dispatched inside it (see the module doc). Enter it
    around one step, after :meth:`track` of the step's arguments::

        counter = StepCounter()
        counter.track((params, opt_state, batch))
        with counter:
            out = step(params, opt_state, batch)
    """

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.raw_flops = 0.0
        self.hbm_bytes = 0.0
        self.counts: Dict[str, int] = {}
        self.result_bytes: Dict[str, float] = {}
        self.wire_bytes = 0.0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.tracked_bytes = 0
        self.dot_by_op: Dict[str, float] = {}     # dot FLOPs by op name
        self._refs: Dict[int, weakref.ref] = {}

    # -- memory ---------------------------------------------------------

    def _free(self, key: int, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live_bytes -= n

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live from now until it is released;
        returns its bytes (0 if it was counted already)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return 0
        n = -(-size_hint(st.nbytes()) // ALLOC_UNIT) * ALLOC_UNIT
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (a step's arguments) as live;
        returns the bytes of the storages not counted before."""
        n = sum(self._hold(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))
        self.tracked_bytes += n
        return n

    def storage_bytes(self, tree, exclude=None) -> int:
        """The bytes of the distinct storages of ``tree``'s tensors (less
        those of ``exclude``), rounded as :meth:`track` rounds them."""
        skip = {id(t.untyped_storage()) for t in tree_leaves(exclude)
                if isinstance(t, torch.Tensor)}
        seen, total = set(), 0
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            key = id(t.untyped_storage())
            if key in seen or key in skip:
                continue
            seen.add(key)
            nb = size_hint(t.untyped_storage().nbytes())
            total += -(-nb // ALLOC_UNIT) * ALLOC_UNIT
        return total

    # -- results --------------------------------------------------------

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.result_bytes),
                               self.wire_bytes)

    def roofline(self, hw: HW = HW()) -> Dict[str, float]:
        return roofline_terms(self.dot_flops, self.hbm_bytes,
                              self.wire_bytes, hw)

    # -- dispatch -------------------------------------------------------

    def _collective(self, func, args, kwargs) -> None:
        name = func._opname
        if name in _SILENT:
            return
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"no collective kind for c10d.{name}")
        kind = _COLLECTIVES[name]
        result = sum(_nbytes(t) for t in tree_leaves(args[0])
                     if isinstance(t, torch.Tensor))
        g = _group_size(func, args, kwargs)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0.0) + result
        self.wire_bytes += wire_bytes(kind, result, g)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        self.ops += 1
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
            return out
        packet = func.overloadpacket
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if packet in _DOTS or packet in _CONVS:
            k = size_hint(_DOTS[packet](args)) if packet in _DOTS else 1
            f = 2.0 * _numel(outs[0]) * k
            self.dot_flops += f
            key = str(packet)
            self.dot_by_op[key] = self.dot_by_op.get(key, 0.0) + f
        if packet in flop_registry:
            self.raw_flops += size_hint(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view:
            if packet not in _NO_TRAFFIC:
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                self.hbm_bytes += sum(_nbytes(t) for t in ins) + \
                    sum(_nbytes(t) for t in outs)
            for t in outs:
                self._hold(t)
        return out


def report(counter: StepCounter, hw: HW = HW()) -> Dict[str, object]:
    """The counter's numbers under the reference's JSON names (the loop-
    aware and the raw HBM and wire counts are one: every trip dispatches)."""
    coll = counter.collectives
    return {
        "flops_per_device": counter.dot_flops,
        "flops_per_device_raw": counter.raw_flops,
        "hbm_bytes_per_device": counter.hbm_bytes,
        "hbm_bytes_per_device_raw": counter.hbm_bytes,
        "collective_counts": dict(coll.counts),
        "collective_result_bytes": dict(coll.bytes_by_kind),
        "wire_bytes_per_device": coll.wire_bytes,
        "wire_bytes_per_device_raw": coll.wire_bytes,
        "roofline": counter.roofline(hw),
    }
