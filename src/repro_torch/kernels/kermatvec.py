"""Scaling-space Sinkhorn operators: wrappers of ``csrc/kermatvec.cu``.

One half-step ``v <- b / (Zeta (Xi^T u))`` splits into

* :func:`feature_contract` — ``t = Xi^T u``, (n, r), (n, B) -> (r, B), a
  reduction over n. On the card: one cooperative launch of at most one
  wave, each CTA a slab of rows split into row groups, its partial sums
  into a ``(splits, r, B)`` scratch buffer that the grid adds after a grid
  barrier in a fixed order (no atomics, so reruns are bit-identical);
  :func:`_contract_plan` is its geometry, in plain Python;
* :func:`sinkhorn_halfstep` — ``out = marg / (Xi t)``, the matvec and the
  marginal divide fused, shape (n, B);
* :func:`feature_matvec` — ``out = Xi t`` without the divide (the
  convergence check's column marginal, and the u-update under momentum).
  Both run one row kernel, a persistent grid of at most one wave whose
  warps take batches of consecutive rows in turn; on the 16-byte path t
  sits in registers and a warp reduces the rows of a batch at once;
  :func:`_rows_plan` is its geometry, in plain Python.

``xi`` is stored as float32 or bfloat16 (``precision="bf16"``); the kernels
widen it on load and accumulate in float32, as the plain versions do. Any
B >= 1 runs; off the register path the row kernel keeps ``t`` (r x B
float32) in shared memory, so ``r * B * 4`` bytes must fit one CTA.
Counterpart of ``repro.kernels.kermatvec``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from . import build
from .backend import check_operand, sm_count
from .logmatvec import MAX_COLS, _vectorized
from .ref import (
    feature_contract_ref,
    feature_matvec_ref,
    sinkhorn_halfstep_ref,
)

__all__ = ["feature_contract", "sinkhorn_halfstep", "feature_matvec"]

_ROW_WARPS = 8                  # kRowWarps: warps of a row-kernel CTA
_ROW_VECTORS = 8                # kRowVectors: 16-byte loads in flight a lane
_MAX_T_VECTORS = 4              # vectors of t a lane holds: R >= 2 rows
_MAX_SMEM = 227 * 1024          # dynamic shared memory of one CTA (t)
_FLAT_THREADS = 256             # kFlatThreads: threads of a contract CTA
_MIN_SLAB_ROWS = 16             # rows of the smallest contract slab
_SLABS_PER_SM = 2


class ContractPlan(NamedTuple):
    vec: bool               # 16-byte loads (B = 1, 16-byte rows)
    width: int              # columns a slot: 16 / element size, or 1
    tile: int               # slots (vectors or columns) of a row group
    groups: int             # row groups of a CTA
    col_tiles: int          # blockIdx.y
    chunks: int             # blockIdx.z: kMaxCols columns of u each
    splits: int             # blockIdx.x: slabs of rows
    rows_per_split: int

    @property
    def grid(self) -> int:
        return self.splits * self.col_tiles * self.chunks

    def slab(self, split: int) -> Tuple[int, int]:
        """Rows [begin, end) of ``split`` (before clipping to n)."""
        return split * self.rows_per_split, (split + 1) * self.rows_per_split


def _contract_plan(n: int, r: int, B: int, vec: bool, element_size: int,
                   sms: int, blocks_per_sm: int) -> ContractPlan:
    """The flat contract's geometry for an (n, r) factor of
    ``element_size`` bytes and B columns of u, on a card of ``sms`` SMs
    with ``blocks_per_sm`` contract CTAs resident on each: two slabs an
    SM (one, four measured slower at n = 16384), fewer where a slab would
    be under 16 rows, every slab non-empty, never more CTAs than one wave
    (with more than one split the grid meets at a grid barrier, so it must
    be resident at once)."""
    width = 16 // element_size if vec else 1
    if vec and (B != 1 or r % width):
        raise ValueError(f"the 16-byte path takes B = 1 and rows of a "
                         f"multiple of 16 bytes; got r={r}, B={B}")
    slots = r // width
    col_tiles = -(-slots // _FLAT_THREADS)
    tile = -(-slots // col_tiles)
    groups = _FLAT_THREADS // tile
    chunks = 1 if vec else -(-B // MAX_COLS)
    per_tile = max(1, (sms * blocks_per_sm) // (col_tiles * chunks))
    splits = max(1, min(per_tile, _SLABS_PER_SM * sms, n // _MIN_SLAB_ROWS))
    rows = -(-n // splits)
    splits = -(-n // rows)
    return ContractPlan(vec, width, tile, groups, col_tiles, chunks, splits,
                        rows)


def _flat_vectorized(xi: torch.Tensor, B: int) -> bool:
    """Whether the contract takes its 16-byte path: one column (the
    solvers' B = 1), rows of a multiple of 16 bytes and a 16-byte aligned
    factor. Row groups fill the CTA at any r, so unlike the log contract's
    rule (``logmatvec._contract_vectorized``) no r is left to the scalar
    path."""
    return _vectorized(xi, B)


class RowsPlan(NamedTuple):
    nv: int                 # 16-byte vectors of t a lane holds (0: t in smem)
    rows: int               # R: rows a warp reduces at once
    smem: int               # dynamic shared memory of a CTA (t), bytes
    grid: int               # CTAs of _ROW_WARPS warps

    def warp_rows(self, warp: int, n: int) -> List[int]:
        """The rows ``warp`` computes, in its order (as feature_rows_kernel
        deals them): of the b batches of R rows, warp w of W takes w, w + W,
        ..."""
        mine = range(warp, -(-n // self.rows), self.grid * _ROW_WARPS)
        return [j for b in mine
                for j in range(b * self.rows, min(n, (b + 1) * self.rows))]


def _rows_kernel(r: int, B: int, vec: bool,
                 element_size: int) -> Tuple[int, int, int]:
    """(nv, rows, smem) of the row kernel for rows of r elements of
    ``element_size`` bytes and B columns of t: on the 16-byte path
    (``vec``: B = 1, 16-byte rows), t in registers, nv vectors a lane (the
    power of two covering r / V / 32), and R = 8 / nv rows a batch, so a
    lane keeps 8 loads in flight, where nv is at most ``_MAX_T_VECTORS``
    (float r <= 512, bf16 r <= 1024); otherwise t in shared memory and a
    row a warp. At one row a batch (float r = 1024, nv = 8) t in registers
    read 1-2% slower than t in shared memory on an H100: it costs
    registers, so CTAs an SM, and leaves a warp one row in flight."""
    width = 16 // element_size
    if vec and (B != 1 or r % width):
        raise ValueError(f"the 16-byte path takes B = 1 and rows of a "
                         f"multiple of 16 bytes; got r={r}, B={B}")
    if vec:
        slots = -(-(r // width) // 32)
        nv = 1 << (slots - 1).bit_length()
        if nv <= _MAX_T_VECTORS:
            return nv, _ROW_VECTORS // nv, 0
    return 0, 1, 4 * r * B


def _rows_plan(n: int, r: int, B: int, vec: bool, element_size: int,
               sms: int, blocks_per_sm: int) -> RowsPlan:
    """The row kernel's geometry on a card of ``sms`` SMs where
    ``blocks_per_sm`` CTAs of the chosen kernel (``_rows_kernel``) are
    resident: at most one wave, and never more CTAs than batches of R rows
    fill. The W warps take the batches in turn, so the kernel runs
    ceil(batches / W) rounds; of the CTAs an SM that fit, the plan takes
    the one that leaves the fewest warp-batch slots of those rounds idle
    (the most CTAs among equals): at n = 16384, bf16 r = 1024, three an SM
    would run 3 rounds, the last 59% full, two an SM 4 rounds 97% full."""
    nv, rows, smem = _rows_kernel(r, B, vec, element_size)
    batches = -(-n // rows)

    def grid_of(per_sm):
        return max(1, min(sms * per_sm, -(-batches // _ROW_WARPS)))

    def slots(per_sm):
        warps = grid_of(per_sm) * _ROW_WARPS
        return -(-batches // warps) * warps

    per_sm = min(range(1, max(1, blocks_per_sm) + 1),
                 key=lambda b: (slots(b), -b))
    return RowsPlan(nv, rows, smem, grid_of(per_sm))


@functools.cache
def _lib():
    lib = build.load("kermatvec")
    c = lib.feature_contract_launch
    c.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    c.restype = ctypes.c_int
    o = lib.feature_contract_occupancy
    o.argtypes = [ctypes.c_int] * 2
    o.restype = ctypes.c_int
    h = lib.sinkhorn_halfstep_launch
    h.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    h.restype = ctypes.c_int
    v = lib.feature_matvec_launch
    v.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    v.restype = ctypes.c_int
    ro = lib.feature_rows_occupancy
    ro.argtypes = [ctypes.c_int] * 4
    ro.restype = ctypes.c_int
    return lib


@functools.cache
def _blocks_per_sm(device_index: int, bf16: bool, vec: bool) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().feature_contract_occupancy(int(bf16), int(vec))
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "feature_contract")
    return blocks


@functools.cache
def _rows_blocks_per_sm(device_index: int, bf16: bool, divide: bool, nv: int,
                        smem: int) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().feature_rows_occupancy(int(bf16), int(divide), nv,
                                               smem)
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "feature_rows")
    return blocks


# Launch options chip_smoke.py times: ``combine=False`` stops the contract
# after the slabs' partials, so t is NOT formed (it times the slabs apart
# from the grid barrier and the combine); ``stream=True`` reads the row
# kernels' factor with evict-first loads. The wrappers never do: a solve
# contracts the same factor right after its row kernel, and an iteration
# in that order read 5% slower with them at float32 r = 1024 and 18% at
# bf16 r = 1024 on an H100, where the L2 drops those lines first.
_FORCE = {"combine": True, "stream": False}


def feature_contract(xi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """t = Xi^T u, shape (r, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.feature_contract_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(u, "u", 2, dev)
    n, r = xi.shape
    B = u.shape[1]
    if u.shape[0] != n:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, u "
                         f"{tuple(u.shape)}")
    if dev.type == "cpu":
        return feature_contract_ref(xi, u)
    if min(n, r, B) < 1:
        raise ValueError(f"feature_contract kernel takes n, r, B >= 1, got "
                         f"n={n}, r={r}, B={B}")
    bf16 = xi.dtype == torch.bfloat16
    vec = _flat_vectorized(xi, B)
    plan = _contract_plan(n, r, B, vec, xi.element_size(), sm_count(dev),
                          _blocks_per_sm(dev.index, bf16, vec))
    t = torch.empty((r, B), dtype=torch.float32, device=dev)
    partial = (torch.empty((plan.splits, r, B), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().feature_contract_launch(
            xi.data_ptr(), int(bf16), u.data_ptr(), partial.data_ptr(),
            t.data_ptr(), n, r, B, plan.splits, plan.rows_per_split,
            plan.tile, plan.groups, plan.col_tiles, plan.chunks, int(vec),
            int(_FORCE["combine"]), stream)
    build.check_launch(_lib(), code, "feature_contract")
    feature_contract.launches += 1
    return t


def _check_rows(xi, t, what):
    n, r = xi.shape
    B = t.shape[1]
    if min(n, r, B) < 1 or r * B * 4 > _MAX_SMEM:
        raise ValueError(f"{what} kernel takes n, r, B >= 1 and r * B * 4 "
                         f"<= {_MAX_SMEM} bytes of t; got n={n}, r={r}, B={B}")


def _launch_rows(xi, t, marg, what):
    """Plan and launch the row kernel (the half-step where ``marg`` is
    given, else the matvec); returns out (n, B)."""
    _check_rows(xi, t, what)
    dev = xi.device
    n, r = xi.shape
    B = t.shape[1]
    bf16 = xi.dtype == torch.bfloat16
    vec = _vectorized(xi, B)
    nv, _, smem = _rows_kernel(r, B, vec, xi.element_size())
    plan = _rows_plan(n, r, B, vec, xi.element_size(), sm_count(dev),
                      _rows_blocks_per_sm(dev.index, bf16, marg is not None,
                                          nv, smem))
    out = torch.empty((n, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        shape = (n, r, B, int(vec), plan.nv, plan.grid,
                 int(_FORCE["stream"]), stream)
        if marg is None:
            code = _lib().feature_matvec_launch(
                xi.data_ptr(), int(bf16), t.data_ptr(), out.data_ptr(), *shape)
        else:
            code = _lib().sinkhorn_halfstep_launch(
                xi.data_ptr(), int(bf16), t.data_ptr(), marg.data_ptr(),
                out.data_ptr(), *shape)
    build.check_launch(_lib(), code, what)
    return out


def sinkhorn_halfstep(xi: torch.Tensor, t: torch.Tensor,
                      marg: torch.Tensor) -> torch.Tensor:
    """out = marg / (Xi t), shape (n, B), float32 (IEEE divide).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.sinkhorn_halfstep_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    check_operand(marg, "marg", 2, dev)
    n, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r or tuple(marg.shape) != (n, B):
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}, marg {tuple(marg.shape)}")
    if dev.type == "cpu":
        return sinkhorn_halfstep_ref(xi, t, marg)
    out = _launch_rows(xi, t, marg, "sinkhorn_halfstep")
    sinkhorn_halfstep.launches += 1
    return out


def feature_matvec(xi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out = Xi t, shape (n, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.feature_matvec_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    n, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}")
    if dev.type == "cpu":
        return feature_matvec_ref(xi, t)
    out = _launch_rows(xi, t, None, "feature_matvec")
    feature_matvec.launches += 1
    return out


feature_contract.launches = 0
sinkhorn_halfstep.launches = 0
feature_matvec.launches = 0
