"""Fused Gaussian positive-feature map (Lemma 1): wrapper of ``csrc/feature_map.cu``.

    log Xi[i, k] = log_const[k] - 2/eps ||x_i - u_k||^2
                 = u2c[k] - 2/eps x2[i] + 4/eps <x_i, u_k>

The kernel fuses the rank-1 terms ``x2`` and ``u2c`` (summed in the order
of the plain version's ``torch.sum``, so they are bit-identical to it),
the dot products, the norm epilogue and, unless ``log_space``, the
``exp``: the (n, r) squared-distance matrix never reaches device memory.
Its grid is persistent (about one wave of CTAs walking the row tiles), so
any n runs, and the d axis is a loop inside each CTA, so any point
dimension runs fused (the JAX package's ``fused_map_max_d`` refusal has no
counterpart here). :func:`_map_plan` is the launch geometry, in plain
Python. Counterpart of ``repro.kernels.feature_map``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import autotune, build
from .backend import check_operand, l2_bytes, sm_count
from .ref import gaussian_feature_map_ref

__all__ = ["gaussian_feature_map"]

_THREADS = 256                  # kThreads in csrc/feature_map.cu
_MAX_TILE_ROWS = 256            # kMaxTileRows: rows of a tile
_MAX_REPS = 4                   # kMaxReps: rows of a tile per thread
_MAX_COLS4 = 32                 # kMaxCols4: 4-column groups of a tile
_REGISTER_DEPTHS = (4, 8, 16)   # the register kernels' d budgets
_WIDE = len(_REGISTER_DEPTHS)   # kernel index of the shared-memory kernel
_SMEM_BUDGET = 96 * 1024        # the wide kernel's anchors in shared memory


# Launch options chip_smoke.py times against each other: None = the
# planner's choice. ``stream``: evict-first stores.
_FORCE = {"stream": None}


class MapPlan(NamedTuple):
    kernel: int             # 0-2: anchors in registers (d <= 4, 8, 16); 3: wide
    cols4: int              # 4-column groups a tile (a power of 2 <= 32)
    reps: int               # rows per thread per tile
    tile_rows: int          # rows a tile: (256 / cols4) * reps
    col_tiles: int
    row_tiles: int
    row_ctas: int           # CTAs per column tile; grid = col_tiles * row_ctas
    smem: int               # dynamic shared memory of the wide kernel, bytes
    anchors_in_smem: bool

    @property
    def grid(self) -> int:
        return self.col_tiles * self.row_ctas

    def row_tiles_of(self, cta: int) -> range:
        """The row tiles CTA ``cta`` writes, in order."""
        return range(cta // self.col_tiles, self.row_tiles, self.row_ctas)


def _map_kernel(d: int) -> int:
    for kernel, depth in enumerate(_REGISTER_DEPTHS):
        if d <= depth:
            return kernel
    return _WIDE


def _map_shape(r: int, d: int):
    """Everything of the plan but the grid: (kernel, cols4, reps, smem,
    anchors_in_smem)."""
    groups = -(-r // 4)
    cols4 = min(_MAX_COLS4, 1 << (groups - 1).bit_length())
    kernel = _map_kernel(d)
    smem, in_smem = 0, False
    if kernel == _WIDE:
        while cols4 > 1 and d * 16 * cols4 > _SMEM_BUDGET:
            cols4 //= 2
        in_smem = d * 16 * cols4 <= _SMEM_BUDGET
        smem = d * 16 * cols4 if in_smem else 0
    reps = min(_MAX_REPS, _MAX_TILE_ROWS * cols4 // _THREADS)
    return kernel, cols4, reps, smem, in_smem


def _map_plan(n: int, r: int, d: int, sms: int, blocks_per_sm: int, *,
              row_ctas: int = 0) -> MapPlan:
    """The launch geometry for an (n, d) x (r, d) map on a card of ``sms``
    SMs where ``blocks_per_sm`` CTAs of the chosen kernel are resident: a
    wave of CTAs over the row tiles, or ``row_ctas`` (the autotuner's
    knob, at most the row tiles) per column tile."""
    kernel, cols4, reps, smem, in_smem = _map_shape(r, d)
    tile_rows = _THREADS // cols4 * reps
    col_tiles = -(-(-(-r // 4)) // cols4)     # ceil(ceil(r / 4) / cols4)
    row_tiles = -(-n // tile_rows)
    wave = max(1, sms * blocks_per_sm)
    row_ctas = max(1, min(row_tiles, row_ctas or wave // col_tiles))
    return MapPlan(kernel, cols4, reps, tile_rows, col_tiles, row_tiles,
                   row_ctas, smem, in_smem)


def _map_of(ext: dict, row_ctas: int = 0) -> MapPlan:
    return _map_plan(ext["n"], ext["r"], ext["d"], ext["sms"], ext["bps"],
                     row_ctas=row_ctas)


@functools.cache
def _lib():
    lib = build.load("feature_map")
    fn = lib.gaussian_feature_map_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.gaussian_feature_map_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int
    return lib


@functools.cache
def _blocks_per_sm(device_index: int, kernel: int, smem: int) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().gaussian_feature_map_occupancy(kernel, smem)
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "gaussian_feature_map")
    return blocks


def gaussian_feature_map(x: torch.Tensor, anchors: torch.Tensor,
                         log_const: torch.Tensor, *, inv_eps: float,
                         log_space: bool = False) -> torch.Tensor:
    """Xi (or log Xi with ``log_space=True``), shape (n, r), float32.

    ``x`` (n, d), ``anchors`` (r, d), ``log_const`` (r,) float32 on one
    device. On a CUDA tensor this launches the kernel; on a CPU tensor it
    runs :func:`~repro_torch.kernels.ref.gaussian_feature_map_ref`.
    """
    dev = x.device
    check_operand(x, "x", 2, dev)
    check_operand(anchors, "anchors", 2, dev)
    check_operand(log_const, "log_const", 1, dev)
    n, d = x.shape
    r = anchors.shape[0]
    if anchors.shape[1] != d or log_const.shape[0] != r:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, anchors "
            f"{tuple(anchors.shape)}, log_const {tuple(log_const.shape)}")
    if dev.type == "cpu":
        return gaussian_feature_map_ref(x, anchors, log_const,
                                        inv_eps=inv_eps, log_space=log_space)
    if min(n, r, d) < 1 or n >= 2**31 or r >= 2**31:
        raise ValueError(f"gaussian_feature_map kernel takes 1 <= n, r < "
                         f"2**31 and d >= 1; got n={n}, r={r}, d={d}")
    kernel, _, _, smem, _ = _map_shape(r, d)
    ext = dict(n=n, r=r, d=d, sms=sm_count(dev),
               bps=_blocks_per_sm(dev.index, kernel, smem))
    knobs = autotune.resolve("feature_map", ext, x.dtype, dev)
    out = _launch_map(x, anchors, log_const, inv_eps, log_space,
                      _map_of(ext, knobs["row_ctas"]))
    gaussian_feature_map.launches += 1
    return out


def _launch_map(x, anchors, log_const, inv_eps: float, log_space: bool,
                plan: MapPlan) -> torch.Tensor:
    """Launch the feature map at ``plan``; returns its (n, r) output."""
    dev = x.device
    n, d = x.shape
    r = anchors.shape[0]
    out = torch.empty((n, r), dtype=torch.float32, device=dev)
    stream_store = (4.0 * n * r > l2_bytes(dev) if _FORCE["stream"] is None
                    else _FORCE["stream"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().gaussian_feature_map_launch(
            x.data_ptr(), anchors.data_ptr(), log_const.data_ptr(),
            out.data_ptr(), n, r, d, plan.kernel, plan.cols4, plan.reps,
            plan.col_tiles, plan.row_tiles, plan.row_ctas, plan.smem,
            int(plan.anchors_in_smem), 2.0 * inv_eps, 4.0 * inv_eps,
            int(bool(log_space)), int(r % 4 == 0), int(bool(stream_store)),
            stream)
    build.check_launch(_lib(), code, "gaussian_feature_map")
    return out


def _map_runner(ext, dtype, device):
    x = torch.full((ext["n"], ext["d"]), 0.1, device=device)
    anchors = torch.full((ext["r"], ext["d"]), -0.1, device=device)
    log_const = torch.zeros((ext["r"],), device=device)
    return lambda knobs: _launch_map(x, anchors, log_const, 1.0, True,
                                     _map_of(ext, knobs["row_ctas"]))


def _map_neighbours(ext, prior):
    return autotune.halved_doubled(prior, "row_ctas", 1,
                                   _map_of(ext).row_tiles)


autotune.register_planner("feature_map", autotune.Planner(
    ("row_ctas",), lambda ext: {"row_ctas": _map_of(ext).row_ctas},
    _map_neighbours))
autotune.register_runner("feature_map", _map_runner)

gaussian_feature_map.launches = 0
