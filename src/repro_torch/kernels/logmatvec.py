"""Log-domain factored Sinkhorn operators: wrappers of ``csrc/logmatvec.cu``.

* :func:`log_feature_contract` — stage 1 of the exact two-stage LSE,
  ``t[k, c] = LSE_i(log_w[i, k] + s[i, c])``, (n, r), (n, B) -> (r, B).
  On the card: one cooperative launch of at most one wave, the flat
  contract's row groups carried over to the LSE, each CTA's (max, sum)
  partials into a ``(splits, r, B, 2)`` scratch buffer that the grid
  combines after a grid barrier in a fixed order (no atomics, so reruns
  are bit-identical); :func:`_contract_plan` is its geometry, in plain
  Python.
* :func:`log_halfstep` — stage 2 with the log half-step fused,
  ``out = scale * (lmarg - LSE_k(log_w[:, k] + t[k, :]))``, shape (m, B).
  ``scale=eps`` is the potential update, ``scale=-1, lmarg=0`` the raw LSE.
  On the card: the scaling row kernel's persistent grid, whose warps take
  batches of rows in turn (t in registers on the 16-byte path), each row
  an exact two-pass LSE; :func:`_halfstep_plan` is its geometry, in plain
  Python.
* :func:`log_matvec` — the single-column row LSE with the exact row max,
  ``out[j] = LSE_k(log_m[j, k] + t[k])``, (m, r), (r,) -> (m,). No solver
  reaches it; ``kernels.ops.log_matvec`` exports it, as the JAX package
  does.

``log_w`` is stored as float32 or bfloat16 (``precision="bf16"``); the
kernels widen it on load and accumulate in float32, as the plain versions
do. A row or column whose entries are all ``-inf`` (dead atoms carry
``f = -inf``) gives ``-inf``, never NaN. B is small (the solvers run B = 1):
the kernels keep one running LSE per column in registers, up to
``MAX_COLS`` columns. The contract and the half-step also take P problems
stacked on a leading axis (``log_w`` (P, n, r), ``s`` (P, n, B), ``t``
(P, r, B), ``lmarg`` (P, m, B)) and serve them all in one launch, a CTA
never mixing problems (``kermatvec``'s rule). Counterpart of
``repro.kernels.logmatvec``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from . import build
from .backend import check_operand, sm_count, stacked_dims
from .ref import log_feature_contract_ref, log_halfstep_ref, log_matvec_ref

__all__ = ["MAX_COLS", "log_feature_contract", "log_halfstep", "log_matvec"]

MAX_COLS = 8                    # kMaxCols in csrc/common.cuh
_MIN_SLAB_BYTES = 16 * 2**10    # least factor bytes of a contract slab
_HALFSTEP_ROWS = 8              # rows per log_matvec CTA (one per warp)
_MAX_SMEM = 227 * 1024          # dynamic shared memory of one CTA (t)


@functools.cache
def _lib():
    lib = build.load("logmatvec")
    c = lib.log_feature_contract_launch
    c.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    c.restype = ctypes.c_int
    o = lib.log_feature_contract_occupancy
    o.argtypes = [ctypes.c_int] * 2
    o.restype = ctypes.c_int
    h = lib.log_halfstep_launch
    h.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_float]
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    h.restype = ctypes.c_int
    ho = lib.log_halfstep_occupancy
    ho.argtypes = [ctypes.c_int] * 4
    ho.restype = ctypes.c_int
    v = lib.log_matvec_launch
    v.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    v.restype = ctypes.c_int
    return lib


def _check_cols(B: int, what: str) -> None:
    if not 1 <= B <= MAX_COLS:
        raise ValueError(f"{what} kernel takes 1 <= B <= {MAX_COLS} columns, "
                         f"got {B}")


def _vec_width(log_w: torch.Tensor) -> int:
    """Elements of ``log_w`` in one 16-byte load: 4 float32 or 8 bfloat16."""
    return 16 // log_w.element_size()


def _vectorized(log_w: torch.Tensor, B: int) -> bool:
    """Whether the kernels take their 16-byte vector path: one column (the
    solvers' B = 1) and rows that start on 16-byte boundaries, which for
    2-byte bfloat16 elements needs r to be a multiple of 8."""
    return (B == 1 and log_w.shape[-1] % _vec_width(log_w) == 0
            and log_w.data_ptr() % 16 == 0)


def _contract_plan(n: int, r: int, B: int, vec: bool, element_size: int,
                   sms: int, blocks_per_sm: int, *, P: int = 1):
    """The log contract's geometry: the flat contract's
    (``kermatvec._contract_plan``: row groups that fill a 256-thread CTA
    at any r, at most one wave, two slabs an SM, none under 16 rows), with
    every slab holding at least 16 KiB of the factor (``_MIN_SLAB_BYTES``).
    So a small factor is cut into few slabs and few CTAs meet at the grid
    barrier: n = 2048, r = 128 takes 32 slabs of 64 rows in bf16, 64 of
    32 in float32 (on an H100 as fast as 8 KiB slabs and 4-5% faster
    than 32 KiB ones, PERF.md); the solve shape's 64
    MiB factor is cut by the wave, as the flat contract's. P stacked
    problems share the wave as in the flat contract's plan."""
    from .kermatvec import _contract_plan as flat_plan
    slabs = max(1, n * r * element_size // _MIN_SLAB_BYTES)
    return flat_plan(n, r, B, vec, element_size, sms, blocks_per_sm,
                     max_splits=slabs, P=P)


@functools.cache
def _blocks_per_sm(device_index: int, bf16: bool, vec: bool) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().log_feature_contract_occupancy(int(bf16), int(vec))
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "log_feature_contract")
    return blocks


class HalfstepPlan(NamedTuple):
    nv: int                 # 16-byte vectors of t a lane holds (0: t in smem)
    lanes: int              # L: lanes of a row
    group_rows: int         # Q: rows a group of L lanes takes a batch
    rows: int               # R = (32 / L) Q: rows a warp reduces at once
    smem: int               # dynamic shared memory of a CTA (t), bytes
    grid: int               # CTAs of _ROW_WARPS warps

    def warp_rows(self, warp: int, m: int) -> List[int]:
        """The rows ``warp`` computes, in its order, dealt as the row
        kernel deals them (``kermatvec.RowsPlan.warp_rows``)."""
        from .kermatvec import RowsPlan
        return RowsPlan(self.nv, self.rows, self.smem,
                        self.grid).warp_rows(warp, m)


def _halfstep_kernel(m: int, r: int, B: int, vec: bool, element_size: int,
                     sms: int, *, P: int = 1) -> Tuple[int, int, int, int]:
    """(nv, lanes, group_rows, smem) of the log half-step's kernel: the row
    kernel's t in registers, nv vectors a lane, where
    ``kermatvec._rows_kernel`` puts it there (16-byte path, nv <= 4), else
    t in shared memory and a row a warp (lanes 32, group_rows 1). On the
    register path a row of fewer than 32 vectors takes L lanes, its vector
    count rounded up to a power of two, so 32 / L rows share each load and
    no lane idles (bf16 r = 128: 16 lanes a row); each group of L lanes
    takes Q rows a batch, the most up to 8 / nv (8 loads in flight a lane)
    that still leave every SM a CTA of 8 warps with a batch each (m =
    2048, bf16 r = 128: a row a group, 1024 batches on 128 CTAs rather
    than 128 on 16); the batches of P stacked problems count together."""
    from .kermatvec import _ROW_WARPS, _rows_kernel
    nv, q, smem = _rows_kernel(r, B, vec, element_size)
    lanes = 32
    if nv:
        rv = r // (16 // element_size)
        lanes = min(32, 1 << (rv - 1).bit_length())
        while q > 1 and P * -(-m // (32 // lanes * q)) < sms * _ROW_WARPS:
            q //= 2
    return nv, lanes, q, smem


def _halfstep_plan(m: int, r: int, B: int, vec: bool, element_size: int,
                   sms: int, blocks_per_sm: int, *,
                   P: int = 1) -> HalfstepPlan:
    """The log half-step's geometry: its kernel (:func:`_halfstep_kernel`)
    on the row kernel's grid (``kermatvec._rows_grid``: at most one wave
    of the ``blocks_per_sm`` CTAs of that kernel an SM, shared by P stacked
    problems, a problem's warps taking its batches of R = (32 / L) Q rows
    in turn)."""
    from .kermatvec import _rows_grid
    nv, lanes, q, smem = _halfstep_kernel(m, r, B, vec, element_size, sms,
                                          P=P)
    rows = 32 // lanes * q
    return HalfstepPlan(nv, lanes, q, rows, smem,
                        _rows_grid(-(-m // rows), sms, blocks_per_sm, P=P))


@functools.cache
def _halfstep_blocks_per_sm(device_index: int, bf16: bool, nv: int, q: int,
                            smem: int) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().log_halfstep_occupancy(int(bf16), nv, q, smem)
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "log_halfstep")
    return blocks


def log_feature_contract(log_w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t[k, c] = LSE_i(log_w[i, k] + s[i, c]), shape (r, B), float32;
    (P, r, B) for P stacked problems (``log_w`` (P, n, r), ``s`` (P, n,
    B)), in one launch.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_feature_contract_ref`."""
    dev = log_w.device
    nd = stacked_dims(log_w, "log_w")
    check_operand(log_w, "log_w", nd, dev, factor=True)
    check_operand(s, "s", nd, dev)
    n, r = log_w.shape[-2:]
    B = s.shape[-1]
    if s.shape[:-1] != log_w.shape[:-1]:
        raise ValueError(f"shape mismatch: log_w {tuple(log_w.shape)}, s "
                         f"{tuple(s.shape)}")
    if dev.type == "cpu":
        return log_feature_contract_ref(log_w, s)
    _check_cols(B, "log_feature_contract")
    lead = tuple(log_w.shape[:-2])
    P = lead[0] if lead else 1
    if min(P, n, r) < 1:
        raise ValueError(f"log_feature_contract kernel takes P, n, r >= 1, "
                         f"got P={P}, n={n}, r={r}")
    bf16 = log_w.dtype == torch.bfloat16
    vec = _vectorized(log_w, B)
    plan = _contract_plan(n, r, B, vec, log_w.element_size(), sm_count(dev),
                          _blocks_per_sm(dev.index, bf16, vec), P=P)
    t = torch.empty(lead + (r, B), dtype=torch.float32, device=dev)
    partial = (torch.empty((P, plan.splits, r, B, 2), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_feature_contract_launch(
            log_w.data_ptr(), int(bf16), s.data_ptr(), partial.data_ptr(),
            t.data_ptr(), P, n, r, B, plan.splits, plan.rows_per_split,
            plan.tile, plan.groups, plan.col_tiles, plan.chunks, int(vec),
            stream)
    build.check_launch(_lib(), code, "log_feature_contract")
    log_feature_contract.launches += 1
    return t


def log_halfstep(log_w: torch.Tensor, t: torch.Tensor, lmarg: torch.Tensor,
                 *, scale: float = 1.0) -> torch.Tensor:
    """out = scale * (lmarg - LSE_k(log_w[:, k] + t[k, :])), shape (m, B);
    (P, m, B) for P stacked problems, in one launch.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_halfstep_ref`."""
    dev = log_w.device
    nd = stacked_dims(log_w, "log_w")
    check_operand(log_w, "log_w", nd, dev, factor=True)
    check_operand(t, "t", nd, dev)
    check_operand(lmarg, "lmarg", nd, dev)
    m, r = log_w.shape[-2:]
    B = t.shape[-1]
    lead = tuple(log_w.shape[:-2])
    if tuple(t.shape[:-1]) != lead + (r,) or \
            tuple(lmarg.shape) != lead + (m, B):
        raise ValueError(f"shape mismatch: log_w {tuple(log_w.shape)}, t "
                         f"{tuple(t.shape)}, lmarg {tuple(lmarg.shape)}")
    if dev.type == "cpu":
        return log_halfstep_ref(log_w, t, lmarg, scale=scale)
    _check_cols(B, "log_halfstep")
    P = lead[0] if lead else 1
    if min(P, m, r) < 1 or r * B * 4 > _MAX_SMEM:
        raise ValueError(f"log_halfstep kernel takes P, m, r >= 1 and r * B "
                         f"* 4 <= {_MAX_SMEM} bytes of t a problem; got P={P},"
                         f" m={m}, r={r}, B={B}")
    bf16 = log_w.dtype == torch.bfloat16
    vec = _vectorized(log_w, B)
    es, sms = log_w.element_size(), sm_count(dev)
    nv, _, q, smem = _halfstep_kernel(m, r, B, vec, es, sms, P=P)
    plan = _halfstep_plan(m, r, B, vec, es, sms, _halfstep_blocks_per_sm(
        dev.index, bf16, nv, q, smem), P=P)
    out = torch.empty(lead + (m, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_halfstep_launch(
            log_w.data_ptr(), int(bf16), t.data_ptr(), lmarg.data_ptr(),
            out.data_ptr(), P, m, r, B, float(scale), int(vec), plan.nv,
            plan.lanes, plan.group_rows, plan.grid, stream)
    build.check_launch(_lib(), code, "log_halfstep")
    log_halfstep.launches += 1
    return out


def log_matvec(log_m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[j] = LSE_k(log_m[j, k] + t[k]), shape (m,), float32; an all
    ``-inf`` row gives ``-inf``.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_matvec_ref`."""
    dev = log_m.device
    check_operand(log_m, "log_m", 2, dev, factor=True)
    check_operand(t, "t", 1, dev)
    m, r = log_m.shape
    if t.shape[0] != r:
        raise ValueError(f"shape mismatch: log_m {tuple(log_m.shape)}, t "
                         f"{tuple(t.shape)}")
    if dev.type == "cpu":
        return log_matvec_ref(log_m, t)
    if m < 1 or r < 1 or r * 4 > _MAX_SMEM:
        raise ValueError(f"log_matvec kernel takes m, r >= 1 and r * 4 <= "
                         f"{_MAX_SMEM} bytes of t; got m={m}, r={r}")
    grid = min(-(-m // _HALFSTEP_ROWS), 4 * sm_count(dev))
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_matvec_launch(
            log_m.data_ptr(), int(log_m.dtype == torch.bfloat16),
            t.data_ptr(), out.data_ptr(), m, r, int(_vectorized(log_m, 1)),
            grid, stream)
    build.check_launch(_lib(), code, "log_matvec")
    log_matvec.launches += 1
    return out


log_feature_contract.launches = 0
log_halfstep.launches = 0
log_matvec.launches = 0
