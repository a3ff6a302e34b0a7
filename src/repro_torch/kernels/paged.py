"""Paged scaling-space operators: wrappers of ``csrc/paged.cu``.

The streaming stores (``repro_torch.streaming``) keep a support's features
in a fixed-capacity ``(C, r)`` buffer of pages of ``page_size`` rows, with
a per-page live-slot count ``page_live`` (int32, ``C // page_size``).
Dead slots carry zero weight, so a solve is right whatever the page table
says; the page table lets these kernels skip every page with no live slot:

* :func:`paged_feature_contract` — ``t = sum over live pages of
  Xi_p^T u_p``, (C, r), (C, B) -> (r, B). On the card: the flat
  contract's design (one cooperative launch of at most one wave, row
  groups, a fixed-order combine after a grid barrier, no atomics;
  :func:`_paged_plan` is ``kermatvec._contract_plan``'s geometry), its
  slabs equal shares of the rows of the live pages, which every CTA finds
  from the page table itself; the rows of dead pages are never read.
* :func:`paged_halfstep` — ``marg / (Xi t)`` on live pages, exactly 0 on
  dead pages, shape (C, B).
* :func:`paged_feature_matvec` — ``Xi t`` on live pages, 0 on dead pages.

Unlike the JAX package, which refuses its paged kernels on a GPU backend
(its contract needs a sequential grid), these run on the card whatever the
occupancy. ``xi`` is stored as float32 or bfloat16 and widened on load;
sums are float32. Counterpart of ``repro.kernels.paged``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .backend import check_operand, l2_bytes, sm_count
from .kermatvec import (
    _ROW_WARPS,
    ContractPlan,
    _check_rows,
    _contract_plan,
    _flat_vectorized,
)
from .logmatvec import _vectorized
from .ref import paged_contract_ref, paged_halfstep_ref, paged_matvec_ref

__all__ = ["paged_feature_contract", "paged_halfstep",
           "paged_feature_matvec"]


@functools.cache
def _lib():
    lib = build.load("paged")
    c = lib.paged_feature_contract_launch
    c.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    c.restype = ctypes.c_int
    o = lib.paged_feature_contract_occupancy
    o.argtypes = [ctypes.c_int] * 2
    o.restype = ctypes.c_int
    h = lib.paged_halfstep_launch
    h.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    h.restype = ctypes.c_int
    v = lib.paged_feature_matvec_launch
    v.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    v.restype = ctypes.c_int
    return lib


def _check_paged(xi: torch.Tensor, page_live: torch.Tensor,
                 page_size: int) -> int:
    """The page table's checks (the JAX package's ``ValueError``s), plus
    the operand checks of ``page_live``; returns the number of pages."""
    if not isinstance(page_live, torch.Tensor) or \
            page_live.dtype != torch.int32 or page_live.dim() != 1:
        raise TypeError("page_live must be a 1-d int32 torch.Tensor")
    if page_live.device != xi.device or not page_live.is_contiguous():
        raise ValueError(f"page_live must be contiguous on {xi.device}")
    n, n_pages = xi.shape[0], page_live.shape[0]
    if page_size % 8 != 0:
        raise ValueError(
            f"page_size must be a multiple of the f32 sublane (8), got "
            f"{page_size}")
    if n != page_size * n_pages:
        raise ValueError(
            f"capacity {n} != page_size {page_size} * n_pages {n_pages}; "
            "paged buffers are exact multiples of the page granularity")
    return n_pages


def _paged_plan(n_pages: int, page_size: int, r: int, B: int, vec: bool,
                element_size: int, sms: int,
                blocks_per_sm: int) -> ContractPlan:
    """The paged contract's geometry: the flat contract's
    (``kermatvec._contract_plan``) over the capacity's rows, with no more
    slabs than pages. The kernel splits the live rows, not the capacity,
    over the slabs, so the plan fixes no ``rows_per_split`` (0)."""
    plan = _contract_plan(n_pages * page_size, r, B, vec, element_size, sms,
                          blocks_per_sm)
    return plan._replace(splits=min(plan.splits, n_pages), rows_per_split=0)


@functools.cache
def _blocks_per_sm(device_index: int, bf16: bool, vec: bool) -> int:
    with torch.cuda.device(device_index):
        blocks = _lib().paged_feature_contract_occupancy(int(bf16), int(vec))
    if blocks <= 0:
        build.check_launch(_lib(), -blocks or 1, "paged_feature_contract")
    return blocks


def _rows_grid(xi: torch.Tensor, t: torch.Tensor, what: str) -> int:
    """The paged row kernels' grid: a warp a row (``row_dot``), at most
    four CTAs an SM."""
    _check_rows(xi, t, what)
    return min(-(-xi.shape[0] // _ROW_WARPS), 4 * sm_count(xi.device))


def _streams(xi: torch.Tensor) -> bool:
    """Whether the paged contract reads ``xi`` with evict-first loads:
    where the buffer is larger than the L2. The paged plan reads the other
    buffer next (``ops._paged_scaling_plan``); an iteration in its order
    on an H100 read 10% faster with them at float32 r = 1024, C = 32768,
    4% at bf16, and no faster at r = 256, where the buffer fits."""
    return xi.element_size() * xi.numel() > l2_bytes(xi.device)


# Launch options chip_smoke.py times: ``combine=False`` stops the contract
# after the slabs' partials, so t is NOT formed; ``stream``: evict-first
# row loads on the 16-byte path, None = the planner's choice
# (:func:`_streams`).
_FORCE = {"combine": True, "stream": None}


def paged_feature_contract(xi: torch.Tensor, u: torch.Tensor,
                           page_live: torch.Tensor, *,
                           page_size: int) -> torch.Tensor:
    """t = sum over live pages of Xi_p^T u_p, shape (r, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.paged_contract_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(u, "u", 2, dev)
    n_pages = _check_paged(xi, page_live, page_size)
    C, r = xi.shape
    B = u.shape[1]
    if u.shape[0] != C:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, u "
                         f"{tuple(u.shape)}")
    if dev.type == "cpu":
        return paged_contract_ref(xi, u, page_live, page_size=page_size)
    if min(C, r, B) < 1:
        raise ValueError(f"paged_feature_contract kernel takes C, r, B >= 1,"
                         f" got C={C}, r={r}, B={B}")
    bf16 = xi.dtype == torch.bfloat16
    vec = _flat_vectorized(xi, B)
    plan = _paged_plan(n_pages, page_size, r, B, vec, xi.element_size(),
                       sm_count(dev), _blocks_per_sm(dev.index, bf16, vec))
    evict = _streams(xi) if _FORCE["stream"] is None else _FORCE["stream"]
    t = torch.empty((r, B), dtype=torch.float32, device=dev)
    partial = (torch.empty((plan.splits, r, B), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().paged_feature_contract_launch(
            xi.data_ptr(), int(bf16), u.data_ptr(), page_live.data_ptr(),
            partial.data_ptr(), t.data_ptr(), C, r, B, page_size, n_pages,
            plan.splits, plan.tile, plan.groups, plan.col_tiles, plan.chunks,
            int(vec), int(_FORCE["combine"]), int(bool(evict)), stream)
    build.check_launch(_lib(), code, "paged_feature_contract")
    paged_feature_contract.launches += 1
    return t


def paged_halfstep(xi: torch.Tensor, t: torch.Tensor, marg: torch.Tensor,
                   page_live: torch.Tensor, *,
                   page_size: int) -> torch.Tensor:
    """out = marg / (Xi t) on live pages (IEEE divide), 0 on dead pages,
    shape (C, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.paged_halfstep_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    check_operand(marg, "marg", 2, dev)
    _check_paged(xi, page_live, page_size)
    C, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r or tuple(marg.shape) != (C, B):
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}, marg {tuple(marg.shape)}")
    if dev.type == "cpu":
        return paged_halfstep_ref(xi, t, marg, page_live, page_size=page_size)
    grid = _rows_grid(xi, t, "paged_halfstep")
    out = torch.empty((C, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().paged_halfstep_launch(
            xi.data_ptr(), int(xi.dtype == torch.bfloat16), t.data_ptr(),
            marg.data_ptr(), page_live.data_ptr(), out.data_ptr(), C, r, B,
            page_size, int(_vectorized(xi, B)), grid, stream)
    build.check_launch(_lib(), code, "paged_halfstep")
    paged_halfstep.launches += 1
    return out


def paged_feature_matvec(xi: torch.Tensor, t: torch.Tensor,
                         page_live: torch.Tensor, *,
                         page_size: int) -> torch.Tensor:
    """out = Xi t on live pages, 0 on dead pages, shape (C, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.paged_matvec_ref`."""
    dev = xi.device
    check_operand(xi, "xi", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    _check_paged(xi, page_live, page_size)
    C, r = xi.shape
    B = t.shape[1]
    if t.shape[0] != r:
        raise ValueError(f"shape mismatch: xi {tuple(xi.shape)}, t "
                         f"{tuple(t.shape)}")
    if dev.type == "cpu":
        return paged_matvec_ref(xi, t, page_live, page_size=page_size)
    grid = _rows_grid(xi, t, "paged_feature_matvec")
    out = torch.empty((C, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().paged_feature_matvec_launch(
            xi.data_ptr(), int(xi.dtype == torch.bfloat16), t.data_ptr(),
            page_live.data_ptr(), out.data_ptr(), C, r, B, page_size,
            int(_vectorized(xi, B)), grid, stream)
    build.check_launch(_lib(), code, "paged_feature_matvec")
    paged_feature_matvec.launches += 1
    return out


paged_feature_contract.launches = 0
paged_halfstep.launches = 0
paged_feature_matvec.launches = 0
