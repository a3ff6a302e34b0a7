"""Log-domain factored Sinkhorn operators: wrappers of ``csrc/logmatvec.cu``.

* :func:`log_feature_contract` — stage 1 of the exact two-stage LSE,
  ``t[k, c] = LSE_i(log_w[i, k] + s[i, c])``, (n, r), (n, B) -> (r, B).
  On the card: split-n partial LSEs into a ``(n_splits, r, B)`` scratch
  buffer, then a deterministic exact-LSE combine (no atomics).
* :func:`log_halfstep` — stage 2 with the log half-step fused,
  ``out = scale * (lmarg - LSE_k(log_w[:, k] + t[k, :]))``, shape (m, B).
  ``scale=eps`` is the potential update, ``scale=-1, lmarg=0`` the raw LSE.
* :func:`log_matvec` — the single-column row LSE with the exact row max,
  ``out[j] = LSE_k(log_m[j, k] + t[k])``, (m, r), (r,) -> (m,). No solver
  reaches it; ``kernels.ops.log_matvec`` exports it, as the JAX package
  does.

``log_w`` is stored as float32 or bfloat16 (``precision="bf16"``); the
kernels widen it on load and accumulate in float32, as the plain versions
do. A row or column whose entries are all ``-inf`` (dead atoms carry
``f = -inf``) gives ``-inf``, never NaN. B is small (the solvers run B = 1):
the kernels keep one running LSE per column in registers, up to
``MAX_COLS`` columns. Counterpart of ``repro.kernels.logmatvec``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .backend import check_operand, sm_count
from .ref import log_feature_contract_ref, log_halfstep_ref, log_matvec_ref

__all__ = ["MAX_COLS", "log_feature_contract", "log_halfstep", "log_matvec"]

MAX_COLS = 8                    # kMaxCols in csrc/common.cuh
_CONTRACT_THREADS = 128         # kContractThreads: one column each, or four
_MIN_ROWS_PER_SPLIT = 32
_HALFSTEP_ROWS = 8              # rows per half-step CTA (one per warp)
_MAX_SMEM = 227 * 1024          # dynamic shared memory of one CTA (t)


@functools.cache
def _lib():
    lib = build.load("logmatvec")
    c = lib.log_feature_contract_launch
    c.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    c.restype = ctypes.c_int
    h = lib.log_halfstep_launch
    h.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    h.restype = ctypes.c_int
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
    return (B == 1 and log_w.shape[1] % _vec_width(log_w) == 0
            and log_w.data_ptr() % 16 == 0)


def _contract_vectorized(log_w: torch.Tensor, B: int) -> bool:
    """Whether the contract takes its vector path: as :func:`_vectorized`,
    and only where the ``r / V`` vectors of a row fill a CTA. Below that
    (r < 1024 in bfloat16, r < 512 in float32) most threads of a vector CTA
    would idle while the rest reduce V columns each, so the scalar path,
    one column a thread, finishes sooner."""
    return (_vectorized(log_w, B)
            and log_w.shape[1] // _vec_width(log_w) >= _CONTRACT_THREADS)


def _split_rows(n: int, r: int, vec: int, device: torch.device):
    """(n_splits, rows_per_split): about 8 contract CTAs per SM. ``vec`` is
    the vector width in elements, 0 on the scalar path."""
    cols = _CONTRACT_THREADS * max(vec, 1)
    r_tiles = -(-r // cols)
    want = max(1, (8 * sm_count(device)) // r_tiles)
    rows = max(_MIN_ROWS_PER_SPLIT, -(-n // want))
    return -(-n // rows), rows


def log_feature_contract(log_w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t[k, c] = LSE_i(log_w[i, k] + s[i, c]), shape (r, B), float32.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_feature_contract_ref`."""
    dev = log_w.device
    check_operand(log_w, "log_w", 2, dev, factor=True)
    check_operand(s, "s", 2, dev)
    n, r = log_w.shape
    B = s.shape[1]
    if s.shape[0] != n:
        raise ValueError(f"shape mismatch: log_w {tuple(log_w.shape)}, s "
                         f"{tuple(s.shape)}")
    if dev.type == "cpu":
        return log_feature_contract_ref(log_w, s)
    _check_cols(B, "log_feature_contract")
    if n < 1 or r < 1:
        raise ValueError(f"log_feature_contract kernel takes n, r >= 1, got "
                         f"n={n}, r={r}")
    vec = _contract_vectorized(log_w, B)
    n_splits, rows = _split_rows(n, r, _vec_width(log_w) if vec else 0, dev)
    partial = torch.empty((n_splits, r, B), dtype=torch.float32, device=dev)
    t = torch.empty((r, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_feature_contract_launch(
            log_w.data_ptr(), int(log_w.dtype == torch.bfloat16),
            s.data_ptr(), partial.data_ptr(), t.data_ptr(),
            n, r, B, n_splits, rows, int(vec), stream)
    build.check_launch(_lib(), code, "log_feature_contract")
    log_feature_contract.launches += 1
    return t


def log_halfstep(log_w: torch.Tensor, t: torch.Tensor, lmarg: torch.Tensor,
                 *, scale: float = 1.0) -> torch.Tensor:
    """out = scale * (lmarg - LSE_k(log_w[:, k] + t[k, :])), shape (m, B).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.log_halfstep_ref`."""
    dev = log_w.device
    check_operand(log_w, "log_w", 2, dev, factor=True)
    check_operand(t, "t", 2, dev)
    check_operand(lmarg, "lmarg", 2, dev)
    m, r = log_w.shape
    B = t.shape[1]
    if t.shape[0] != r or tuple(lmarg.shape) != (m, B):
        raise ValueError(f"shape mismatch: log_w {tuple(log_w.shape)}, t "
                         f"{tuple(t.shape)}, lmarg {tuple(lmarg.shape)}")
    if dev.type == "cpu":
        return log_halfstep_ref(log_w, t, lmarg, scale=scale)
    _check_cols(B, "log_halfstep")
    if m < 1 or r < 1 or r * B * 4 > _MAX_SMEM:
        raise ValueError(f"log_halfstep kernel takes m, r >= 1 and r * B * 4 "
                         f"<= {_MAX_SMEM} bytes of t; got m={m}, r={r}, B={B}")
    grid = min(-(-m // _HALFSTEP_ROWS), 4 * sm_count(dev))
    out = torch.empty((m, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_halfstep_launch(
            log_w.data_ptr(), int(log_w.dtype == torch.bfloat16),
            t.data_ptr(), lmarg.data_ptr(), out.data_ptr(),
            m, r, B, float(scale), int(_vectorized(log_w, B)), grid, stream)
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
