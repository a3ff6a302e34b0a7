"""The persistent Sinkhorn megakernels: wrappers of ``csrc/fused_loop.cu``.

:func:`sinkhorn_block` advances the scaling plan's carry
``(u, v, s = Zeta (Xi^T u))`` and :func:`log_sinkhorn_block` the log
plan's carry ``(f, g, t = LSE_i(log_xi + f/eps))`` by ``inner_steps`` full
iterations in one launch; each returns the marginal error at the block
end, the only scalar a block hands back. Each kernel runs as one thread
block cluster whose C CTAs each hold a slice of both factors' rows in
shared memory and meet over distributed shared memory at each column pass,
adding the partials in rank order (:func:`_block_plan`, plain Python, is
the geometry both share). The plans take either only where
:func:`block_plan_fits` admits the shape, under the JAX package's 192 KiB
GPU budget; larger shapes run the streaming per-iteration plan. A shape
the budget admits but whose plan does not fit raises, as does a cluster
the card cannot place.

Both wrappers also take P problems stacked on a leading axis (``(P, n,
r)`` factors, ``(P, n, 1)`` columns, ``(P, r, 1)`` t) and advance all of
them in one launch of P clusters, one a problem, as ``jax.vmap`` over the
JAX package's ``pallas_call`` adds a leading grid axis; each problem's
error comes back in a (P,) tensor. Clusters the card cannot hold at once
run in later waves (:func:`_clusters` counts those it holds). Counterpart
of ``repro.kernels.fused_loop``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import autotune, build
from .backend import MEGAKERNEL_BUDGET, check_operand, stacked_dims
from .ref import log_sinkhorn_block_ref, sinkhorn_block_ref

__all__ = [
    "block_vmem_bytes",
    "block_plan_fits",
    "smem_bytes",
    "sinkhorn_block",
    "log_sinkhorn_block",
]

_SUBLANE_ANY = 16               # the JAX package's row quantum (f32 and bf16)
_LANE = 128                     # its feature (minor) axis quantum
_MAX_SMEM = 232448              # dynamic shared memory of one H100 CTA
_MAX_CLUSTER = 8                # kMaxCluster: the portable cluster size
_CLUSTER_ROWS = 16              # least rows of the larger factor a CTA takes
_GROUP_ROWS = 8                 # kGroupRows: rows a lane keeps in registers
_MAX_WARPS = 16                 # kMaxBlockThreads / 32 (128 registers each)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def block_vmem_bytes(n: int, m: int, r: int, B: int = 1,
                     feature_dtype: torch.dtype = torch.float32) -> int:
    """Working-set bytes of one megakernel launch, counted as the JAX
    package counts them (padded shapes): the factors at their storage
    width plus the float32 carries and intermediates."""
    np_, mp = _round_up(n, _SUBLANE_ANY), _round_up(m, _SUBLANE_ANY)
    rp = _round_up(r, _LANE)
    fbytes = torch.finfo(feature_dtype).bits // 8
    factors = (np_ + mp) * rp * fbytes
    vectors = (3 * np_ + 4 * mp + 2 * rp) * B * 4
    return factors + vectors


def block_plan_fits(n: int, m: int, r: int, B: int = 1,
                    feature_dtype: torch.dtype = torch.float32) -> bool:
    """Whether the megakernel is admitted at this shape: the JAX package's
    ``block_plan_fits`` on its gpu-triton backend, on both devices."""
    return block_vmem_bytes(n, m, r, B, feature_dtype) <= MEGAKERNEL_BUDGET


class BlockPlan(NamedTuple):
    cluster: int            # C: CTAs of the cluster, the whole grid
    threads: int            # of a CTA
    groups: int             # G: row groups of a column pass
    lanes: int              # L: lanes a row in a row pass
    ldw: int                # 32-bit words between two staged rows
    words: int              # 32-bit words of a row (4 / element size columns
                            # each)
    rows_x: int             # most rows of log_xi a CTA holds
    rows_z: int             # most rows of log_zeta a CTA holds
    smem: int               # dynamic shared memory of one CTA, bytes

    def slice(self, rank: int, rows: int) -> Tuple[int, int]:
        """Rows [begin, end) of a factor of ``rows`` rows that CTA ``rank``
        holds: C contiguous slices in order, sizes differing by at most
        one (the kernel computes the same)."""
        return rank * rows // self.cluster, (rank + 1) * rows // self.cluster


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _log_layout(rows_x: int, rows_z: int, words: int, cols: int,
                ldw: int) -> int:
    """Bytes of one CTA's dynamic shared memory (``log_layout`` in
    ``csrc/fused_loop.cu``): the staged rows, the float slices of f, loga,
    g, logb, b and s, t and two slots of (max, sum) partials a column."""
    def a16(x):
        return _round_up(x, 16)
    tc = words * cols
    return (a16(rows_x * ldw * 4) + a16(rows_z * ldw * 4)
            + 2 * a16(rows_x * 4) + 3 * a16(rows_z * 4)
            + a16(max(rows_x, rows_z) * 4) + a16(tc * 4) + 16 * tc + 16)


def _scaling_layout(rows_x: int, rows_z: int, words: int, cols: int,
                    ldw: int) -> int:
    """Bytes of one CTA's dynamic shared memory of the scaling kernel
    (``scaling_layout`` in ``csrc/fused_loop.cu``): the staged rows, the
    float slices of u, a, v, b and s, t and two slots of partial sums a
    column."""
    def a16(x):
        return _round_up(x, 16)
    tc = words * cols
    return (a16(rows_x * ldw * 4) + a16(rows_z * ldw * 4)
            + 2 * a16(rows_x * 4) + 3 * a16(rows_z * 4) + a16(tc * 4)
            + a16(8 * tc) + 16)


_LAYOUTS = {"log": _log_layout, "scaling": _scaling_layout}


def _block_plan(n: int, m: int, r: int, feature_dtype: torch.dtype,
                mode: str = "log", *, cluster: int = 0) -> BlockPlan:
    """The megakernels' geometry, from the shape alone (the ``mode``, "log"
    or "scaling", sets only the shared memory's layout): C = ceil(max(n, m)
    / 16) CTAs up to 8, each holding at most ceil(n / C) rows of the first
    factor and ceil(m / C) of the second; G, the least power of two that
    leaves a lane at most 8 of the R = max of those rows in a column pass;
    the warps the larger of the column pass's tiles of 32 / G words and
    ceil(R / G) want, at most 16 (512 threads keep 128 registers a thread;
    at 64 the kernel spilled); L, the lanes a row that let the warps take
    all R rows of a row pass at once. Rows are staged ldw words apart: with
    G > 1, ldw is an odd multiple of 32 / G, so the G row groups of a
    column pass read different banks. At the OT-GAN shape on an H100, C = 4
    and 16, 4 rows a lane (512 threads) and 8 lanes a row at 512 threads
    all read the log kernel slower than this plan or within 1% of it
    (PERF.md, Findings). ``cluster`` (the autotuner's knob, 1-8) fixes C
    instead; the rest of the plan follows from it."""
    esize = 2 if feature_dtype == torch.bfloat16 else 4
    C = cluster or min(_MAX_CLUSTER, -(-max(n, m) // _CLUSTER_ROWS))
    rows_x, rows_z = -(-n // C), -(-m // C)
    R = max(rows_x, rows_z, 1)
    words = -(-r * esize // 4)
    G = min(32, _pow2_ceil(-(-R // _GROUP_ROWS)))
    wd = 32 // G
    warps = min(_MAX_WARPS, max(-(-words // wd), -(-R // G)))
    lanes = 32 // min(32, _pow2_ceil(-(-R // warps)))
    ldw = words if G == 1 else _round_up(words, 2 * wd) + wd
    return BlockPlan(C, 32 * warps, G, lanes, ldw, words, rows_x, rows_z,
                     _LAYOUTS[mode](rows_x, rows_z, words, 4 // esize, ldw))


def smem_bytes(n: int, m: int, r: int, feature_dtype: torch.dtype, *,
               mode: str = "log") -> int:
    """Dynamic shared memory of one CTA of the ``mode`` ("scaling" or
    "log") megakernel, from :func:`_block_plan` (plain Python). Both stay
    under :data:`_MAX_SMEM` wherever :func:`block_plan_fits` admits the
    shape."""
    if mode not in _LAYOUTS:
        raise ValueError(f"mode must be 'log' or 'scaling', got {mode!r}")
    return _block_plan(n, m, r, feature_dtype, mode).smem


@functools.cache
def _lib():
    lib = build.load("fused_loop")
    for mode in ("log_", ""):
        size = getattr(lib, f"{mode}sinkhorn_block_smem_bytes")
        size.argtypes = [ctypes.c_int] * 9
        size.restype = ctypes.c_longlong
        place = getattr(lib, f"{mode}sinkhorn_block_clusters")
        place.argtypes = [ctypes.c_int] * 9
        place.restype = ctypes.c_int
    fn = lib.log_sinkhorn_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.sinkhorn_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_block_shape(what, n, m, r, dtype, mode):
    if min(n, m, r) < 1:
        raise ValueError(f"{what} kernel takes n, m, r >= 1; got n={n}, "
                         f"m={m}, r={r}")
    smem = smem_bytes(n, m, r, dtype, mode=mode)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{what} kernel takes a CTA within {_MAX_SMEM} bytes of shared "
            f"memory; got n={n}, m={m}, r={r} ({dtype}), {smem} bytes")


def _runs(plan: BlockPlan) -> bool:
    """Whether the kernel runs ``plan``: a portable cluster, at most 8 rows
    a lane in a column pass, 512 threads and one CTA's shared memory."""
    R = max(plan.rows_x, plan.rows_z)
    return (1 <= plan.cluster <= _MAX_CLUSTER
            and -(-R // plan.groups) <= _GROUP_ROWS
            and plan.threads <= 32 * _MAX_WARPS
            and plan.smem <= _MAX_SMEM)


def _checked_plan(what, mode, n, m, r, dtype, device=None,
                  P: int = 1) -> BlockPlan:
    """The plan the ``mode`` wrapper launches for P problems (its cluster
    size the autotuner's, ``what``, keyed by P as well), refused where
    :func:`block_plan_fits` does not admit one problem's shape (the
    cluster's shared memory would hold more, but the plans' admission
    stays the JAX package's) or the kernel cannot run it."""
    _check_block_shape(what, n, m, r, dtype, mode)
    if not block_plan_fits(n, m, r, 1, dtype):
        raise ValueError(f"{what} kernel takes the shapes block_plan_fits "
                         f"admits; got n={n}, m={m}, r={r} ({dtype})")
    ext = dict(P=P, n=n, m=m, r=r, esize=torch.finfo(dtype).bits // 8)
    knobs = autotune.resolve(what, ext, dtype, device)
    plan = _block_plan(n, m, r, dtype, mode, cluster=knobs["cluster"])
    if not _runs(plan):
        raise ValueError(f"{what} kernel cannot run the plan {plan} for "
                         f"n={n}, m={m}, r={r} ({dtype})")
    return plan


def _log_block_plan(n, m, r, dtype, device=None, P: int = 1) -> BlockPlan:
    return _checked_plan("log_sinkhorn_block", "log", n, m, r, dtype, device,
                         P)


def _scaling_block_plan(n, m, r, dtype, device=None,
                        P: int = 1) -> BlockPlan:
    return _checked_plan("sinkhorn_block", "scaling", n, m, r, dtype,
                         device, P)


def _ext_dtype(ext: dict) -> torch.dtype:
    return torch.bfloat16 if ext["esize"] == 2 else torch.float32


def _block_planner(mode: str) -> "autotune.Planner":
    """The megakernel's cluster size as a tuner knob: its neighbours every
    power of two up to 8 at which the kernel runs the plan. The prior is
    the shape's alone; the key holds P too, since P clusters of C CTAs
    fill the card differently at each C (at the OT-GAN shape an H100
    places 30 clusters of 8 and 66 of 2, so P = 32 takes two waves at C =
    8 and one at C = 2; chip_smoke.py phase 3)."""
    def plan_of(ext, cluster=0):
        return _block_plan(ext["n"], ext["m"], ext["r"], _ext_dtype(ext),
                           mode, cluster=cluster)

    def neighbours(ext, prior):
        for c in (1, 2, 4, _MAX_CLUSTER):
            if c != prior["cluster"] and _runs(plan_of(ext, c)):
                yield {"cluster": c}

    return autotune.Planner(("cluster",),
                            lambda ext: {"cluster": plan_of(ext).cluster},
                            neighbours)


@functools.cache
def _clusters(device_index: int, mode: str, n: int, m: int, r: int,
              bf16: bool, plan: BlockPlan) -> int:
    """Clusters of the ``mode`` kernel's ``plan`` the card places at once
    (a launch of P problems runs in ceil(P / this) waves); raises where it
    can place none (the launch would be refused)."""
    what = "log_sinkhorn_block" if mode == "log" else "sinkhorn_block"
    with torch.cuda.device(device_index):
        got = getattr(_lib(), f"{what}_clusters")(
            n, m, r, int(bf16), plan.cluster, plan.threads, plan.groups,
            plan.lanes, plan.ldw)
    if got < 0:
        build.check_launch(_lib(), -got, what)
    if got == 0:
        raise RuntimeError(f"{what}: the card cannot place a cluster of "
                           f"{plan.cluster} CTAs of {plan.threads} threads "
                           f"and {plan.smem} bytes")
    return got


def _problems(factor: torch.Tensor) -> int:
    """P of a stacked (P, n, r) factor; 1 for a 2-D one."""
    return factor.shape[0] if factor.dim() == 3 else 1


def _check_columns(what, lead, named):
    """Each ``(name, tensor, rows)`` of ``named`` must be ``lead + (rows,
    B)`` with one B, the first's; raises naming every shape otherwise."""
    B = named[0][1].shape[-1]
    if any(tuple(t.shape) != lead + (rows, B) for _, t, rows in named):
        raise ValueError(f"{what}: shape mismatch: " + ", ".join(
            f"{name} {tuple(t.shape)}" for name, t, _ in named))
    return B


def sinkhorn_block(xi: torch.Tensor, zeta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                   s0: torch.Tensor, *, inner_steps: int,
                   momentum: float = 1.0):
    """``inner_steps`` scaling-space iterations: ``(u, v, s, err)``.

    ``xi`` (n, r) and ``zeta`` (m, r) are float32 or bfloat16; ``a``/``u0``
    (n, B) and ``b``/``v0``/``s0`` (m, B) float32 (a zero weight marks a
    dead atom). With P problems stacked on a leading axis (``xi`` (P, n,
    r), ``a`` (P, n, B), ...) every operand has it and one launch serves
    all P, each problem's ``err`` in a (P,) tensor; for one problem
    ``err`` is 0-d. On a CUDA tensor this launches the kernel, which takes
    B = 1; on a CPU tensor it runs
    :func:`~repro_torch.kernels.ref.sinkhorn_block_ref` (any B)."""
    dev = xi.device
    nd = stacked_dims(xi, "xi")
    check_operand(xi, "xi", nd, dev, factor=True)
    check_operand(zeta, "zeta", nd, dev, factor=True)
    for name, t in (("a", a), ("b", b), ("u0", u0), ("v0", v0), ("s0", s0)):
        check_operand(t, name, nd, dev)
    n, r = xi.shape[-2:]
    m = zeta.shape[-2]
    lead = tuple(xi.shape[:-2])
    if zeta.dtype != xi.dtype or tuple(zeta.shape) != lead + (m, r):
        raise ValueError(f"sinkhorn_block: shape mismatch: xi "
                         f"{tuple(xi.shape)} {xi.dtype}, zeta "
                         f"{tuple(zeta.shape)} {zeta.dtype}")
    B = _check_columns("sinkhorn_block", lead, (
        ("a", a, n), ("u0", u0, n), ("b", b, m), ("v0", v0, m),
        ("s0", s0, m)))
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if dev.type == "cpu":
        return sinkhorn_block_ref(xi, zeta, a, b, u0, v0, s0,
                                  inner_steps=inner_steps, momentum=momentum)
    if B != 1:
        raise ValueError(f"sinkhorn_block kernel takes B = 1 column, got {B}")
    P = _problems(xi)
    out = _launch_scaling_block(
        xi, zeta, a, b, u0, v0, s0, inner_steps, momentum,
        _scaling_block_plan(n, m, r, xi.dtype, dev, P))
    sinkhorn_block.launches += 1
    return out


def _launch_scaling_block(xi, zeta, a, b, u0, v0, s0, inner_steps: int,
                          momentum: float, plan: BlockPlan):
    """Launch the scaling megakernel at ``plan``, one cluster a problem:
    ``(u, v, s, err)``."""
    dev = xi.device
    n, r = xi.shape[-2:]
    m = zeta.shape[-2]
    lead = tuple(xi.shape[:-2])
    P = _problems(xi)
    bf16 = xi.dtype == torch.bfloat16
    _clusters(dev.index, "scaling", n, m, r, bf16, plan)
    u = torch.empty(lead + (n, 1), dtype=torch.float32, device=dev)
    v = torch.empty(lead + (m, 1), dtype=torch.float32, device=dev)
    s = torch.empty(lead + (m, 1), dtype=torch.float32, device=dev)
    err = torch.empty((P,), dtype=torch.float32, device=dev)
    mom = float(momentum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sinkhorn_block_launch(
            xi.data_ptr(), zeta.data_ptr(), int(bf16), a.data_ptr(),
            b.data_ptr(), u0.data_ptr(), v0.data_ptr(), s0.data_ptr(),
            u.data_ptr(), v.data_ptr(), s.data_ptr(), err.data_ptr(), n, m,
            r, int(inner_steps), mom, 1.0 - mom, int(mom != 1.0),
            plan.cluster, plan.threads, plan.groups, plan.lanes, plan.ldw,
            P, stream)
    build.check_launch(_lib(), code, "sinkhorn_block")
    return u, v, s, (err if lead else err[0])


def log_sinkhorn_block(log_xi: torch.Tensor, log_zeta: torch.Tensor,
                       loga: torch.Tensor, logb: torch.Tensor,
                       b: torch.Tensor, f0: torch.Tensor, g0: torch.Tensor,
                       t0: torch.Tensor, *, inner_steps: int, eps: float,
                       momentum: float = 1.0):
    """``inner_steps`` log-domain iterations: ``(f, g, t, err)``.

    ``log_xi`` (n, r) and ``log_zeta`` (m, r) are float32 or bfloat16;
    ``loga``/``f0`` (n, B), ``logb``/``b``/``g0`` (m, B) and ``t0`` (r, B)
    float32 (``-inf`` marks a dead atom). With P problems stacked on a
    leading axis (``log_xi`` (P, n, r), ``loga`` (P, n, B), ``t0`` (P, r,
    B), ...) every operand has it and one launch serves all P, each
    problem's ``err`` in a (P,) tensor; for one problem ``err`` is 0-d. On
    a CUDA tensor this launches the kernel, which takes B = 1; on a CPU
    tensor it runs :func:`~repro_torch.kernels.ref.log_sinkhorn_block_ref`
    (any B)."""
    dev = log_xi.device
    nd = stacked_dims(log_xi, "log_xi")
    check_operand(log_xi, "log_xi", nd, dev, factor=True)
    check_operand(log_zeta, "log_zeta", nd, dev, factor=True)
    for name, t in (("loga", loga), ("logb", logb), ("b", b), ("f0", f0),
                    ("g0", g0), ("t0", t0)):
        check_operand(t, name, nd, dev)
    n, r = log_xi.shape[-2:]
    m = log_zeta.shape[-2]
    lead = tuple(log_xi.shape[:-2])
    if (log_zeta.dtype != log_xi.dtype
            or tuple(log_zeta.shape) != lead + (m, r)):
        raise ValueError(f"log_sinkhorn_block: shape mismatch: log_xi "
                         f"{tuple(log_xi.shape)} {log_xi.dtype}, log_zeta "
                         f"{tuple(log_zeta.shape)} {log_zeta.dtype}")
    B = _check_columns("log_sinkhorn_block", lead, (
        ("loga", loga, n), ("f0", f0, n), ("logb", logb, m), ("b", b, m),
        ("g0", g0, m), ("t0", t0, r)))
    if inner_steps < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if dev.type == "cpu":
        return log_sinkhorn_block_ref(log_xi, log_zeta, loga, logb, b, f0, g0,
                                      t0, inner_steps=inner_steps, eps=eps,
                                      momentum=momentum)
    if B != 1:
        raise ValueError(f"log_sinkhorn_block kernel takes B = 1 column, "
                         f"got {B}")
    P = _problems(log_xi)
    out = _launch_log_block(
        log_xi, log_zeta, loga, logb, b, f0, g0, t0, inner_steps, eps,
        momentum, _log_block_plan(n, m, r, log_xi.dtype, dev, P))
    log_sinkhorn_block.launches += 1
    return out


def _launch_log_block(log_xi, log_zeta, loga, logb, b, f0, g0, t0,
                      inner_steps: int, eps: float, momentum: float,
                      plan: BlockPlan):
    """Launch the log megakernel at ``plan``, one cluster a problem:
    ``(f, g, t, err)``."""
    dev = log_xi.device
    n, r = log_xi.shape[-2:]
    m = log_zeta.shape[-2]
    lead = tuple(log_xi.shape[:-2])
    P = _problems(log_xi)
    bf16 = log_xi.dtype == torch.bfloat16
    _clusters(dev.index, "log", n, m, r, bf16, plan)
    f = torch.empty(lead + (n, 1), dtype=torch.float32, device=dev)
    g = torch.empty(lead + (m, 1), dtype=torch.float32, device=dev)
    t = torch.empty(lead + (r, 1), dtype=torch.float32, device=dev)
    err = torch.empty((P,), dtype=torch.float32, device=dev)
    mom = float(momentum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().log_sinkhorn_block_launch(
            log_xi.data_ptr(), log_zeta.data_ptr(), int(bf16),
            loga.data_ptr(), logb.data_ptr(), b.data_ptr(), f0.data_ptr(),
            g0.data_ptr(), t0.data_ptr(), f.data_ptr(), g.data_ptr(),
            t.data_ptr(), err.data_ptr(), n, m, r, int(inner_steps),
            float(eps), mom, 1.0 - mom, int(mom != 1.0), plan.cluster,
            plan.threads, plan.groups, plan.lanes, plan.ldw, P, stream)
    build.check_launch(_lib(), code, "log_sinkhorn_block")
    return f, g, t, (err if lead else err[0])


def _block_runner(mode: str):
    """The megakernels' tuner runs: 8 iterations at the key's shape and P
    on uniform synthetic factors."""
    def factory(ext, dtype, device):
        P, n, m, r = ext["P"], ext["n"], ext["m"], ext["r"]
        lead = (P,) if P > 1 else ()

        def col(rows, fill=0.0):
            return torch.full(lead + (rows, 1), fill, device=device)

        fx = torch.full(lead + (n, r), -0.5, dtype=dtype, device=device)
        fz = torch.full(lead + (m, r), -0.5, dtype=dtype, device=device)
        if mode == "log":
            args = (fx, fz, col(n), col(m), col(m, 1.0 / m), col(n), col(m),
                    col(r, -0.5))
            return lambda knobs: _launch_log_block(
                *args, 8, 0.5, 1.0, _block_plan(n, m, r, dtype, mode,
                                                cluster=knobs["cluster"]))
        args = (fx.exp(), fz.exp(), col(n, 1.0 / n), col(m, 1.0 / m),
                col(n, 1.0), col(m, 1.0), col(m, 1.0))
        return lambda knobs: _launch_scaling_block(
            *args, 8, 1.0, _block_plan(n, m, r, dtype, mode,
                                       cluster=knobs["cluster"]))
    return factory


for _mode, _name in (("log", "log_sinkhorn_block"),
                     ("scaling", "sinkhorn_block")):
    autotune.register_planner(_name, _block_planner(_mode))
    autotune.register_runner(_name, _block_runner(_mode))

sinkhorn_block.launches = 0
log_sinkhorn_block.launches = 0
