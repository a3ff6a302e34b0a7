#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7] [--src DIR]

``--src`` drives the ``repro_torch`` under another checkout's ``src`` (to
time two versions with one script, in turns, on one card).

Phases, each of which fails the run (nonzero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (``nvcc``, in
   parallel);
2. each kernel against its plain PyTorch version on the card: at the main
   paths' shapes, at ragged shapes, and on inputs with ``-inf`` rows,
   columns and constants; the LSE kernels on float32 and bf16 factors; the
   log megakernel in bf16 and float32, at momentum 1.0 and 1.3, with dead
   atoms and a dead anchor, and its refusal of shapes the plan does not
   admit; the scaling contract, half-step (with a zero-weight atom and an
   all-zero row) and matvec on float32 and bf16 factors, the contract run
   twice a shape (bit-identical reruns) on its 16-byte path with row groups
   and forced onto its scalar path, also at float32 r = 4, 12, 128, 256 and
   bf16 r = 8, 128, 256 (n = 1001 and 16384); the feature map also at the
   trainer's shape, at d = 64 and 130, r = 70 and 1001, a ragged row tile
   and n = 2,200,000; the scaling megakernel as the log one; the row
   kernel (half-step and matvec) also at r = 40, 256, 512, 1024 and 4096,
   B = 1 and 3, n = 1003 and 16 (n not a multiple of the rows a warp
   reduces at once), and n = 2 and 7;
   the paged contract, half-step and matvec in float32 and bf16, B = 1, 3
   and 11, page sizes 8, 64 and 128, packed, mixed, scattered (a packed
   store after random evictions) and five-live-page (fewer live pages
   than contract CTAs) tables and an all-dead buffer, garbage on dead
   pages (1e6 in u, NaN in the factor) and dead slots on live pages, the
   flat contract run twice on the same buffer with its dead pages zeroed,
   and a table of 8320 pages over 8 slabs (two sweeps, two list windows);
   and log_matvec with -inf entries and an all -inf row. Tolerances: the
   feature map and the scaling kernels within 1e-5 of max
   |value|; the LSE kernels and the log megakernel's potentials atol 1e-4
   + rtol 1e-5 (summation order differs); the scaling megakernel's
   carries within 1e-5 of max |value|; both megakernels' block-end errors
   1e-4 relative + 1e-6, and a second launch bit-identical; the paged
   kernels within 1e-5 of max |value|, dead pages exactly 0, a second
   contract launch bit-identical; log_matvec as the LSE kernels;
3. the device kernels one call of the feature map and of the flat and
   paged contracts launches (profiler), then times (CUDA events, median of 21 batches of
   10 launches, queued behind a device spin so that host overhead is not
   timed) of each kernel, its plain
   version and one PyTorch library call computing the same function where
   there is one, beside the least time the card could take (bytes over
   3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger):
   at the solve path's shape, the feature map in both epilogues there and
   at the trainer's shapes (beside ``fill_`` of its output, evict-first
   stores on and off), the LSE kernels at batch 2048, r = 128 in
   bf16, and the log megakernel at the OT-GAN shape; the scaling kernels
   at n = 16384, r = 1024 and 256, float32 and bf16 (the contract also
   its slabs alone and its scalar path; the row kernel also with
   evict-first loads, and with t in shared memory where the planner
   keeps it in registers), each shape
   beside a read floor (``xi.sum()``, the card's own full read of the
   same bytes), one iteration of the scaling plan in its order on two
   factors (evict-first row loads on, off and as planned), a digest of
   the flat
   contract's output at fixed seeds (equal between two checkouts whose
   flat contract sums in the same order), and the scaling megakernel at the
   OT-GAN shape; the paged kernels at C = 32768, r = 1024 and 256,
   float32 and bf16, 100%, 50% and 25% of pages live, each beside the
   flat kernel on the same buffer and a read floor of the live pages (the
   contract also its slabs alone and evict-first loads on and off, and
   one iteration of the paged plan in its order on two buffers at 50%
   live, evict-first loads on, off and as planned);
   log_matvec at (16384, 1024);
4. the solve path: three annealed ``solve()`` requests on Gaussian point
   clouds (N(1, I) against N(0, 0.1 I), n = m = 16384, d = 8, r = 1024,
   eps = 0.1, seeds 0, 1, 2, tol = 1e-4, well above the float32 noise floor
   of the marginal error at this n) and one ``sinkhorn_divergence_geometry``,
   with the launch counters set to 0 before and read after; each request
   is then rerun with ``use_pallas=False`` (the plain torch operators) and
   must agree: cost within 1e-4 relative, iterations within 1 per stage;
5. the training path, with the counters set to 0 before and read after:
   the OT-GAN trainer's own ``--strict`` run at its default configuration
   (batch 256, r = 128, 40 iterations, 60 steps; 15 megakernel launches a
   step) and bench_gan's batch-2048 gradient (streaming bf16 plan). Then
   the same with ``use_pallas=False``: W̄ within 1e-4 relative and every
   gradient within 1e-3 of its max |grad|, from the same weights (the
   strict run's step-0 weights and data, whose W̄ is also held against the
   run's own, and its trained weights); a profile of one adversary and one
   generator step; and ms per step of the megakernel plan against the
   streaming plan on the same data;
6. the scaling path (Algorithm 1 in scaling space), with the counters set
   to 0 before and read after: ``solve(method="auto")`` on explicit
   features U(0, 1) + 0.05 (n = m = 16384, r = 1024 and 256, eps 0.5, 20
   iterations, float32 and bf16; the JAX package's hot-loop benchmark),
   ``solve(method="factored")`` on phase 4's clouds at eps 1.0, tol 1e-4,
   ``OTObjective.solve`` at the OT-GAN batch (256, r = 128, bf16, 40
   iterations: the scaling megakernel) and the scaling divergence with its
   envelope gradient (n = m = 4096, r = 256, 20 iterations). Then each is
   held against ``use_pallas=False`` (cost 1e-4 relative, u and v within
   1e-4 of max |value|, |d n_iter| <= 1), the clouds also against
   ``method="log_factored"``, the divergence against the same call on the
   CPU (value 1e-4 relative, gradients within 1e-3 of max |grad|); plus a
   profile of one feature solve and ms per objective solve of the
   megakernel against the streaming plan;
7. the streaming path, with the counters set to 0 before and read after:
   two ``StreamingDistribution.from_points`` stores of 16384 live points
   (bench_stream's clouds, 0.5 N(0, I_2) and 0.5 N(0, I_2) + 0.3, through
   r = 1024 Lemma-1 Gaussian features at eps 0.5; capacity 32768, so half
   the pages are dead) behind a ``StreamingOTService`` (max_batch 4), tol
   1e-4: warmup, a cold solve, 8 submitted mutations (each evicts 256
   random ids and inserts 256 new points a side) drained as 2 coalesced
   warm re-solves, then 2 direct ``StreamingSolver.update`` calls; in
   scaling f32, scaling bf16 (bf16 device buffers) and log f32. Then each
   solve is held against the same solve with ``use_pallas=False`` from
   the same state (cost 1e-4 relative, |d n_iter| <= 1, f and g on live
   slots within 1e-4 of max |value|) and against a cold
   ``solve(method="factored")`` on the compact live support (cost 1e-4
   relative), and the warm re-solves must take fewer iterations in all
   than those cold solves; in scaling mode the plan must be ``paged``,
   the paged kernels launched and the flat trio not; plus a split and a
   profile of one more update.

The line before the last is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``. TF32 is off throughout.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

N = M = 16384
D = 8
R_ANCHORS = 1024
EPS = 0.1
SEEDS = (0, 1, 2)
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 20_000_000      # a ~10 ms device spin ahead of each batch
SLEEP_MS = [0.0]                # measured by calibrate_sleep
TOL = 1e-4                      # marginal L1 tolerance of the main path
FEATURE_REL_TOL = 1e-5
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
COST_RTOL = 1e-4
GRAD_REL_TOL = 1e-3             # of max |grad|
GAN_BATCH = 256                 # the OT-GAN example's default batch
GAN_BIG_BATCH = 2048            # bench_gan's largest batch
GAN_STEPS = 60                  # the reference CI's train-smoke length
SCALING_REL_TOL = 1e-5          # scaling kernels: of max |value|
SCALING_EPS = 0.5               # the JAX hot-loop benchmark's eps
SCALING_ITERS = 20              # and its iteration count
STREAM_CAPACITY = 32768         # bucket_capacity(N, 64): half the pages dead
STREAM_PAGE = 64                # the stores' default page
STREAM_DELTA = 256              # ids evicted and rows inserted a mutation
STREAM_MUTATIONS = 8            # submitted a run, coalesced 4 to a flush
STREAM_RUNS = (("scaling", "highest"), ("scaling", "bf16"),
               ("log", "highest"))
STREAM_D = 2                    # bench_stream's clouds: 0.5 N(0, I_2) and
STREAM_SHIFT = 0.3              # 0.5 N(0, I_2) + 0.3
STREAM_EPS = 0.5                # the smallest eps whose Gaussian features
                                # do not underflow to 0 at this size

KERNEL_INFO = {
    "gaussian_feature_map": {
        "source": "src/repro_torch/kernels/csrc/feature_map.cu",
        "replaces": "src/repro/kernels/feature_map.py:114",
    },
    "log_feature_contract": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:202",
    },
    "log_halfstep": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:279",
    },
    "log_sinkhorn_block": {
        "source": "src/repro_torch/kernels/csrc/fused_loop.cu",
        "replaces": "src/repro/kernels/fused_loop.py:383",
    },
    "feature_contract": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:130",
    },
    "sinkhorn_halfstep": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:218",
    },
    "feature_matvec": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:225",
    },
    "sinkhorn_block": {
        "source": "src/repro_torch/kernels/csrc/fused_loop.cu",
        "replaces": "src/repro/kernels/fused_loop.py:254",
    },
    "log_matvec": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:90",
    },
    "paged_feature_contract": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:128",
    },
    "paged_halfstep": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:221",
    },
    "paged_feature_matvec": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:221",
    },
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def demangle(symbol: str) -> str:
    """A kernel's name as ``c++filt`` prints it, without the anonymous
    namespace and the parameter list (the mangled name where there is no
    ``c++filt``)."""
    symbol = symbol.strip()
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    out = out.replace("(anonymous namespace)::", "")
    return out.split("(", 1)[0] or symbol


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------


def compare(torch, got, want, *, rel_to_max=None, atol=0.0, rtol=0.0):
    """Max abs error of ``got`` against ``want`` and whether it is within
    tolerance. Non-finite entries must match exactly and NaN fails."""
    if torch.isnan(got).any() or torch.isnan(want).any():
        return float("nan"), False
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or \
            not torch.equal(got[~fin], want[~fin]):
        return float("inf"), False
    if not fin.any():
        return 0.0, True
    diff = (got[fin] - want[fin]).abs()
    max_abs = float(diff.max())
    if rel_to_max is not None:
        scale = float(want[fin].abs().max())
        return max_abs, max_abs <= rel_to_max * scale
    ok = bool((diff <= atol + rtol * want[fin].abs()).all())
    return max_abs, ok


def anchors_for(torch, np, n_anchors: int, d: int, eps: float, R: float,
                seed: int, device):
    from repro_torch.core import GaussianFeatureMap
    fm = GaussianFeatureMap(r=n_anchors, d=d, eps=eps, R=R)
    rng = np.random.default_rng(10_000 + seed)
    u = math.sqrt(fm.sigma2) * rng.standard_normal((n_anchors, d))
    return torch.as_tensor(u, dtype=torch.float32, device=device), fm.q


def feature_inputs(torch, np, n, r, d, eps, seed, device):
    """x ~ N(1, I), Lemma-1 anchors and their log-constants (incl. -log r/2)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, d)) + 1.0,
                        dtype=torch.float32, device=device)
    R = float(torch.linalg.norm(x, dim=1).max())
    u, q = anchors_for(torch, np, r, d, eps, R, seed, device)
    log_const = (0.25 * d * math.log(2.0 * q) + (u * u).sum(1) / (q * eps)
                 - 0.5 * math.log(r)).contiguous()
    return x, u, log_const


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, np, device, shapes, lse_shapes, bf16_shapes,
                  block_shapes, scaling_shapes, scaling_block_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    errs = {k: 0.0 for k in KERNEL_INFO}
    failures = []

    def record(name, case, err, ok):
        errs[name] = max(errs[name], err) if math.isfinite(err) else err
        log(f"  {name:22s} {case:48s} max_abs_err={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {case}")

    for (n, r, d, eps, neg_inf) in shapes:
        x, u, c = feature_inputs(torch, np, n, r, d, eps, n + r, device)
        if neg_inf:
            c[r // 2] = -math.inf
        for log_space in (True, False):
            got = gaussian_feature_map(x, u, c, inv_eps=1 / eps,
                                       log_space=log_space)
            want = ref.gaussian_feature_map_ref(x, u, c, inv_eps=1 / eps,
                                                log_space=log_space)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, rel_to_max=FEATURE_REL_TOL)
            record("gaussian_feature_map",
                   f"n={n} r={r} d={d} log={log_space} -inf={neg_inf}",
                   err, ok)

    for (n, m, r, B, neg_inf) in lse_shapes:
        g = torch.Generator(device=device).manual_seed(n * 31 + r * 7 + B)
        lw_n = 30.0 * torch.randn((n, r), generator=g, device=device) - 50.0
        lw_m = 30.0 * torch.randn((m, r), generator=g, device=device) - 50.0
        s = 10.0 * torch.randn((n, B), generator=g, device=device)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        if neg_inf:
            lw_n[n // 3, :] = -math.inf         # dead feature row
            lw_n[:, r // 2] = -math.inf         # dead anchor column
            lw_m[m // 4, :] = -math.inf
            s[n // 5, :] = -math.inf            # dead atoms (f = -inf)
            if B > 1:
                s[:, B - 1] = -math.inf         # an all -inf column
            t[r // 3, 0] = -math.inf
        got = log_feature_contract(lw_n, s)
        want = ref.log_feature_contract_ref(lw_n, s)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
        record("log_feature_contract", f"n={n} r={r} B={B} -inf={neg_inf}",
               err, ok)
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw_m, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw_m, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            record("log_halfstep",
                   f"m={m} r={r} B={B} scale={scale} -inf={neg_inf}", err, ok)
    check_bf16_lse(torch, np, device, bf16_shapes, record)
    check_block(torch, np, device, block_shapes, record)
    check_scaling(torch, np, device, scaling_shapes, record)
    check_scaling_block(torch, device, scaling_block_shapes, record)
    check_paged(torch, np, device, record)
    check_log_matvec(torch, device, record)
    return errs, failures


def check_bf16_lse(torch, np, device, shapes, record):
    """The two LSE kernels on bfloat16 factors against their plain versions
    (which widen the same bf16 values to float32)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    for (n, m, r, B, neg_inf) in shapes:
        g = torch.Generator(device=device).manual_seed(n * 13 + r + B)
        lw_n = (30.0 * torch.randn((n, r), generator=g, device=device)
                - 50.0).to(torch.bfloat16)
        lw_m = (30.0 * torch.randn((m, r), generator=g, device=device)
                - 50.0).to(torch.bfloat16)
        s = 10.0 * torch.randn((n, B), generator=g, device=device)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        if neg_inf:
            lw_n[n // 3, :] = -math.inf
            lw_n[:, r // 2] = -math.inf
            lw_m[m // 4, :] = -math.inf
            s[n // 5, :] = -math.inf
            t[r // 3, 0] = -math.inf
        got = log_feature_contract(lw_n, s)
        want = ref.log_feature_contract_ref(lw_n, s)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
        record("log_feature_contract", f"bf16 n={n} r={r} B={B} -inf={neg_inf}",
               err, ok)
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw_m, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw_m, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            record("log_halfstep",
                   f"bf16 m={m} r={r} B={B} scale={scale} -inf={neg_inf}",
                   err, ok)


def block_inputs(torch, np, n, m, r, d, eps, dtype, dead, seed, device):
    """A megakernel block's inputs as the log plan builds them: Gaussian
    log-features of two clouds stored at ``dtype``, uniform weights with
    ``dead`` zero-weight atoms on each side (potentials -inf), the carry
    (f0 = g0 = 0, t0 = LSE_i(log_xi + f0/eps)) and, with ``dead``, one
    anchor whose constant is -inf (an all -inf factor column)."""
    from repro_torch.kernels import ref
    x, u, c = feature_inputs(torch, np, n, r, d, eps, seed, device)
    rng = np.random.default_rng(seed + 1)
    y = torch.as_tensor(0.5 * rng.standard_normal((m, d)), dtype=torch.float32,
                        device=device)
    if dead:
        c[r // 2] = -math.inf
    lxi = ref.gaussian_feature_map_ref(x, u, c, inv_eps=1 / eps,
                                       log_space=True).to(dtype)
    lzt = ref.gaussian_feature_map_ref(y, u, c, inv_eps=1 / eps,
                                       log_space=True).to(dtype)
    a = torch.ones(n, device=device)
    b = torch.ones(m, device=device)
    if dead:
        a[n // 3::max(n // dead, 1)][:dead] = 0.0
        b[m // 4::max(m // dead, 1)][:dead] = 0.0
    a, b = a / a.sum(), b / b.sum()

    def masked_log(w):
        return torch.where(w > 0, torch.log(torch.where(w > 0, w, 1.0)),
                           -math.inf)[:, None].contiguous()

    loga, logb = masked_log(a), masked_log(b)
    f0 = torch.where(loga > -math.inf, 0.0, -math.inf).contiguous()
    g0 = torch.where(logb > -math.inf, 0.0, -math.inf).contiguous()
    t0 = ref.log_feature_contract_ref(lxi, f0 / eps)
    return lxi, lzt, loga, logb, b[:, None].contiguous(), f0, g0, t0


def check_block(torch, np, device, shapes, record):
    """The megakernel against log_sinkhorn_block_ref on the same inputs:
    f, g, t within atol 1e-4 + rtol 1e-5 (as the LSE kernels), the
    block-end error within 1e-4 relative + 1e-6; a second launch must be
    bit-identical (no atomics). Shapes the plan does not admit are refused
    by block_plan_fits and by the kernel's wrapper (ValueError)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_loop import (
        block_plan_fits,
        log_sinkhorn_block,
    )

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        eps = 0.5
        args = block_inputs(torch, np, n, m, r, D, eps, dtype, dead,
                            n + m + r, device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if not block_plan_fits(n, m, r, 1, dtype):
            try:
                log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                   momentum=mom)
                refused = False
            except ValueError:
                refused = True
            record("log_sinkhorn_block", case + " (not admitted: refused)",
                   0.0, refused)
            continue
        got = log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                 momentum=mom)
        again = log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                   momentum=mom)
        want = ref.log_sinkhorn_block_ref(*args, inner_steps=steps, eps=eps,
                                          momentum=mom)
        torch.cuda.synchronize()
        worst, all_ok = 0.0, True
        for gv, wv in zip(got[:3], want[:3]):
            err, ok = compare(torch, gv, wv, atol=LSE_ATOL, rtol=LSE_RTOL)
            worst, all_ok = max(worst, err), all_ok and ok
        e_got, e_want = float(got[3]), float(want[3])
        e_ok = abs(e_got - e_want) <= 1e-4 * abs(e_want) + 1e-6
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        record("log_sinkhorn_block",
               f"{case} err={e_got:.4e}/{e_want:.4e} repeat_identical={same}",
               worst, all_ok and e_ok and same)


def explicit_features(np, n, r, seed):
    """Features U(0, 1) + 0.05 from a numpy seed (benchmarks/run.py's
    bench_solver_iteration draws them so)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, r)) + 0.05).astype(np.float32)


def check_scaling(torch, np, device, shapes, record):
    """The scaling contract, half-step and matvec against their plain
    versions on the same inputs, within 1e-5 of max |value|. The half-step
    has a zero-weight atom on a positive row (exactly 0) and an all-zero
    factor row (marg / 0 = inf, in both). The contract runs twice on each
    shape (the reruns must be bit-identical), on its 16-byte path with row
    groups and forced onto its scalar path where the 16-byte path applies
    (B = 1, rows of 16 bytes); a shape tagged "contract" checks only it, a
    shape tagged "rows" only the row kernels (matvec and half-step)."""
    from repro_torch.kernels import kermatvec, ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    for (n, r, B, dtype, *only) in shapes:
        tag = f"{str(dtype)[6:]} n={n} r={r} B={B}"
        xi = torch.as_tensor(explicit_features(np, n, r, n + 7 * r + B),
                             device=device).to(dtype)
        g = torch.Generator(device=device).manual_seed(n * 3 + r + B)
        u = torch.rand((n, B), generator=g, device=device)
        t = torch.rand((r, B), generator=g, device=device)
        marg = torch.full((n, B), 1.0 / n, device=device)
        marg[n // 2] = 0.0
        if only != ["rows"]:
            want = ref.feature_contract_ref(xi, u)
            paths = [("chosen", kermatvec._flat_vectorized)]
            if kermatvec._flat_vectorized(xi, B):
                paths.append(("scalar", lambda *_: False))
            chosen = kermatvec._flat_vectorized
            for label, rule in paths:
                kermatvec._flat_vectorized = rule
                try:
                    path = "vector" if rule(xi, B) else "scalar"
                    got = feature_contract(xi, u)
                    again = feature_contract(xi, u)
                finally:
                    kermatvec._flat_vectorized = chosen
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                same = torch.equal(got, again)
                record("feature_contract",
                       f"{tag} {label} ({path}) path, rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}", err,
                       ok and same)
        if only == ["contract"]:
            continue
        nv, rows, _ = kermatvec._rows_kernel(
            r, B, kermatvec._vectorized(xi, B), xi.element_size())
        rows_tag = tag + (f" (t in registers, {nv} vectors a lane, {rows} "
                          "rows a batch)" if nv else " (t in shared memory)")
        got = feature_matvec(xi, t)
        want = ref.feature_matvec_ref(xi, t)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, rel_to_max=SCALING_REL_TOL)
        record("feature_matvec", rows_tag, err, ok)
        xz = xi.clone()
        xz[n // 5] = 0.0
        got = sinkhorn_halfstep(xz, t, marg)
        want = ref.sinkhorn_halfstep_ref(xz, t, marg)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, rel_to_max=SCALING_REL_TOL)
        ok = ok and bool((got[n // 2] == 0).all())
        if n > 1 and n // 5 != n // 2:
            ok = ok and bool(torch.isinf(got[n // 5]).all())
        record("sinkhorn_halfstep", f"{rows_tag} zero row/weight", err, ok)


def scaling_block_inputs(torch, n, m, r, dtype, dead, seed, device):
    """A scaling megakernel block's inputs as the plan builds them:
    features exp(N(0, 1)) (a range wide enough that 8 iterations do not
    converge), scaled by (r max(n, m))^-1/2 so that K's row sums, and with
    them u, v and s, are of order 1, at ``dtype``; uniform weights with
    ``dead`` zero-weight atoms a side, and the carry at u = v = 1,
    s = Zeta (Xi^T u)."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(seed)
    c = (r * max(n, m)) ** -0.5
    xi = (c * torch.exp(torch.randn((n, r), generator=g,
                                    device=device))).to(dtype)
    zeta = (c * torch.exp(torch.randn((m, r), generator=g,
                                      device=device))).to(dtype)
    a = torch.ones((n, 1), device=device)
    b = torch.ones((m, 1), device=device)
    if dead:
        a[n // 3::max(n // dead, 1)][:dead] = 0.0
        b[m // 4::max(m // dead, 1)][:dead] = 0.0
    a, b = a / a.sum(), b / b.sum()
    u0 = torch.ones((n, 1), device=device)
    v0 = torch.ones((m, 1), device=device)
    s0 = ref.feature_matvec_ref(zeta, ref.feature_contract_ref(xi, u0))
    return (xi.contiguous(), zeta.contiguous(), a, b, u0, v0,
            s0.contiguous())


def check_scaling_block(torch, device, shapes, record):
    """The scaling megakernel against sinkhorn_block_ref on the same
    inputs: u, v, s within 1e-5 of max |value|, the block-end error within
    1e-4 relative + 1e-6, a second launch bit-identical; shapes the plan
    does not admit are refused by block_plan_fits and by the wrapper."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_loop import block_plan_fits, sinkhorn_block

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        args = scaling_block_inputs(torch, n, m, r, dtype, dead, n + m + r,
                                    device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if not block_plan_fits(n, m, r, 1, dtype):
            try:
                sinkhorn_block(*args, inner_steps=steps, momentum=mom)
                refused = False
            except ValueError:
                refused = True
            record("sinkhorn_block", case + " (not admitted: refused)", 0.0,
                   refused)
            continue
        got = sinkhorn_block(*args, inner_steps=steps, momentum=mom)
        again = sinkhorn_block(*args, inner_steps=steps, momentum=mom)
        want = ref.sinkhorn_block_ref(*args, inner_steps=steps, momentum=mom)
        torch.cuda.synchronize()
        worst, all_ok = 0.0, True
        for gv, wv in zip(got[:3], want[:3]):
            err, ok = compare(torch, gv, wv, rel_to_max=SCALING_REL_TOL)
            worst, all_ok = max(worst, err), all_ok and ok
        e_got, e_want = float(got[3]), float(want[3])
        e_ok = abs(e_got - e_want) <= 1e-4 * abs(e_want) + 1e-6
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        dead_ok = bool((got[0][args[2] == 0] == 0).all())
        record("sinkhorn_block",
               f"{case} err={e_got:.4e}/{e_want:.4e} repeat_identical={same}",
               worst, all_ok and e_ok and same and dead_ok)


def page_table(np, n_pages, page_size, pattern, seed):
    """int32 live counts: ``"front"`` fills the first half of the pages, as
    a store packs its rows; ``"mixed"`` draws dead, partly live and full
    pages; ``"scattered"`` is a packed store after random evictions (the
    first three quarters of the pages, each emptied with probability 0.3,
    the rest holding 1 to page_size live slots); ``"few"`` has five live
    pages at random places (fewer than the contract's CTAs); ``"dead"`` is
    an all-dead buffer."""
    rng = np.random.default_rng(seed)
    if pattern == "front":
        return np.array([page_size] * (n_pages // 2)
                        + [0] * (n_pages - n_pages // 2), np.int32)
    if pattern == "dead":
        return np.zeros(n_pages, np.int32)
    if pattern == "scattered":
        used = np.arange(n_pages) < (3 * n_pages) // 4
        kept = rng.uniform(size=n_pages) >= 0.3
        return np.where(used & kept, rng.integers(1, page_size + 1, n_pages),
                        0).astype(np.int32)
    if pattern == "few":
        live = np.zeros(n_pages, np.int32)
        live[rng.choice(n_pages, size=min(5, n_pages), replace=False)] = \
            page_size
        return live
    kind = rng.integers(0, 3, n_pages)
    partial = rng.integers(1, page_size, n_pages)
    return np.where(kind == 0, 0, np.where(kind == 1, partial, page_size)
                    ).astype(np.int32)


def check_paged(torch, np, device, record):
    """The paged contract, half-step and matvec against their plain
    versions, within 1e-5 of max |value|, in float32 and bf16, B = 1 and 3
    (and 11: two column chunks), page sizes 8, 64 and 128, the page
    patterns of ``page_table`` (packed, mixed, scattered, five live pages,
    all dead); dead pages hold garbage (1e6 in u, NaN in the factor rows),
    so a kernel that read them would disagree; live pages hold dead slots
    (marg 0, so the half-step gives exactly 0 there). Dead pages' outputs
    are exactly 0 and a second contract launch is bit-identical; the
    contract runs on both of its paths where the vector path applies. The
    flat contract on the same buffer with the dead pages zeroed runs twice
    too (bit-identical) and agrees with the paged one."""
    from repro_torch.kernels import paged, ref
    from repro_torch.kernels.kermatvec import feature_contract
    from repro_torch.kernels.paged import (
        paged_feature_contract,
        paged_feature_matvec,
        paged_halfstep,
    )

    cases = [(STREAM_CAPACITY, R_ANCHORS, 1, STREAM_PAGE, "front"),
             (STREAM_CAPACITY, R_ANCHORS, 1, STREAM_PAGE, "scattered"),
             (STREAM_CAPACITY, 256, 1, STREAM_PAGE, "few"),
             (4096, 256, 3, 64, "mixed"), (4096, 1024, 1, 8, "mixed"),
             (4096, 256, 3, 64, "scattered"), (4096, 1024, 1, 8, "few"),
             (4096, 1001, 1, 128, "mixed"), (1024, 64, 3, 128, "dead"),
             (2048, 40, 11, 8, "mixed"), (4096, 1032, 1, 64, "mixed"),
             # 8320 pages (two sweeps of the page table) over 8 slabs of
             # about 690 live pages each (two list windows)
             (66560, 4096, 11, 8, "mixed")]
    for dtype in (torch.float32, torch.bfloat16):
        for (C, r, B, ps, pattern) in cases:
            tag = f"{str(dtype)[6:]} C={C} r={r} B={B} page={ps} {pattern}"
            live_np = page_table(np, C // ps, ps, pattern, C + r + ps)
            live = torch.as_tensor(live_np, device=device)
            page_mask = torch.as_tensor(np.repeat(live_np > 0, ps),
                                        device=device)
            slot_live = torch.zeros(C, dtype=torch.bool, device=device)
            for p in np.nonzero(live_np)[0]:      # the first live[p] slots
                slot_live[p * ps:p * ps + live_np[p]] = True
            g = torch.Generator(device=device).manual_seed(C + B + ps)
            xi = (torch.rand((C, r), generator=g, device=device)
                  + 0.05).to(dtype)          # explicit_features, on the card
            xi_flat = torch.where(page_mask[:, None], xi, 0).contiguous()
            xi[~page_mask] = math.nan
            u = torch.rand((C, B), generator=g, device=device)
            u_flat = torch.where(page_mask[:, None], u, 0).contiguous()
            u[~page_mask] = 1e6
            t = torch.rand((r, B), generator=g, device=device)
            marg = torch.where(slot_live[:, None],
                               torch.full((C, B), 1.0 / C, device=device),
                               torch.zeros((C, B), device=device))
            want = ref.paged_contract_ref(xi, u, live, page_size=ps)
            paths = [("chosen", paged._flat_vectorized)]
            if paged._flat_vectorized(xi, B):
                paths.append(("scalar", lambda *_: False))
            chosen = paged._flat_vectorized
            for label, rule in paths:
                paged._flat_vectorized = rule
                try:
                    got = paged_feature_contract(xi, u, live, page_size=ps)
                    again = paged_feature_contract(xi, u, live, page_size=ps)
                finally:
                    paged._flat_vectorized = chosen
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                same = torch.equal(got, again)
                record("paged_feature_contract",
                       f"{tag} {label} path, rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}", err,
                       ok and same)
            flat = feature_contract(xi_flat, u_flat)
            flat_again = feature_contract(xi_flat, u_flat)
            torch.cuda.synchronize()
            err, ok = compare(torch, flat, want, rel_to_max=SCALING_REL_TOL)
            same = torch.equal(flat, flat_again)
            record("feature_contract",
                   f"{tag} flat on the zeroed buffer, rerun "
                   f"{'bit-identical' if same else 'DIFFERS'}", err,
                   ok and same)
            for name, got, want in (
                    ("paged_halfstep",
                     paged_halfstep(xi, t, marg, live, page_size=ps),
                     ref.paged_halfstep_ref(xi, t, marg, live,
                                            page_size=ps)),
                    ("paged_feature_matvec",
                     paged_feature_matvec(xi, t, live, page_size=ps),
                     ref.paged_matvec_ref(xi, t, live, page_size=ps))):
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                ok = ok and bool((got[~page_mask] == 0).all())
                if name == "paged_halfstep":
                    ok = ok and bool((got[~slot_live] == 0).all())
                record(name, tag, err, ok)


def check_log_matvec(torch, device, record):
    """log_matvec against its plain version (atol 1e-4 + rtol 1e-5, the LSE
    kernels' tolerance) in float32 and bf16, on both load paths, with
    -inf entries, an all -inf row (gives -inf) and -inf in t."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_matvec

    for dtype in (torch.float32, torch.bfloat16):
        for (m, r, neg_inf) in ((N, R_ANCHORS, False), (1023, 300, True),
                                (777, 1001, True), (5, 129, True),
                                (4096, 1032, True)):
            g = torch.Generator(device=device).manual_seed(m + r)
            log_m = (30.0 * torch.randn((m, r), generator=g, device=device)
                     - 50.0)
            t = 10.0 * torch.randn((r,), generator=g, device=device)
            if neg_inf:
                log_m[m // 2] = -math.inf
                log_m[:, r // 3] = -math.inf
                t[r - 1] = -math.inf
            log_m = log_m.to(dtype)
            got = log_matvec(log_m, t)
            want = ref.log_matvec_ref(log_m, t)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            if neg_inf:
                ok = ok and float(got[m // 2]) == -math.inf
            record("log_matvec", f"{str(dtype)[6:]} m={m} r={r} "
                   f"-inf={neg_inf}", err, ok)


# ---------------------------------------------------------------------------
# Phase 3: times
# ---------------------------------------------------------------------------


def time_ms(torch, fn, batches=21, per_batch=10, warmup=3):
    """Device time of one call of ``fn``: the median over ``batches`` of the
    mean of ``per_batch`` back-to-back calls between two CUDA events. Each
    batch is queued behind a ``torch.cuda._sleep`` spin, so the host has
    enqueued the whole batch before the device reaches it and the events
    see device time, not the Python wrapper's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means, host_bound = [], 0
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_bound += enqueue_ms > SLEEP_MS[0]
        means.append(start.elapsed_time(end) / per_batch)
    if host_bound:
        log(f"  (warning: {host_bound} of {batches} batches took longer to "
            "enqueue than the spin; their times include host time)")
    return statistics.median(means)


def cycling(fn, args):
    """A call of ``fn`` on the next of ``args`` each time (round robin)."""
    state = [0]

    def call():
        state[0] = (state[0] + 1) % len(args)
        return fn(args[state[0]])

    return call


def calibrate_sleep(torch):
    """Device milliseconds of one ``torch.cuda._sleep(SLEEP_CYCLES)``."""
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    SLEEP_MS[0] = start.elapsed_time(end)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_per_call(torch, fn):
    """Device kernels one call of ``fn`` launches, as the profiler sees
    them: (count, names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    return sum(e.count for e in rows), sorted({e.key[:40] for e in rows})


def forced(module, key, value):
    """A context setting ``module._FORCE[key]`` (a launch option the
    planner otherwise picks) for its body; a no-op where the module has no
    such option (a checkout from before the option)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        opts = getattr(module, "_FORCE", None)
        if opts is None or key not in opts:
            yield False
            return
        old = opts[key]
        opts[key] = value
        try:
            yield True
        finally:
            opts[key] = old

    return ctx()


def launches_per_call(torch, np, device):
    """The device kernels one call of each redesigned wrapper launches
    (the profiler's kernel rows), at the solve shape: the feature map,
    the scaling contract in float32 and bf16, and the paged contract
    (float32, every other page live)."""
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.kermatvec import feature_contract
    from repro_torch.kernels.paged import paged_feature_contract

    x, u, c = feature_inputs(torch, np, N, R_ANCHORS, D, EPS, 0, device)
    xi = torch.rand((N, R_ANCHORS), device=device)
    xi16 = xi.to(torch.bfloat16)
    w = torch.rand((N, 1), device=device)
    live = torch.full((N // STREAM_PAGE,), STREAM_PAGE, dtype=torch.int32,
                      device=device)
    live[::2] = 0
    for label, fn in (
            ("gaussian_feature_map", lambda: gaussian_feature_map(
                x, u, c, inv_eps=1 / EPS, log_space=True)),
            ("feature_contract f32", lambda: feature_contract(xi, w)),
            ("feature_contract bf16", lambda: feature_contract(xi16, w)),
            ("paged_feature_contract", lambda: paged_feature_contract(
                xi, w, live, page_size=STREAM_PAGE))):
        count, names = kernels_per_call(torch, fn)
        log(f"  {label:22s} device kernels a call: {count} {names}")


def time_feature_map(torch, np, device):
    """Phase 3 for the feature map beyond its JSON row: both epilogues at
    the solve shape (n = 16384, r = 1024, d = 8, eps 0.1) and at the
    trainer's shapes (n = 2048 and 256, r = 128, d = 8, eps 0.5), each
    beside ``x @ anchors.T`` and a ``fill_`` of the same output (the
    card's own store rate), and the evict-first store hint forced on and
    off where the planner leaves the choice."""
    from repro_torch.kernels import feature_map as fm_mod
    from repro_torch.kernels.feature_map import gaussian_feature_map

    for n, r, eps in ((N, R_ANCHORS, EPS), (GAN_BIG_BATCH, 128, 0.5),
                      (GAN_BATCH, 128, 0.5)):
        x, u, c = feature_inputs(torch, np, n, r, D, eps, 1, device)
        b_ms, b_by = bound(4.0 * (n * D + r * D + r + n * r),
                           2.0 * n * r * D + 4.0 * n * r)
        lib_ms = time_ms(torch, lambda: x @ u.T)
        fill = torch.empty((n, r), device=device)
        fill_ms = time_ms(torch, lambda: fill.fill_(1.0))
        log(f"  (n, r) = ({n}, {r}) float32 fill_: {fill_ms:.4f} ms "
            f"({4e-9 * n * r / fill_ms:.3f} TB/s written)")
        for log_space in (True, False):
            def call():
                return gaussian_feature_map(x, u, c, inv_eps=1 / eps,
                                            log_space=log_space)
            ms = time_ms(torch, call)
            extra = []
            for hint in (True, False):
                with forced(fm_mod, "stream", hint) as ok:
                    if ok:
                        extra.append(f"evict-first {'on' if hint else 'off'}"
                                     f" {time_ms(torch, call):.4f} ms")
            log(f"  gaussian_feature_map   n={n} r={r} d={D} "
                f"{'log' if log_space else 'exp'}: kernel {ms:.4f} ms  "
                f"library {lib_ms:.4f} ms (x @ anchors.T)  bound {b_ms:.5f} ms"
                f" ({b_by})  kernel/bound {ms / b_ms:.2f}  {'; '.join(extra)}")


def time_kernels(torch, np, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    x, u, c = feature_inputs(torch, np, N, R_ANCHORS, D, EPS, 0, device)
    inv = 1.0 / EPS
    log_w = gaussian_feature_map(x, u, c, inv_eps=inv, log_space=True)
    g = torch.Generator(device=device).manual_seed(0)
    s = 10.0 * torch.randn((N, 1), generator=g, device=device)
    t = log_feature_contract(log_w, s)
    lmarg = torch.full((M, 1), -math.log(M), device=device)
    n, r, d, B = N, R_ANCHORS, D, 1
    rows = {}

    def row(name, kernel, plain, library, nbytes, flops):
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        library_ms = time_ms(torch, library)
        b_ms, b_by = bound(nbytes, flops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"  {name:22s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {library_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            f"kernel/bound {ms / b_ms:.2f}")

    def library_dot():
        return x @ u.T

    row("gaussian_feature_map",
        lambda: gaussian_feature_map(x, u, c, inv_eps=inv, log_space=True),
        lambda: ref.gaussian_feature_map_ref(x, u, c, inv_eps=inv,
                                             log_space=True),
        library_dot,
        4.0 * (n * d + r * d + r + n * r), 2.0 * n * r * d + 4.0 * n * r)
    row("log_feature_contract",
        lambda: log_feature_contract(log_w, s),
        lambda: ref.log_feature_contract_ref(log_w, s),
        lambda: torch.logsumexp(log_w[:, :, None] + s[:, None, :], dim=0),
        4.0 * (n * r + n * B + r * B), 3.0 * n * r * B)
    row("log_halfstep",
        lambda: log_halfstep(log_w, t, lmarg, scale=EPS),
        lambda: ref.log_halfstep_ref(log_w, t, lmarg, scale=EPS),
        lambda: torch.logsumexp(log_w[:, :, None] + t[None, :, :], dim=1),
        4.0 * (M * r + r * B + 2 * M * B), 3.0 * M * r * B)
    return rows


def time_training_kernels(torch, np, device):
    """Phase 3 at the training path's shapes: the bf16 contract and
    half-step at the streaming plan's batch 2048, r = 128 (float32 beside
    them), and the megakernel at the OT-GAN shape n = m = 256, r = 128,
    bf16, inner_steps = 8. No PyTorch call computes eight Sinkhorn
    iterations, so the megakernel has no library time."""
    from repro_torch.kernels import logmatvec, ref
    from repro_torch.kernels.fused_loop import log_sinkhorn_block
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    rows = {}
    n, r, B = GAN_BIG_BATCH, 128, 1
    x, u, c = feature_inputs(torch, np, n, r, D, 2.0, 3, device)
    log_w32 = ref.gaussian_feature_map_ref(x, u, c, inv_eps=0.5,
                                           log_space=True)
    g = torch.Generator(device=device).manual_seed(3)
    s = torch.randn((n, 1), generator=g, device=device)
    lmarg = torch.full((n, 1), -math.log(n), device=device)
    for dtype in (torch.bfloat16, torch.float32):
        log_w = log_w32.to(dtype)
        t = log_feature_contract(log_w, s)
        fb = log_w.element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, kernel, plain, library, nbytes, flops in (
            ("log_feature_contract",
             lambda: log_feature_contract(log_w, s),
             lambda: ref.log_feature_contract_ref(log_w, s),
             lambda: torch.logsumexp(log_w.float()[:, :, None]
                                     + s[:, None, :], dim=0),
             fb * n * r + 4.0 * (n * B + r * B), 3.0 * n * r * B),
            ("log_halfstep",
             lambda: log_halfstep(log_w, t, lmarg, scale=2.0),
             lambda: ref.log_halfstep_ref(log_w, t, lmarg, scale=2.0),
             lambda: torch.logsumexp(log_w.float()[:, :, None]
                                     + t[None, :, :], dim=1),
             fb * n * r + 4.0 * (r * B + 2 * n * B), 3.0 * n * r * B)):
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain)
            library_ms = time_ms(torch, library)
            b_ms, b_by = bound(nbytes, flops)
            rows[f"{name}/{tag}"] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=library_ms, bound_ms=b_ms,
                                         bound_by=b_by)
            log(f"  {name:22s} {tag} n={n} r={r}: kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  library {library_ms:.4f} ms  bound "
                f"{b_ms:.5f} ms ({b_by})  kernel/bound {ms / b_ms:.2f}")
        # At r = 128 the contract takes its scalar path; the vector path,
        # which leaves most of each CTA idle here, is timed beside it.
        chosen = logmatvec._contract_vectorized
        logmatvec._contract_vectorized = logmatvec._vectorized
        try:
            vec_ms = time_ms(torch, lambda: log_feature_contract(log_w, s))
        finally:
            logmatvec._contract_vectorized = chosen
        log(f"  log_feature_contract   {tag} n={n} r={r}: 16-byte vector path "
            f"forced {vec_ms:.4f} ms (the wrapper takes the "
            f"{'vector' if chosen(log_w, B) else 'scalar'} path)")

    n = m = GAN_BATCH
    steps = 8
    args = block_inputs(torch, np, n, m, 128, D, 0.5, torch.bfloat16, 0, 7,
                        device)
    nbytes = 2.0 * (n + m) * 128 + 4.0 * (3 * n + 4 * m + 2 * 128 + 1)
    flops = 3.0 * 128 * (steps * 2 * (n + m) + m)
    ms = time_ms(torch, lambda: log_sinkhorn_block(
        *args, inner_steps=steps, eps=0.5))
    plain_ms = time_ms(torch, lambda: ref.log_sinkhorn_block_ref(
        *args, inner_steps=steps, eps=0.5))
    b_ms, b_by = bound(nbytes, flops)
    rows["log_sinkhorn_block"] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=None, bound_ms=b_ms,
                                      bound_by=b_by)
    log(f"  log_sinkhorn_block     bf16 n=m={n} r=128 inner_steps={steps}: "
        f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library none  bound "
        f"{b_ms:.5f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    return rows


def time_scaling_kernels(torch, np, device):
    """Phase 3 for the scaling path: the contract, half-step and matvec at
    n = 16384, r = 1024 and 256, float32 and bf16 (B = 1), each beside its
    plain version and the one PyTorch call computing the same function
    (``xi.T @ u``, ``marg / (xi @ t)``, ``xi @ t``; bf16 factors widened
    first, as the kernels widen them), and the scaling megakernel at the
    OT-GAN shape n = m = 256, r = 128, bf16, 8 iterations (no PyTorch call
    runs Sinkhorn iterations). A factor of 8 to 32 MiB fits the 50 MB L2,
    so each call is timed cold, cycling through copies of the factor that
    together exceed 100 MB (the bound counts device-memory bytes), and warm,
    on one copy (what a solve whose two factors fit the L2 finds). The
    JSON line takes the cold float32 r = 1024 rows, the shape of the
    scaling path's first request."""
    from repro_torch.kernels import kermatvec, ref
    from repro_torch.kernels.fused_loop import sinkhorn_block
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    rows = {}
    n, B = N, 1
    g = torch.Generator(device=device).manual_seed(11)
    u = torch.rand((n, B), generator=g, device=device)
    marg = torch.full((n, B), 1.0 / n, device=device)
    for r in (R_ANCHORS, 256):
        xi32 = torch.as_tensor(explicit_features(np, n, r, r), device=device)
        t = torch.rand((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            copies = [xi32.to(dtype, copy=True) for _ in
                      range(max(1, math.ceil(100e6 / (fb * n * r))))]
            tag = "f32" if dtype == torch.float32 else "bf16"
            for name, kernel, plain, library, nbytes, flops in (
                ("feature_contract",
                 lambda xi: feature_contract(xi, u),
                 lambda xi: ref.feature_contract_ref(xi, u),
                 lambda xi: xi.float().T @ u,
                 fb * n * r + 4.0 * (n * B + r * B), 2.0 * n * r * B),
                ("sinkhorn_halfstep",
                 lambda xi: sinkhorn_halfstep(xi, t, marg),
                 lambda xi: ref.sinkhorn_halfstep_ref(xi, t, marg),
                 lambda xi: marg / (xi.float() @ t),
                 fb * n * r + 4.0 * (r * B + 2 * n * B),
                 2.0 * n * r * B + n * B),
                ("feature_matvec",
                 lambda xi: feature_matvec(xi, t),
                 lambda xi: ref.feature_matvec_ref(xi, t),
                 lambda xi: xi.float() @ t,
                 fb * n * r + 4.0 * (r * B + n * B), 2.0 * n * r * B)):
                cold = [time_ms(torch, cycling(fn, copies))
                        for fn in (kernel, plain, library)]
                warm = time_ms(torch, lambda: kernel(copies[0]))
                b_ms, b_by = bound(nbytes, flops)
                row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                           bound_ms=b_ms, bound_by=b_by)
                rows[f"{name}/{tag}/r={r}"] = row
                if tag == "f32" and r == R_ANCHORS:
                    rows[name] = row
                log(f"  {name:22s} {tag} n={n} r={r}: kernel {cold[0]:.4f} ms"
                    f" (L2-warm {warm:.4f})  plain {cold[1]:.4f} ms  library "
                    f"{cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                    f"kernel/bound {cold[0] / b_ms:.2f}")
            floor_ms = time_ms(torch, cycling(lambda xi: xi.sum(), copies))
            log(f"  read floor             {tag} n={n} r={r}: xi.sum() "
                f"{floor_ms:.4f} ms ({fb * n * r / floor_ms * 1e-9:.3f} TB/s;"
                " the card's own full read of the factor, no yardstick)")
            xi, zeta = copies[0], copies[1]

            def iteration():
                s = feature_contract(zeta, u)
                sinkhorn_halfstep(xi, s, marg)
                feature_contract(xi, u)
                feature_matvec(zeta, t)

            time_plan_iteration(
                torch, iteration, f"{tag} n={n} r={r}, two factors of "
                f"{fb * n * r / 2**20:.0f} MiB", kermatvec)
            with forced(kermatvec, "stream", True) as ok:
                if ok:
                    ef_ms = [time_ms(torch, cycling(fn, copies)) for fn in (
                        lambda xi: sinkhorn_halfstep(xi, t, marg),
                        lambda xi: feature_matvec(xi, t))]
                    log(f"  row kernels            {tag} n={n} r={r}: "
                        f"evict-first loads forced: half-step "
                        f"{ef_ms[0]:.4f} ms, matvec {ef_ms[1]:.4f} ms")
            if getattr(kermatvec, "_rows_kernel", None) and \
                    kermatvec._rows_kernel(r, B, True, fb)[0]:
                # t in shared memory, which the planner leaves at this shape
                chosen = kermatvec._rows_kernel
                kermatvec._rows_kernel = lambda r, B, *_: (0, 1, 4 * r * B)
                try:
                    smem_ms = [time_ms(torch, cycling(fn, copies)) for fn in (
                        lambda xi: sinkhorn_halfstep(xi, t, marg),
                        lambda xi: feature_matvec(xi, t))]
                finally:
                    kermatvec._rows_kernel = chosen
                log(f"  row kernels            {tag} n={n} r={r}: t in "
                    f"shared memory forced: half-step {smem_ms[0]:.4f} ms, "
                    f"matvec {smem_ms[1]:.4f} ms (the wrapper keeps t in "
                    "registers)")
            with forced(kermatvec, "combine", False) as ok:
                if ok:
                    slabs_ms = time_ms(torch, cycling(
                        lambda xi: feature_contract(xi, u), copies))
                    log(f"  feature_contract       {tag} n={n} r={r}: slabs "
                        f"only {slabs_ms:.4f} ms (no grid barrier or "
                        "combine; t not formed)")
            if getattr(kermatvec, "_flat_vectorized", None) and \
                    kermatvec._flat_vectorized(copies[0], B):
                # the scalar path, which the wrapper leaves at this shape
                chosen = kermatvec._flat_vectorized
                kermatvec._flat_vectorized = lambda *_: False
                try:
                    scalar_ms = time_ms(torch, cycling(
                        lambda xi: feature_contract(xi, u), copies))
                finally:
                    kermatvec._flat_vectorized = chosen
                log(f"  feature_contract       {tag} n={n} r={r}: scalar "
                    f"path forced {scalar_ms:.4f} ms (the wrapper takes the "
                    "16-byte path with row groups)")
            del copies, xi, zeta

    n = m = GAN_BATCH
    r, steps = 128, 8
    args = scaling_block_inputs(torch, n, m, r, torch.bfloat16, 0, 7, device)
    nbytes = 2.0 * (n + m) * r + 4.0 * (3 * n + 5 * m + 1)
    flops = steps * (4.0 * r * (n + m) + 4.0 * (n + m)) + 3.0 * m
    ms = time_ms(torch, lambda: sinkhorn_block(*args, inner_steps=steps))
    plain_ms = time_ms(torch, lambda: ref.sinkhorn_block_ref(
        *args, inner_steps=steps))
    b_ms, b_by = bound(nbytes, flops)
    rows["sinkhorn_block"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                  bound_ms=b_ms, bound_by=b_by)
    log(f"  sinkhorn_block         bf16 n=m={n} r={r} inner_steps={steps}: "
        f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library none  bound "
        f"{b_ms:.6f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    # a launch of one iteration splits the fixed cost (staging the factors,
    # the block-end error) from the cost of an iteration
    one_ms = time_ms(torch, lambda: sinkhorn_block(*args, inner_steps=1))
    log(f"  sinkhorn_block         inner_steps=1: kernel {one_ms:.4f} ms; "
        f"each further iteration {(ms - one_ms) / (steps - 1):.4f} ms")
    return rows


def time_plan_iteration(torch, iteration, what, module=None):
    """One Sinkhorn iteration in the plan's order (``ops._scaling_plan``'s
    and ``_paged_scaling_plan``'s step: contract zeta, half-step xi,
    contract xi, matvec zeta), run back to back on two factors as a solve
    runs it: each row kernel is followed by the contract of its own
    factor, which finds it in the L2 where the row kernel left it there,
    and each contract by a row kernel of the other factor. With
    ``module``, also with its evict-first loads forced on and off."""
    parts = []
    for label, value in (("evict-first on", True),
                         ("evict-first off", False)):
        with forced(module, "stream", value) as ok:
            if ok:
                parts.append(f"{label} {time_ms(torch, iteration):.4f} ms")
    parts.append(f"as planned {time_ms(torch, iteration):.4f} ms")
    log(f"  plan iteration         {what} (contract, half-step, contract, "
        f"matvec): {'; '.join(parts)}")


def flat_contract_digest(torch, device):
    """A digest of the flat contract's outputs at fixed seeds, over the
    16-byte and scalar paths, one and several splits, float32 and bf16:
    two checkouts (``--src``) print the same digest where their flat
    contracts are bit-identical."""
    import hashlib

    from repro_torch.kernels.kermatvec import feature_contract

    h = hashlib.sha256()
    g = torch.Generator(device=device).manual_seed(23)
    for n, r, B in ((N, R_ANCHORS, 1), (N, 256, 1), (1001, 40, 3),
                    (N, R_ANCHORS, 3), (1001, 1032, 1), (7, 12, 1)):
        xi32 = torch.rand((n, r), generator=g, device=device) + 0.05
        u = torch.rand((n, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            t = feature_contract(xi32.to(dtype), u)
            h.update(t.cpu().numpy().tobytes())
    log(f"  feature_contract       output digest at fixed seeds "
        f"(12 shapes): {h.hexdigest()[:32]}")


def time_paged_kernels(torch, np, device):
    """Phase 3 for the streaming path: the paged contract, half-step and
    matvec at C = 32768, r = 1024 and 256, float32 and bf16, B = 1, with
    100%, 50% and 25% of the pages live (the first pages, as a store packs
    them), each beside the flat kernel on the same buffer, its plain
    version and the PyTorch calls ``xi.T @ (u * mask)``, ``marg / (xi @ t)
    * mask`` and ``(xi @ t) * mask``. The bound counts the bytes of the
    live pages (each read once), the page table and the outputs. Each call
    is timed cold, cycling through copies of the buffer whose live pages
    together exceed 100 MB, and warm on one copy. Then log_matvec at
    (16384, 1024), float32 and bf16, against ``torch.logsumexp(log_m + t,
    1)``. The JSON line takes the cold float32 r = 1024 rows at 50% live
    (the streaming path's buffers) and log_matvec in float32."""
    from repro_torch.kernels import paged as paged_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_matvec
    from repro_torch.kernels.paged import (
        paged_feature_contract,
        paged_feature_matvec,
        paged_halfstep,
    )

    rows = {}
    C, B, ps = STREAM_CAPACITY, 1, STREAM_PAGE
    n_pages = C // ps
    g = torch.Generator(device=device).manual_seed(13)
    u = torch.rand((C, B), generator=g, device=device)
    marg = torch.full((C, B), 1.0 / C, device=device)
    for r in (R_ANCHORS, 256):
        xi32 = torch.as_tensor(explicit_features(np, C, r, 3 * r),
                               device=device)
        t = torch.rand((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            tag = "f32" if dtype == torch.float32 else "bf16"
            for share in (1.0, 0.5, 0.25):
                n_live = int(n_pages * share)
                live = torch.as_tensor(
                    [ps] * n_live + [0] * (n_pages - n_live),
                    dtype=torch.int32, device=device)
                mask = ref.page_mask(live, ps)[:, None].float()
                rows_live = n_live * ps
                copies = [xi32.to(dtype, copy=True) for _ in range(max(
                    1, math.ceil(100e6 / (fb * rows_live * r))))]
                table = 4.0 * n_pages
                for name, kernel, flat, plain, library, nbytes, flops in (
                    ("paged_feature_contract",
                     lambda xi: paged_feature_contract(xi, u, live,
                                                       page_size=ps),
                     lambda xi: feature_contract(xi, u),
                     lambda xi: ref.paged_contract_ref(xi, u, live,
                                                       page_size=ps),
                     lambda xi: xi.float().T @ (u * mask),
                     fb * rows_live * r + 4.0 * (rows_live * B + r * B)
                     + table, 2.0 * rows_live * r * B),
                    ("paged_halfstep",
                     lambda xi: paged_halfstep(xi, t, marg, live,
                                               page_size=ps),
                     lambda xi: sinkhorn_halfstep(xi, t, marg),
                     lambda xi: ref.paged_halfstep_ref(xi, t, marg, live,
                                                       page_size=ps),
                     lambda xi: marg / (xi.float() @ t) * mask,
                     fb * rows_live * r + 4.0 * (r * B + rows_live * B
                                                 + C * B) + table,
                     2.0 * rows_live * r * B + rows_live * B),
                    ("paged_feature_matvec",
                     lambda xi: paged_feature_matvec(xi, t, live,
                                                     page_size=ps),
                     lambda xi: feature_matvec(xi, t),
                     lambda xi: ref.paged_matvec_ref(xi, t, live,
                                                     page_size=ps),
                     lambda xi: (xi.float() @ t) * mask,
                     fb * rows_live * r + 4.0 * (r * B + C * B) + table,
                     2.0 * rows_live * r * B)):
                    cold = [time_ms(torch, cycling(fn, copies))
                            for fn in (kernel, flat, plain, library)]
                    warm = time_ms(torch, lambda: kernel(copies[0]))
                    b_ms, b_by = bound(nbytes, flops)
                    row = dict(ms=cold[0], plain_ms=cold[2],
                               library_ms=cold[3], bound_ms=b_ms,
                               bound_by=b_by)
                    rows[f"{name}/{tag}/r={r}/{share:.2f}"] = row
                    if tag == "f32" and r == R_ANCHORS and share == 0.5:
                        rows[name] = row
                    log(f"  {name:22s} {tag} C={C} r={r} live={share:.0%}: "
                        f"kernel {cold[0]:.4f} ms (L2-warm {warm:.4f})  flat "
                        f"{cold[1]:.4f} ms  plain {cold[2]:.4f} ms  library "
                        f"{cold[3]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                        f"kernel/bound {cold[0] / b_ms:.2f}")
                floor_ms = time_ms(torch, cycling(
                    lambda xi: xi[:rows_live].sum(), copies))
                log(f"  read floor             {tag} C={C} r={r} "
                    f"live={share:.0%}: xi[live rows].sum() {floor_ms:.4f} ms "
                    "(the card's own read of the live pages, no yardstick)")
                variants = []
                for label, key, value in (
                        ("slabs only (no grid barrier or combine; t not "
                         "formed)", "combine", False),
                        ("evict-first on", "stream", True),
                        ("evict-first off", "stream", False)):
                    with forced(paged_mod, key, value) as ok:
                        if ok:
                            ms = time_ms(torch, cycling(
                                lambda xi: paged_feature_contract(
                                    xi, u, live, page_size=ps), copies))
                            variants.append(f"{label} {ms:.4f} ms")
                if variants:
                    log(f"  paged_feature_contract {tag} C={C} r={r} "
                        f"live={share:.0%}: {'; '.join(variants)}")
                if share == 0.5:
                    xi, zeta = copies[0], copies[1]

                    def iteration():
                        s = paged_feature_contract(zeta, u, live,
                                                   page_size=ps)
                        paged_halfstep(xi, s, marg, live, page_size=ps)
                        paged_feature_contract(xi, u, live, page_size=ps)
                        paged_feature_matvec(zeta, t, live, page_size=ps)

                    time_plan_iteration(
                        torch, iteration, f"{tag} C={C} r={r} live=50%, two "
                        f"buffers of {fb * C * r / 2**20:.0f} MiB", paged_mod)
                    del xi, zeta
                del copies

    m, r = N, R_ANCHORS
    t = torch.randn((r,), generator=g, device=device)
    log_m32 = torch.randn((m, r), generator=g, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        fb = torch.finfo(dtype).bits // 8
        copies = [log_m32.to(dtype, copy=True) for _ in range(max(1, math.ceil(
            100e6 / (fb * m * r))))]
        cold = [time_ms(torch, cycling(fn, copies)) for fn in (
            lambda lm: log_matvec(lm, t),
            lambda lm: ref.log_matvec_ref(lm, t),
            lambda lm: torch.logsumexp(lm.float() + t[None, :], dim=1))]
        warm = time_ms(torch, lambda: log_matvec(copies[0], t))
        b_ms, b_by = bound(fb * m * r + 4.0 * (r + m), 3.0 * m * r)
        tag = "f32" if dtype == torch.float32 else "bf16"
        row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                   bound_ms=b_ms, bound_by=b_by)
        rows[f"log_matvec/{tag}"] = row
        if tag == "f32":
            rows["log_matvec"] = row
        log(f"  log_matvec             {tag} m={m} r={r}: kernel "
            f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain {cold[1]:.4f} ms  "
            f"library {cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
            f"kernel/bound {cold[0] / b_ms:.2f}")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def clouds(np, seed: int):
    """repro.data.synthetic.gaussian_clouds' distribution, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)) + 1.0
    y = math.sqrt(0.1) * rng.standard_normal((M, D))
    return x.astype(np.float32), y.astype(np.float32)


def build_problem(torch, np, seed, device):
    """A user's request: numpy clouds and anchors, the default device."""
    from repro_torch.core import OTProblem
    x, y = clouds(np, seed)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    u, _ = anchors_for(torch, np, R_ANCHORS, D, EPS, R, seed, "cpu")
    prob = OTProblem.from_point_clouds(x, y, u.numpy(), eps=EPS, R=R)
    if prob.a.device != device:
        raise RuntimeError(f"the default device put the request on "
                           f"{prob.a.device}, not {device}")
    return prob


def run_main_path(torch, np, device):
    """The counted run: three solve() requests and one divergence."""
    from repro_torch.core import EpsSchedule, sinkhorn_divergence_geometry, solve
    from repro_torch.kernels import launch_counts, reset_launch_counts

    schedule = EpsSchedule(eps_init=1.0, decay=0.5)
    problems = [build_problem(torch, np, s, device) for s in SEEDS]
    torch.cuda.synchronize()
    results = []
    reset_launch_counts()
    for seed, prob in zip(SEEDS, problems):
        before = launch_counts()
        t0 = time.perf_counter()
        res = solve(prob, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        results.append(res)
        log(f"  solve seed={seed}: cost={float(res.cost):.7f} "
            f"n_iter={res.n_iter} marginal_err={float(res.marginal_err):.3e} "
            f"wall={wall:.4f} s ({wall / res.n_iter * 1e3:.4f} ms/iteration)"
            f"  launches={delta}")
    before = launch_counts()
    t0 = time.perf_counter()
    div = sinkhorn_divergence_geometry(problems[0].geometry, tol=TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    log(f"  divergence seed=0: value={float(div):.7f} wall={wall:.3f} s  "
        f"launches={delta}")
    counts = launch_counts()
    return problems, results, div, counts


def kernel_rows(torch, prof):
    """The profiler's rows that are device kernels. A CPU-side row (an aten
    op, the autograd Function around a solve) also reports the device time
    of the kernels it launched, so summing every row counts them twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda]


def profile_solve(torch, problem, schedule):
    """Device busy share of one annealed solve request."""
    from repro_torch.core import solve
    profile_call(torch, "solve seed=0",
                 lambda: solve(problem, schedule=schedule, tol=TOL))


def profile_call(torch, label, fn):
    """Device busy share of one call of ``fn`` (a solve): the device time
    of every kernel the profiler saw over the call's wall time (both under
    the profiler, which slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(torch, prof)
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)
    log(f"  profiled {label}: wall={wall:.4f} s n_iter={res.n_iter} "
        f"device kernel time={device_us / 1e3:.3f} ms")
    if device_us <= 0:
        log("  device busy share: not measured (the profiler saw no device "
            "time)")
        return
    log(f"  device busy share {device_us / 1e6 / wall:.3f} "
        f"(idle {1 - device_us / 1e6 / wall:.3f}) under the profiler")
    for e in top[:6]:
        log(f"    {e.key[:60]:60s} {e.count:6d} calls "
            f"{e.self_device_time_total / 1e3:9.3f} ms")


def compare_main_path(torch, problems, results, div, schedule_cls):
    """Rerun each request on the kernels and with use_pallas=False; both
    must agree (cost rel <= 1e-4, |d n_iter| <= 1 per stage)."""
    from repro_torch.core import sinkhorn_log_geometry, solve_annealed

    failures = []
    schedule = schedule_cls(eps_init=1.0, decay=0.5)
    for seed, prob, res in zip(SEEDS, problems, results):
        k = solve_annealed(prob, schedule=schedule, tol=TOL)
        p = solve_annealed(prob, schedule=schedule, tol=TOL,
                           use_pallas=False)
        rel = abs(float(k.result.cost) - float(p.result.cost)) / \
            abs(float(p.result.cost))
        d_iter = [a - b for a, b in zip(k.stage_iters, p.stage_iters)]
        same = float(k.result.cost) == float(res.cost)
        finite = bool(torch.isfinite(k.result.f).any()) and \
            math.isfinite(float(k.result.cost))
        ok = rel <= COST_RTOL and all(abs(v) <= 1 for v in d_iter) \
            and same and finite
        log(f"  seed={seed}: plain cost={float(p.result.cost):.7f} "
            f"rel_diff={rel:.3e} stage_iters kernel={k.stage_iters} "
            f"plain={p.stage_iters} repeat_identical={same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"solve seed={seed}")
    geom = problems[0].geometry
    n, m = geom.shape
    a = torch.full((n,), 1.0 / n, device=geom.device)
    b = torch.full((m,), 1.0 / m, device=geom.device)
    terms = {}
    for label, g_, w1, w2 in (("xy", geom, a, b), ("xx", geom.xx(), a, a),
                              ("yy", geom.yy(), b, b)):
        k = sinkhorn_log_geometry(g_, w1, w2, tol=TOL)
        p = sinkhorn_log_geometry(g_, w1, w2, tol=TOL, use_pallas=False)
        rel = abs(float(k.cost) - float(p.cost)) / abs(float(p.cost))
        ok = rel <= COST_RTOL and abs(k.n_iter - p.n_iter) <= 1
        terms[label] = (float(k.cost), float(p.cost))
        log(f"  divergence term {label}: kernel cost={float(k.cost):.7f} "
            f"n_iter={k.n_iter}  plain cost={float(p.cost):.7f} "
            f"n_iter={p.n_iter}  rel_diff={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"divergence term {label}")
    w_k = terms["xy"][0] - 0.5 * (terms["xx"][0] + terms["yy"][0])
    w_p = terms["xy"][1] - 0.5 * (terms["xx"][1] + terms["yy"][1])
    scale = max(abs(v) for pair in terms.values() for v in pair)
    ok = abs(float(div) - w_k) <= 1e-6 * scale and \
        abs(w_k - w_p) <= COST_RTOL * scale
    log(f"  divergence: entry point {float(div):.7f}, kernel terms {w_k:.7f},"
        f" plain terms {w_p:.7f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("divergence")
    return failures


# ---------------------------------------------------------------------------
# Phase 5: the training path
# ---------------------------------------------------------------------------


def counts_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def run_trainer(torch, device="cuda"):
    """The OT-GAN trainer's own entry point at its default configuration
    (8-mode ring, batch 256, r = 128, eps 0.5, 40 iterations, n_c = 3),
    ``--strict``."""
    from repro_torch.examples import ot_gan
    return ot_gan.main(["--steps", str(GAN_STEPS), "--device", str(device),
                        "--strict"])


def trainer_step0(torch, device):
    """The strict run's first step: its initial weights and its first data
    and z, drawn as ``ot_gan.main`` draws them (weights from a CPU generator
    seeded 0, data then z from a device generator seeded 1)."""
    from repro_torch.examples import ot_gan
    model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator(device=device).manual_seed(1)
    data = ot_gan.make_data(gen, GAN_BATCH)
    z = torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen, device=device)
    return model, z, data


def step_summary(out):
    """Median ms of adversary and generator steps after the first cycle."""
    adv = [t for t, a in zip(out["step_ms"][4:], out["adv"][4:]) if a]
    gen = [t for t, a in zip(out["step_ms"][4:], out["adv"][4:]) if not a]
    return statistics.median(adv), statistics.median(gen)


def profile_train_steps(torch, device):
    """Busy share of one adversary step and one generator step at the
    default configuration under torch.profiler, with the kernel device time
    by name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan

    model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator(device=device).manual_seed(1)
    obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                      policy=ExecutionPolicy.training())
    batches = [(ot_gan.make_data(gen, GAN_BATCH),
                torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen,
                            device=device)) for _ in range(3)]
    ot_gan.train_step(model, batches[0][1], batches[0][0], obj, adv=True)
    torch.cuda.synchronize()
    for (data, z), adv in zip(batches[1:], (True, False)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            d, _ = ot_gan.train_step(model, z, data, obj, adv=adv)
            float(d)
            wall = time.perf_counter() - t0
        rows = kernel_rows(torch, prof)
        dev_us = sum(e.self_device_time_total for e in rows)
        kind = "adversary" if adv else "generator"
        if dev_us <= 0:
            log(f"  profiled {kind} step: wall {wall * 1e3:.3f} ms; busy share"
                " not measured (the profiler saw no device time)")
            continue
        log(f"  profiled {kind} step: wall {wall * 1e3:.3f} ms, device "
            f"kernel time {dev_us / 1e3:.3f} ms, busy share "
            f"{dev_us / 1e3 / (wall * 1e3):.3f} under the profiler")
        top = sorted(rows, key=lambda e: -e.self_device_time_total)
        log(f"    {len(rows)} kernels by name, {sum(e.count for e in rows)} "
            "launches")
        for e in top[:6]:
            log(f"    {e.key[:60]:60s} {e.count:6d} calls "
                f"{e.self_device_time_total / 1e3:9.3f} ms")


def compare_step_plans(torch, device, steps=8):
    """ms per trainer step at the default configuration with the auto
    cadence (the megakernel, 8 iterations a launch) against the streaming
    per-iteration plan (inner_steps=1) on the same data, in the order
    auto, streaming, streaming, auto, each from fresh weights."""
    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan

    gen = torch.Generator(device=device).manual_seed(2)
    batches = [(ot_gan.make_data(gen, GAN_BATCH),
                torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen,
                            device=device)) for _ in range(steps)]
    out = {}
    for label in ("megakernel", "streaming", "streaming", "megakernel"):
        policy = ExecutionPolicy.training(
            inner_steps=None if label == "megakernel" else 1)
        obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40, policy=policy)
        model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                                  device)
        ot_gan.train_step(model, batches[0][1], batches[0][0], obj, adv=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, (data, z) in enumerate(batches):
            d, _ = ot_gan.train_step(model, z, data, obj, adv=k % 4 != 3)
        float(d)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        out.setdefault(label, []).append(ms)
        log(f"  {label:10s} plan: {ms:.3f} ms per trainer step (mean of "
            f"{steps}, 3 adversary : 1 generator)")
    return out


def gan_gradient(torch, device, *, batch, r, eps, iters, use_pallas, seed=0):
    """bench_gan's training-step gradient: Wbar of the Gaussian geometry of
    a generator output against data (d = 8, N(0, 1)/2 against
    (N(0, 1) + 0.5)/2, R = 3) and learnable anchors, under the training
    policy, with its gradients in the generator output and the anchors."""
    from repro_torch.core import (
        ExecutionPolicy,
        GaussianFeatureMap,
        OTObjective,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    gen = (0.5 * torch.randn((batch, D), generator=g, device=device))
    dat = 0.5 * (torch.randn((batch, D), generator=g, device=device) + 0.5)
    anchors = GaussianFeatureMap(r=r, d=D, eps=eps, R=3.0).init(g)
    gen.requires_grad_(True)
    anchors.requires_grad_(True)
    obj = OTObjective(eps=eps, tol=0.0, max_iter=iters,
                      policy=ExecutionPolicy.training(use_pallas=use_pallas))

    def once():
        geom = obj.gaussian(gen, dat, anchors, R=3.0)
        w = obj.divergence(geom)
        gg, ga = torch.autograd.grad(w, [gen, anchors])
        return w.detach(), gg, ga

    return once


def grads_agree(pairs, rel=GRAD_REL_TOL):
    """Max abs difference of each gradient pair over its max |grad|."""
    worst = 0.0
    for got, want in pairs:
        scale = float(want.abs().max())
        worst = max(worst, float((got - want).abs().max()) / scale)
    return worst, worst <= rel


def run_training_path(torch, np, device):
    """Phase 5: the trainer's --strict run, its profile, the batch-2048
    gradient, and the comparison of both with use_pallas=False. Returns
    (launch counts of the counted runs, failures)."""
    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    failures = []
    reset_launch_counts()
    t0 = time.perf_counter()
    out_k = run_trainer(torch, device=device)
    wall = time.perf_counter() - t0
    counts_train = launch_counts()
    adv_ms, gen_ms = step_summary(out_k)
    per_step = 3 * math.ceil(40 / 8)
    log(f"  trainer --strict: {GAN_STEPS} steps in {wall:.3f} s; median "
        f"{adv_ms:.3f} ms per adversary step, {gen_ms:.3f} ms per generator "
        f"step; Wbar {out_k['divergences'][0]:.5f} -> "
        f"{out_k['divergences'][-1]:.5f}; launches {counts_train} "
        f"({counts_train['log_sinkhorn_block'] / GAN_STEPS:.1f} megakernel "
        f"launches a step, expected {per_step})")
    if counts_train["log_sinkhorn_block"] != per_step * GAN_STEPS:
        failures.append("trainer megakernel launches")

    once = gan_gradient(torch, device, batch=GAN_BIG_BATCH, r=128, eps=2.0,
                        iters=30, use_pallas=None)
    before = launch_counts()
    w_k, gg_k, ga_k = once()
    torch.cuda.synchronize()
    delta = counts_delta(before, launch_counts())
    counts = launch_counts()
    log(f"  batch {GAN_BIG_BATCH} gradient (d={D}, r=128, eps=2, 30 "
        f"iterations): Wbar {float(w_k):.7f}, launches {delta}")
    if delta["log_sinkhorn_block"] != 0 or delta["log_halfstep"] <= 0 \
            or delta["log_feature_contract"] <= 0:
        failures.append("batch-2048 gradient did not take the streaming plan")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  batch {GAN_BIG_BATCH} gradient: median {statistics.median(times):.3f}"
        f" ms over 5 (value and both gradients)")

    log("  -- the same with use_pallas=False (the plain torch operators), "
        "from the same weights: a second trainer run would update its own "
        "weights, and 60 adversarial steps amplify last-bit differences")
    first, z, data = trainer_step0(torch, device)
    for label, model in (("step-0", first),
                         (f"trained {GAN_STEPS} steps", out_k["model"])):
        res = {}
        for plain in (False, True):
            obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                              policy=ExecutionPolicy.training(
                                  use_pallas=False if plain else None))
            d, _ = ot_gan.gan_losses(model, z, data, obj)
            res[plain] = (d.detach(),
                          torch.autograd.grad(d, list(model.parameters())))
        w_rel = abs(float(res[False][0]) - float(res[True][0])) / \
            abs(float(res[True][0]))
        g_rel, g_ok = grads_agree(zip(res[False][1], res[True][1]))
        ok = w_rel <= COST_RTOL and g_ok
        if model is first:
            # the strict run's own step-0 Wbar against the plain operators
            w0 = out_k["divergences"][0]
            run_rel = abs(w0 - float(res[True][0])) / abs(float(res[True][0]))
            ok = ok and run_rel <= COST_RTOL
            log(f"  trainer --strict step-0 Wbar {w0:.7f}, plain rel diff "
                f"{run_rel:.3e}")
        log(f"  trainer gradient, {label} weights (all parameters): Wbar "
            f"{float(res[False][0]):.7f} rel diff {w_rel:.3e}, gradients max "
            f"diff / max |grad| {g_rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trainer gradient ({label}) against "
                            "use_pallas=False")

    once_p = gan_gradient(torch, device, batch=GAN_BIG_BATCH, r=128, eps=2.0,
                          iters=30, use_pallas=False)
    w_p, gg_p, ga_p = once_p()
    w_rel = abs(float(w_k) - float(w_p)) / abs(float(w_p))
    g_rel, g_ok = grads_agree([(gg_k, gg_p), (ga_k, ga_p)])
    ok = w_rel <= COST_RTOL and g_ok
    log(f"  batch {GAN_BIG_BATCH} gradient plain: Wbar {float(w_p):.7f} rel "
        f"diff {w_rel:.3e}, gradients max diff / max |grad| {g_rel:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("batch-2048 gradient against use_pallas=False")
    profile_train_steps(torch, device)
    compare_step_plans(torch, device)
    return counts, failures


# ---------------------------------------------------------------------------
# Phase 6: the scaling path
# ---------------------------------------------------------------------------


def scaling_inputs(torch, np, device):
    """Phase 6's requests, built before the counted run: the explicit
    feature problems (r = 1024 and 256), the clouds of phase 4 at eps 1.0,
    the OT-GAN-batch geometry and the divergence's leaves."""
    from repro_torch.core import FactoredPositive, OTProblem
    feats = {r: OTProblem.from_features(explicit_features(np, N, r, 2 * r),
                                        explicit_features(np, M, r, 2 * r + 1),
                                        eps=SCALING_EPS)
             for r in (R_ANCHORS, 256)}
    clouds_ = []
    for seed in SEEDS:
        prob = build_problem(torch, np, seed, device)
        clouds_.append(OTProblem(prob.geometry.rebuild_at(1.0), prob.a,
                                 prob.b))
    gan = FactoredPositive(
        xi=torch.as_tensor(explicit_features(np, GAN_BATCH, 128, 5),
                           device=device),
        zeta=torch.as_tensor(explicit_features(np, GAN_BATCH, 128, 6),
                             device=device),
        eps=SCALING_EPS)
    n_div, r_div = 4096, 256
    leaves = [torch.as_tensor(explicit_features(np, n_div, r_div, s),
                              device=device) for s in (8, 9)]
    leaves += [torch.full((n_div,), 1.0 / n_div, device=device)
               for _ in range(2)]
    return feats, clouds_, gan, leaves


def scaling_objective(policy_kw=None):
    from repro_torch.core import ExecutionPolicy, OTObjective
    return OTObjective(eps=SCALING_EPS, tol=0.0, max_iter=40,
                       policy=ExecutionPolicy.training(**(policy_kw or {})))


def scaling_divergence(torch, leaves):
    """The scaling divergence and its gradients in all four tensors."""
    from repro_torch.core import sinkhorn_divergence_features
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    w = sinkhorn_divergence_features(*leaves, eps=SCALING_EPS, tol=0.0,
                                     max_iter=SCALING_ITERS)
    return w.detach(), torch.autograd.grad(w, leaves)


def run_scaling_path(torch, np, device):
    """The counted run of phase 6: four feature solves, three cloud solves,
    one objective solve and one divergence with its gradient, with the
    launch counters set to 0 just before and read just after."""
    from repro_torch.core import solve
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import observe_plan_selection

    feats, clouds_, gan, leaves = scaling_inputs(torch, np, device)
    torch.cuda.synchronize()
    out = {"feats": {}, "clouds": []}
    failures = []
    reset_launch_counts()
    for r, prob in feats.items():
        for precision in ("highest", "bf16"):
            before = launch_counts()
            with observe_plan_selection() as events:
                t0 = time.perf_counter()
                res = solve(prob, tol=0.0, max_iter=SCALING_ITERS,
                            precision=precision)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            modes = [(e["mode"], e["kind"]) for e in events]
            if modes != [("scaling", "factored")]:
                failures.append(f"auto method on features r={r}: {modes}")
            out["feats"][(r, precision)] = res
            log(f"  features n=m={N} r={r} {precision}: cost="
                f"{float(res.cost):.7f} n_iter={res.n_iter} wall={wall:.4f} s"
                f" ({wall / res.n_iter * 1e3:.4f} ms/iteration) plan={modes}"
                f" launches={counts_delta(before, launch_counts())}")
    for seed, prob in zip(SEEDS, clouds_):
        before = launch_counts()
        t0 = time.perf_counter()
        res = solve(prob, method="factored", tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["clouds"].append(res)
        dead_rows = sum(int((w.sum(1) == 0).sum()) for w in
                        prob.geometry.features())
        log(f"  clouds seed={seed} eps=1.0 method=factored: cost="
            f"{float(res.cost):.7f} n_iter={res.n_iter} marginal_err="
            f"{float(res.marginal_err):.3e} wall={wall:.4f} s; feature rows "
            f"that underflow to 0: {dead_rows}; launches="
            f"{counts_delta(before, launch_counts())}")
    before = launch_counts()
    obj = scaling_objective()
    t0 = time.perf_counter()
    out["gan"] = obj.solve(gan, *obj.uniform_weights(gan))
    torch.cuda.synchronize()
    delta = counts_delta(before, launch_counts())
    log(f"  OTObjective.solve n=m={GAN_BATCH} r=128 bf16 40 iterations: cost="
        f"{float(out['gan'].cost):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"launches={delta}")
    if delta["sinkhorn_block"] != 40 // 8:
        failures.append("objective solve did not take the megakernel 5 times")
    before = launch_counts()
    t0 = time.perf_counter()
    out["div"] = scaling_divergence(torch, leaves)
    torch.cuda.synchronize()
    log(f"  scaling divergence n=m=4096 r=256: value "
        f"{float(out['div'][0]):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"(value and 4 gradients) "
        f"launches={counts_delta(before, launch_counts())}")
    counts = launch_counts()
    missing = [k for k in SCALING_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return (feats, clouds_, gan, leaves), out, counts, failures


def compare_scaling_path(torch, inputs, out):
    """Each request of the counted run against use_pallas=False (and the
    clouds against method="log_factored", the divergence against the CPU);
    a profile of one feature solve; the objective's megakernel plan against
    its streaming plan."""
    from repro_torch.core import rot_factored, solve

    feats, clouds_, gan, leaves = inputs
    failures = []

    def check(label, ok):
        log(f"  {label} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label.split(":")[0])

    for (r, precision), res in out["feats"].items():
        p = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                  precision=precision, use_pallas=False)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        eu, oku = compare(torch, res.u, p.u, rel_to_max=COST_RTOL)
        ev, okv = compare(torch, res.v, p.v, rel_to_max=COST_RTOL)
        check(f"features r={r} {precision}: plain cost={float(p.cost):.7f} "
              f"rel_diff={rel:.3e} u err={eu:.3e} v err={ev:.3e} n_iter "
              f"{res.n_iter}/{p.n_iter}",
              rel <= COST_RTOL and oku and okv and res.n_iter == p.n_iter)
    prob = feats[R_ANCHORS]
    profile_call(torch, f"feature solve r={R_ANCHORS} f32",
                 lambda: solve(prob, tol=0.0, max_iter=SCALING_ITERS))
    for seed, prob, res in zip(SEEDS, clouds_, out["clouds"]):
        p = solve(prob, method="factored", tol=TOL, use_pallas=False)
        lg = solve(prob, method="log_factored", tol=TOL)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        rel_log = abs(float(res.cost) - float(lg.cost)) / abs(float(lg.cost))
        check(f"clouds seed={seed}: plain cost={float(p.cost):.7f} n_iter="
              f"{p.n_iter} rel_diff={rel:.3e}; log_factored cost="
              f"{float(lg.cost):.7f} n_iter={lg.n_iter} rel_diff="
              f"{rel_log:.3e}",
              rel <= COST_RTOL and abs(res.n_iter - p.n_iter) <= 1
              and rel_log <= COST_RTOL)
    obj = scaling_objective({"use_pallas": False})
    p = obj.solve(gan, *obj.uniform_weights(gan))
    rel = abs(float(out["gan"].cost) - float(p.cost)) / abs(float(p.cost))
    check(f"objective solve: plain cost={float(p.cost):.7f} rel_diff="
          f"{rel:.3e}", rel <= COST_RTOL)
    cpu = [x.cpu() for x in leaves]
    w_c, g_c = scaling_divergence(torch, cpu)
    w_k, g_k = out["div"]
    # W̄ of two samples of one distribution is far smaller than its three
    # terms, so it is held, as phase 4 holds its divergence, relative to
    # the largest term
    xs, zs, a_, b_ = cpu
    terms = [float(rot_factored(p_, q_, w1, w2, SCALING_EPS, 0.0,
                                SCALING_ITERS))
             for p_, q_, w1, w2 in ((xs, zs, a_, b_), (xs, xs, a_, a_),
                                    (zs, zs, b_, b_))]
    scale = max(abs(v) for v in terms)
    w_rel = abs(float(w_k) - float(w_c)) / scale
    g_rel, g_ok = grads_agree(zip((g.cpu() for g in g_k), g_c))
    check(f"scaling divergence: CPU value {float(w_c):.9f} (terms "
          f"{terms[0]:.7f}, {terms[1]:.7f}, {terms[2]:.7f}), diff / largest "
          f"term {w_rel:.3e}, gradients max diff / max |grad| {g_rel:.3e}",
          w_rel <= COST_RTOL and g_ok)
    compare_objective_plans(torch, gan)
    return failures


def compare_objective_plans(torch, gan, solves=10):
    """ms per OTObjective.solve at the OT-GAN batch with the auto cadence
    (the scaling megakernel, 8 iterations a launch) against the streaming
    plan (inner_steps=1), in the order megakernel, streaming, streaming,
    megakernel."""
    for label in ("megakernel", "streaming", "streaming", "megakernel"):
        obj = scaling_objective(
            {"inner_steps": None if label == "megakernel" else 1})
        a, b = obj.uniform_weights(gan)
        obj.solve(gan, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(solves):
            res = obj.solve(gan, a, b)
        float(res.cost)
        ms = (time.perf_counter() - t0) * 1e3 / solves
        log(f"  {label:10s} plan: {ms:.4f} ms per objective solve (mean of "
            f"{solves})")


# ---------------------------------------------------------------------------
# Phase 7: the streaming path
# ---------------------------------------------------------------------------


def stream_points(np, rng, k, side):
    """k points of one side's cloud: bench_stream's 0.5 N(0, I_2), shifted
    by 0.3 on the y side."""
    pts = 0.5 * rng.standard_normal((k, STREAM_D))
    return (pts + (STREAM_SHIFT if side == "y" else 0.0)).astype(np.float32)


def stream_mutation(np, rng, live_ids, side, tag):
    """Evict STREAM_DELTA random ids of ``live_ids`` (one side) and insert
    as many new points of that side's cloud. The evicted ids leave
    ``live_ids``; the new ones are returned for the caller to add once
    they are in the store (a flush applies every eviction of its batch
    before any insertion)."""
    drop = rng.choice(len(live_ids), STREAM_DELTA, replace=False)
    gone = [live_ids[i] for i in drop]
    keep = np.ones(len(live_ids), bool)
    keep[drop] = False
    live_ids[:] = [i for i, k in zip(live_ids, keep) if k]
    new = [(side, tag, i) for i in range(STREAM_DELTA)]
    return gone, dict(ids=new, points=stream_points(np, rng, STREAM_DELTA,
                                                    side),
                      weights=np.ones(STREAM_DELTA, np.float32))


def stream_state(np, pair, saved):
    """What a solve started from, on the host: each side's feature buffer,
    weights, live mask and page table, and the start potentials as
    ``StreamingSolver._solve`` prepares them (no bucket is crossed here;
    ``saved`` is None for a cold solve)."""
    from repro_torch.streaming.solver import _prep_init
    state = {}
    for side, pot in zip(("x", "y"), saved):
        st = getattr(pair, side).store
        live = st.live_mask()
        state[side] = dict(feats=st._feats.copy(), weights=st.weights_host(),
                           live=live, page_live=st.page_live,
                           f0=_prep_init(pot, live, None, st.capacity)[0])
    return state


def drive_stream(torch, np, device, method, precision, seed):
    """One run of phase 7's traffic through the entry points a user calls:
    two ``from_points`` stores of N live points (capacity 32768: half the
    pages dead; the bf16 run reads bf16 device buffers) behind a
    StreamingOTService (max_batch 4), warmup, a cold solve, 8 submitted
    mutations drained as 2 coalesced warm re-solves, then 2 direct
    StreamingSolver.update calls. Each solve's result, wall (mutation,
    flush and re-solve, ending in a synchronise) and start state are kept
    for the comparisons, which run after the counted traffic."""
    from repro_torch.core import GaussianFeatureMap
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ops import observe_plan_selection
    from repro_torch.serving import StreamingOTService
    from repro_torch.streaming import StreamingDistribution, StreamingSolver

    rng = np.random.default_rng(seed)
    live_ids = {side: [(side, i) for i in range(N)] for side in "xy"}
    pts = {side: stream_points(np, rng, N, side) for side in "xy"}
    R = float(np.max(np.linalg.norm(np.concatenate(list(pts.values())),
                                    axis=1)))
    fm = GaussianFeatureMap(r=R_ANCHORS, d=STREAM_D, eps=STREAM_EPS, R=R)
    anchors = (math.sqrt(fm.sigma2) * rng.standard_normal(
        (R_ANCHORS, STREAM_D))).astype(np.float32)
    sides = [StreamingDistribution.from_points(
        live_ids[side], pts[side], np.ones(N, np.float32), anchors,
        eps=STREAM_EPS, q=fm.q, page_size=STREAM_PAGE) for side in "xy"]
    solver = StreamingSolver(method=method, tol=TOL, precision=precision)
    svc = StreamingOTService(solver=solver, max_batch=4, max_wait=1.0,
                             clock=lambda: 0.0)
    records, mark, label = [], [0.0], ["coalesced flush"]
    real_re_solve = solver.re_solve

    def recorded(pair_):
        saved = (pair_.f, pair_.g)
        res = real_re_solve(pair_)
        torch.cuda.synchronize()
        wall = time.perf_counter() - mark[0]
        records.append(dict(label=label[0], res=res, wall=wall,
                            state=stream_state(np, pair_, saved)))
        mark[0] = time.perf_counter()
        return res

    before = launch_counts()
    with observe_plan_selection() as events:
        t0 = time.perf_counter()
        pair = svc.register("stream", *sides)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        state = stream_state(np, pair, (None, None))
        t0 = time.perf_counter()
        res = solver.cold_solve(pair)
        torch.cuda.synchronize()
        records.append(dict(label="cold solve", res=res, state=state,
                            wall=time.perf_counter() - t0))
        solver.re_solve = recorded
        batch = []
        for k in range(STREAM_MUTATIONS):
            if k % svc.queue.max_batch == 0:    # the previous flush's inserts
                for _, add in batch:
                    live_ids[add["ids"][0][0]] += add["ids"]
                batch = []
            gx, ax = stream_mutation(np, rng, live_ids["x"], "x", k)
            gy, ay = stream_mutation(np, rng, live_ids["y"], "y", k)
            batch += [(gx, ax), (gy, ay)]
            svc.submit_update("stream", remove_x=gx, add_x=ax, remove_y=gy,
                              add_y=ay)
        for _, add in batch:
            live_ids[add["ids"][0][0]] += add["ids"]
        mark[0] = time.perf_counter()
        resolved = svc.pump() + svc.drain()
        label[0] = "direct update"
        for k in range(2):
            gx, ax = stream_mutation(np, rng, live_ids["x"], "x", f"u{k}")
            gy, ay = stream_mutation(np, rng, live_ids["y"], "y", f"u{k}")
            live_ids["x"] += ax["ids"]
            live_ids["y"] += ay["ids"]
            mark[0] = time.perf_counter()
            solver.update(pair, remove_x=gx, add_x=ax, remove_y=gy,
                          add_y=ay)
    solver.re_solve = real_re_solve
    delta = counts_delta(before, launch_counts())
    stats = svc.stats()
    log(f"  {method} {precision}: warmup {warmup_s:.3f} s; {resolved} "
        f"mutations in {stats['solves']} flushes (coalesce ratio "
        f"{stats['coalesce_ratio']:.1f}); pages live "
        f"{pair.x.store.stats()['live_pages']}/{pair.x.store.n_pages}; "
        f"launches {delta}")
    return dict(method=method, precision=precision, solver=solver,
                pair=pair, records=records, delta=delta,
                events=[(e["mode"], e["kind"]) for e in events],
                resolved=resolved, solves=stats["solves"])


def compare_stream(torch, np, device, run):
    """Each solve of a run against the same solver with use_pallas=False
    from the same start state (cost 1e-4 relative, |d n_iter| <= 1, f and g
    on live slots within 1e-4 of max |f| or |g|) and against a cold
    ``solve(method="factored")`` on the compact live support, built from
    host arrays as a caller without the streaming layer would (cost 1e-4
    relative; its wall is the cold pipeline's). Then the path checks and
    a profile of one more update."""
    from repro_torch.core import OTProblem, solve
    from repro_torch.streaming.solver import run_paged

    method, precision = run["method"], run["precision"]
    failures = []
    solver, pair = run["solver"], run["pair"]
    warm_iters = cold_iters = 0
    for rec in run["records"]:
        st, res = rec["state"], rec["res"]
        # the plain operators on the same host state; a bf16 run's float32
        # rows round to the bf16 values its stores hold
        p = run_paged(*(torch.as_tensor(st[s]["feats"], device=device)
                        for s in "xy"),
                      st["x"]["page_live"], st["y"]["page_live"],
                      st["x"]["weights"], st["y"]["weights"],
                      st["x"]["f0"], st["y"]["f0"], page_size=STREAM_PAGE,
                      eps=STREAM_EPS, method=method, tol=TOL,
                      max_iter=solver.max_iter, momentum=solver.momentum,
                      use_pallas=False, precision=precision)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        pot_ok, pot_err = True, 0.0
        for side, got, want in (("x", res.f, p.f), ("y", res.g, p.g)):
            live = torch.as_tensor(st[side]["live"], device=device)
            err, ok = compare(torch, got[live], want[live],
                              rel_to_max=COST_RTOL)
            pot_ok, pot_err = pot_ok and ok, max(pot_err, err)
        xi_c, zeta_c = (st[s]["feats"][st[s]["live"]] for s in "xy")
        a_c, b_c = (st[s]["weights"][st[s]["live"]] for s in "xy")
        t0 = time.perf_counter()
        prob = OTProblem.from_features(xi_c, zeta_c, a_c / a_c.sum(),
                                       b_c / b_c.sum(), eps=STREAM_EPS)
        cold = solve(prob, method="factored", tol=TOL, precision=precision)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        rel_cold = abs(float(res.cost) - float(cold.cost)) / \
            abs(float(cold.cost))
        ok = (rel <= COST_RTOL and abs(res.n_iter - p.n_iter) <= 1
              and pot_ok and rel_cold <= COST_RTOL
              and math.isfinite(float(res.cost)))
        if rec["label"] != "cold solve":
            warm_iters += res.n_iter
            cold_iters += cold.n_iter
        log(f"  {method} {precision} {rec['label']:15s}: n_iter {res.n_iter}"
            f" (plain {p.n_iter}, cold compact {cold.n_iter}) cost "
            f"{float(res.cost):.7f} rel diff plain {rel:.3e} cold "
            f"{rel_cold:.3e}, potentials err {pot_err:.3e}; wall "
            f"{rec['wall'] * 1e3:.3f} ms ({rec['wall'] * 1e3 / res.n_iter:.4f}"
            f" ms/iteration), cold pipeline {cold_s * 1e3:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{method} {precision} {rec['label']}")
    d = run["delta"]
    paged = ("paged_feature_contract", "paged_halfstep",
             "paged_feature_matvec")
    flat = ("feature_contract", "sinkhorn_halfstep", "feature_matvec",
            "sinkhorn_block")
    if method == "scaling":
        path_ok = all(d[k] > 0 for k in paged) and all(d[k] == 0
                                                       for k in flat)
    else:
        path_ok = d["log_feature_contract"] > 0 and d["log_halfstep"] > 0
    path_ok = (path_ok and set(run["events"]) == {(method, "paged")}
               and run["resolved"] == STREAM_MUTATIONS and run["solves"] == 2)
    log(f"  {method} {precision} path: plan events {set(run['events'])} "
        f"{'ok' if path_ok else 'FAIL'}")
    if not path_ok:
        failures.append(f"{method} {precision} path")
    # the warm start must save iterations over the run: a re-solve that
    # lost its saved potentials would take the cold solve's count
    warm_ok = warm_iters < cold_iters
    log(f"  {method} {precision} warm start: {warm_iters} iterations over "
        f"the {len(run['records']) - 1} warm re-solves against {cold_iters} "
        f"for cold compact solves of the same states "
        f"{'ok' if warm_ok else 'FAIL'}")
    if not warm_ok:
        failures.append(f"{method} {precision} warm start")
    rng = np.random.default_rng(99)
    live_ids = {s: list(getattr(pair, s).store.ids()) for s in "xy"}
    # one more update, step by step: where the wall of an update goes
    muts = [stream_mutation(np, rng, live_ids[s], s, "split") for s in "xy"]
    t0 = time.perf_counter()
    for side, (gone, add) in zip("xy", muts):
        getattr(pair, side).remove(gone)
        getattr(pair, side).add(**add)
    t1 = time.perf_counter()
    dirty = len(pair.x.store._dirty) + len(pair.y.store._dirty)
    pair.x.device_features(solver.storage_dtype)
    pair.y.device_features(solver.storage_dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = solver.re_solve(pair)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"  {method} {precision} update split: evictions and inserts "
        f"(host bookkeeping) {(t1 - t0) * 1e3:.3f} ms, flush of {dirty} "
        f"dirty pages {(t2 - t1) * 1e3:.3f} ms, re-solve ({res.n_iter} "
        f"iterations) {(t3 - t2) * 1e3:.3f} ms")
    gx, ax = stream_mutation(np, rng, live_ids["x"], "x", "profiled")
    gy, ay = stream_mutation(np, rng, live_ids["y"], "y", "profiled")
    profile_call(torch, f"streaming update {method} {precision}",
                 lambda: solver.update(pair, remove_x=gx, add_x=ax,
                                       remove_y=gy, add_y=ay))
    return failures


def run_streaming_path(torch, np, device):
    """The counted run of phase 7: three runs of the streaming traffic
    (scaling f32, scaling bf16, log f32) with the launch counters set to 0
    just before and read just after; the comparisons follow."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    runs = [drive_stream(torch, np, device, method, precision, 70 + k)
            for k, (method, precision) in enumerate(STREAM_RUNS)]
    counts = launch_counts()
    failures = []
    for run in runs:
        failures += compare_stream(torch, np, device, run)
    return counts, failures


# ---------------------------------------------------------------------------


SCALING_PATH_KERNELS = ("feature_contract", "sinkhorn_halfstep",
                        "feature_matvec", "sinkhorn_block")
TRAIN_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep", "log_sinkhorn_block")
SOLVE_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep")
STREAM_PATH_KERNELS = ("paged_feature_contract", "paged_halfstep",
                       "paged_feature_matvec", "log_feature_contract",
                       "log_halfstep")


ALL_PHASES = (1, 2, 3, 4, 5, 6, 7)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (default: all; the "
                    "result lines need all seven)")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src directory whose repro_torch to drive "
                    "(default: this checkout's; another checkout's, to time "
                    "two versions with one script)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    src = args.src.resolve()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on the card only",
              file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}/repro_torch;"
              " run this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core import EpsSchedule
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip() if smi.returncode == 0 else
        f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; repro_torch from {src}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        report = Path(str(path) + ".log")
        if report.is_file():
            for line in report.read_text().splitlines():
                if "Function properties for" in line:
                    log(f"  {name}: {demangle(line.split('for', 1)[1])}")
                elif "registers" in line or "spill" in line:
                    log(f"  {name}:   {line.strip()}")

    errs = {}
    if 2 in phases:
        log("== phase 2: kernels against their plain versions")
        shapes = [(N, R_ANCHORS, D, EPS, False), (1001, 3, 5, 0.5, True),
                  (777, 1000, 3, 0.1, True), (33, 70, 20, 1.0, False),
                  (GAN_BIG_BATCH, 128, D, 0.5, False),
                  (1001, 1001, 64, 0.5, True),      # wide kernel, r % 4 = 1
                  (3001, 70, 130, 2.0, False),      # d past every budget
                  (4097, 70, 16, 1.0, True),        # ragged row tile
                  (2_200_000, 3, 5, 0.5, False)]    # past the old n limit
        lse_shapes = [(N, M, R_ANCHORS, 1, False), (1001, 777, 3, 1, True),
                      (1001, 777, 1000, 3, True), (777, 1001, 1000, 1, False),
                      (1001, 777, 1000, 1, True), (5, 3, 129, 3, True),
                      (5, 3, 128, 1, True)]
        bf16_shapes = [(GAN_BIG_BATCH, GAN_BIG_BATCH, 128, 1, False),
                       (GAN_BIG_BATCH, 1001, 128, 1, True),
                       (1001, 777, 100, 1, True), (1001, 777, 1000, 3, True),
                       (1001, 777, 1032, 1, True),        # contract vectors
                       (5, 3, 129, 1, True)]
        bf, f32 = torch.bfloat16, torch.float32
        block_shapes = [
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, 0, 8),
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.3, 5, 8),
            (GAN_BATCH, GAN_BATCH, 128, f32, 1.0, 0, 8),   # not admitted
            (176, 176, 128, f32, 1.0, 3, 8),
            (176, 160, 128, f32, 1.3, 0, 3),
            (200, 120, 100, bf, 1.3, 4, 8),
            (37, 53, 13, f32, 1.0, 2, 8),
            (37, 53, 13, bf, 1.3, 2, 5),
            (20, 24, 1100, bf, 1.0, 1, 8),                  # r > 1024 threads
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
        ]
        scaling_shapes = [
            (shape + (dtype,)) for dtype in (f32, bf) for shape in (
                (N, R_ANCHORS, 1), (N, 256, 1), (GAN_BIG_BATCH, 128, 1),
                (1001, 3, 1), (777, 1000, 3), (5, 129, 1), (1001, 1032, 1),
                (300, 40, 11))]                  # B > 8: two column chunks
        scaling_shapes += [                      # row groups: contract only
            (n, r, 1, dtype, "contract") for n in (1001, N)
            for dtype, rs in ((f32, (4, 12, 128, 256)), (bf, (8, 128, 256)))
            for r in rs if (n, r) != (N, 256)]
        scaling_shapes += [                      # the row kernel: rows only
            (n, r, B, dtype, "rows") for dtype in (f32, bf)
            for r in (40, 256, 512, 1024, 4096) for B in (1, 3)
            for n in (1003, 16) if (n, B) != (16, 3)]   # 1003: R does not divide n
        scaling_shapes += [(n, 1024, 1, dtype, "rows") for dtype in (f32, bf)
                           for n in (2, 7)]
        scaling_block_shapes = [
            (GAN_BATCH, GAN_BATCH, 128, bf, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 5)] + [
            (176, 176, 128, f32, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 3)] + [
            (37, 53, 13, f32, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 2)] + [
            (20, 24, 1100, bf, 1.3, 1, 8),                  # r > 1024 threads
            (GAN_BATCH, GAN_BATCH, 128, f32, 1.0, 0, 8),    # not admitted
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
        ]
        errs, failures = check_kernels(torch, np, device, shapes, lse_shapes,
                                       bf16_shapes, block_shapes,
                                       scaling_shapes, scaling_block_shapes)
        if failures:
            log(f"phase 2 FAILED: {failures}")
            return 1

    times = {}
    if 3 in phases:
        log("== phase 3: times at the main path's shape "
            f"(n={N}, r={R_ANCHORS}, d={D}, B=1) and the training path's")
        calibrate_sleep(torch)
        log(f"  device spin ahead of each batch: {SLEEP_MS[0]:.3f} ms")
        launches_per_call(torch, np, device)
        times = time_kernels(torch, np, device)
        time_feature_map(torch, np, device)
        times.update(time_training_kernels(torch, np, device))
        times.update(time_scaling_kernels(torch, np, device))
        flat_contract_digest(torch, device)
        times.update(time_paged_kernels(torch, np, device))

    counts = {}
    if 4 in phases:
        log(f"== phase 4: main path (n=m={N}, d={D}, r={R_ANCHORS}, "
            f"eps={EPS}, tol={TOL}, EpsSchedule(eps_init=1.0, decay=0.5))")
        problems, results, div, c4 = run_main_path(torch, np, device)
        log(f"  launches on the main path: {c4}")
        counts["solve"] = c4
        missing = [k for k in SOLVE_PATH_KERNELS if c4[k] <= 0]
        if missing:
            log(f"phase 4 FAILED: kernels never launched: {missing}")
            return 1
        profile_solve(torch, problems[0],
                      EpsSchedule(eps_init=1.0, decay=0.5))
        failures = compare_main_path(torch, problems, results, div,
                                     EpsSchedule)
        if failures:
            log(f"phase 4 FAILED: {failures}")
            return 1

    if 5 in phases:
        log(f"== phase 5: training path (OT-GAN trainer, batch {GAN_BATCH}, "
            f"r=128, eps=0.5, 40 iterations, {GAN_STEPS} steps; bench_gan "
            f"gradient at batch {GAN_BIG_BATCH})")
        c5, failures = run_training_path(torch, np, device)
        log(f"  launches on the training path: {c5}")
        counts["train"] = c5
        missing = [k for k in TRAIN_PATH_KERNELS if c5[k] <= 0]
        if missing:
            failures.append(f"kernels never launched: {missing}")
        if failures:
            log(f"phase 5 FAILED: {failures}")
            return 1
    if 6 in phases:
        log(f"== phase 6: scaling path (features n=m={N}, r={R_ANCHORS} and "
            f"256, eps={SCALING_EPS}, {SCALING_ITERS} iterations; clouds at "
            f"eps=1.0, tol={TOL}; objective at batch {GAN_BATCH}; divergence "
            "at n=m=4096, r=256)")
        t6 = time.perf_counter()
        inputs, out, c6, failures = run_scaling_path(torch, np, device)
        log(f"  launches on the scaling path: {c6}")
        counts["scaling"] = c6
        failures += compare_scaling_path(torch, inputs, out)
        log(f"  phase 6: {time.perf_counter() - t6:.1f} s")
        if failures:
            log(f"phase 6 FAILED: {failures}")
            return 1
    if 7 in phases:
        log(f"== phase 7: streaming path (two stores of {N} live points, "
            f"d={STREAM_D}, capacity {STREAM_CAPACITY}, page {STREAM_PAGE}, "
            f"r={R_ANCHORS}, eps={STREAM_EPS}, tol={TOL}; "
            f"{STREAM_MUTATIONS} mutations of "
            f"{STREAM_DELTA} evictions and insertions a side, coalesced 4 to "
            "a flush, then 2 direct updates; scaling f32, scaling bf16, log "
            "f32)")
        t7 = time.perf_counter()
        c7, failures = run_streaming_path(torch, np, device)
        log(f"  launches on the streaming path: {c7}")
        counts["stream"] = c7
        missing = [k for k in STREAM_PATH_KERNELS if c7[k] <= 0]
        if missing:
            failures.append(f"kernels never launched: {missing}")
        log(f"  phase 7: {time.perf_counter() - t7:.1f} s")
        if failures:
            log(f"phase 7 FAILED: {failures}")
            return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if phases != set(ALL_PHASES):
        log(f"phases {sorted(phases)} passed; no result line without all "
            "seven")
        return 0

    kernels = []
    for name, info in KERNEL_INFO.items():
        by_path = {path: c[name] for path, c in counts.items()}
        kernels.append(dict(name=name, route="cuda", source=info["source"],
                            replaces=info["replaces"],
                            launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            max_abs_err=errs[name], **times[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
