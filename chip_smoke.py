#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11] [--src DIR]

``--src`` drives the ``repro_torch`` under another checkout's ``src`` (to
time two versions with one script, in turns, on one card).

Phases, each of which fails the run (nonzero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (``nvcc``, in
   parallel);
2. each kernel against its plain PyTorch version on the card: at the main
   paths' shapes, at ragged shapes, and on inputs with ``-inf`` rows,
   columns and constants; the LSE kernels on float32 and bf16 factors, the
   one-launch log contract also at B = 1, 3 and 8, n = 1, 7, 2048 and
   16384, with an all -inf column, run twice (bit-identical reruns); the
   log half-step on every branch of its plan (t in registers, on fewer
   lanes than a warp where a row has fewer than 32 vectors, and in shared
   memory, one round and several; B = 3 on the scalar path; unaligned
   rows; m = 1003, 16 and 1; m = 16383 and 3001, where groups take 2 to 8
   rows a batch), with an all -inf row (exactly -inf out), a
   row half -inf and a -inf entry of t, run twice (bit-identical); the
   log megakernel (one thread block cluster) in bf16 and float32, at
   momentum 1.0 and 1.3, with dead atoms and a dead anchor, with every row
   of one rank's slices dead, at n < C and m < C, at the largest admitted
   bf16 and float32 shapes, its plan's shared memory equal to the
   library's, and its refusal of shapes the plan does not admit (at the
   admission edge too); the scaling contract, half-step (with a zero-weight atom and an
   all-zero row) and matvec on float32 and bf16 factors, the contract run
   twice a shape (bit-identical reruns) on its 16-byte path with row groups
   and forced onto its scalar path, also at float32 r = 4, 12, 128, 256 and
   bf16 r = 8, 128, 256 (n = 1001 and 16384); the feature map also at the
   trainer's shape, at d = 64 and 130, r = 70 and 1001, a ragged row tile
   and n = 2,200,000; the scaling megakernel (the log one's cluster) as
   the log one, its plan's shared memory equal to the library's; the row
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
   log_matvec with -inf entries and an all -inf row; and the four
   kernels with a problem axis (flat contract, row kernel as half-step
   and matvec, log contract, log half-step) on P = 1, 3 and 32 stacked
   problems (n = 1024 and ragged n = 1001 and 1003, r = 256, 1024, 40,
   1000 with B = 3, and 37) in float32 and bf16, and in float32 at every
   shape phase 10's service sends them (P = 1, 2, 4, 8, 16 on sides of
   512, 1024 and 2048, r = 256), against their plain
   batched twins, each rerun bit-identical, each problem within the same
   tolerance of the 2-D kernel on it alone, and a problem with a NaN row
   leaving every other problem's bits unchanged. Tolerances: the
   feature map and the scaling kernels within 1e-5 of max
   |value|; the LSE kernels and the log megakernel's potentials atol 1e-4
   + rtol 1e-5 (summation order differs); the scaling megakernel's
   carries within 1e-5 of max |value|; both megakernels' block-end errors
   1e-4 relative + 1e-6, and a second launch bit-identical; the paged
   kernels within 1e-5 of max |value|, dead pages exactly 0, a second
   contract launch bit-identical; log_matvec as the LSE kernels;
3. the device kernels one call of the feature map, of the flat and
   paged contracts and of the log contract launches (profiler), then times (CUDA events, median of 21 batches of
   10 launches, queued behind a device spin so that host overhead is not
   timed) of each kernel, its plain
   version and one PyTorch library call computing the same function where
   there is one, beside the least time the card could take (bytes over
   3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger):
   at the solve path's shape, the feature map in both epilogues there and
   at the trainer's shapes (beside ``fill_`` of its output, evict-first
   stores on and off), the LSE kernels at batch 2048, r = 128 in
   bf16 and float32 (the log contract also with its 16-byte and scalar
   paths forced and slabs of 8 and 32 KiB), and the log megakernel at the
   OT-GAN shape (its cluster size, inner_steps = 1, the same 8 iterations
   through the per-iteration log kernels as its yardstick, and other
   cluster sizes, row groups and lanes forced); the scaling kernels
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
   OT-GAN shape (its cluster size, inner_steps = 1, and the same 8
   iterations through the per-iteration scaling kernels as its
   yardstick); the log half-step also at the row kernel's four cold
   shapes (n = 16384, r = 1024 and 256, float32 and bf16), and one log
   iteration in the plan's order at the solve shape; the paged kernels at
   C = 32768, r = 1024 and 256, float32 and bf16, 100%, 50% and 25% of
   pages live, each beside the flat kernel on the same buffer and a read floor of the live pages (the
   contract also its slabs alone and evict-first loads on and off, and
   one iteration of the paged plan in its order on two buffers at 50%
   live, evict-first loads on, off and as planned);
   log_matvec at (16384, 1024); the four kernels with a problem axis at
   the batched engine's shape (P = 32, n = 1024, r = 256, float32 and
   bf16, cold and warm) beside their batched twins, ``torch.bmm`` /
   ``torch.logsumexp`` and 32 launches of the 2-D kernel;
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
   profile of one more update;
8. the families path, with the counters set to 0 before and read after:
   Lemma-3 arc-cosine solves on phase 4's clouds (anchors 1.5 N(0, I), r
   = 1024, so 1025 features with zero entries, eps 0.1, tol 1e-4) through
   the log plan in float32 and bf16 and through ``method="factored"`` at
   eps 0.5 (the scaling kernels), at n = 256, r + 1 = 128 with a dead
   anchor column (the log megakernel in bf16; refused in float32, which
   takes the per-iteration kernels), at n = 2048 through ``method=
   "arccos"`` with ``rank=`` / ``key=``, and the divergence with its
   gradient in x; Nystrom (rank 1024, the clouds scaled into the unit
   ball) at eps 0.5 and 0.02; a 128 x 128 and a 64 x 64 grid at eps 0.1;
   the accelerated solver and ``log_factored`` on Gaussian features at
   eps 0.5 (n = 16384, r = 1024); the sphere barycenter example and a
   barycenter of 3 histograms on n = 4096 Gaussian-feature points. Then
   each arc-cosine solve is held against ``use_pallas=False`` (cost 1e-4
   relative, |d n_iter| <= 1, potentials within 1e-4 of max |value|),
   the n = 2048 one against the dense ``log_quadratic`` oracle at tol 1e-5
   (1e-4 relative), the divergence's gradient within 1e-3 of max |grad|;
   Nystrom's cost (eps 0.5, converged, 1e-4 relative) and ``diverged``
   flag (eps 0.02) against the CPU on the same landmarks; the 128 grid
   against the CPU and the 64 grid against the dense oracle (1e-5
   relative); the accelerated cost within 2e-3 of ``log_factored``'s; the
   example's peak under 25 degrees and the barycenter's weights >= 0
   summing to 1 within 1e-5. It prints one line a family: ms an
   iteration and a solve, one log plan iteration at r + 1 = 1025 beside
   the Gaussian one at r = 1024 (CUDA events), and the arc-cosine solve's
   busy share;
9. the batched path, with the counters set to 0 before and read after:
   ``BatchedSinkhorn.solve_stacked`` on P = 32 problems of n = m = 1024,
   r = 256 (bench_batch's accelerator shape: features U(0.05, 1), eps
   0.5, tol 1e-4) for ``factored`` and ``log_factored`` in float32 and
   bf16, ``solve_point_clouds`` on 32 ``gaussian_clouds`` pairs (1024
   points, d = 2) with r = 256 shared anchors annealed to eps 0.1 by
   ``EpsSchedule(0.8, 0.4)``, ``solve_many`` over supports 300, 700, 1024,
   1500 and 2048 (three buckets) and the quickstart, each solve twice
   (the second captures nothing). Then each lane against its own single
   solve and against the ``use_pallas=False`` engine (cost 1e-4 relative,
   |d n_iter| <= 1, a stage each for the clouds), the launches a replay
   at P = 1 and P = 32 (equal), and bench_batch's fixed 50 iterations:
   one ``solve_stacked`` against a loop of 32 single solves, and one
   iteration's device time stacked against 32 single steps;
10. the serving path, with the counters set to 0 before and read after:
   one trace of the reference's traffic generator at the card's width
   (``TrafficSpec(n_requests=400, eps=0.5, r=256, size_classes=((1024,
   1024), (2048, 1536), (512, 700)), pool_size=32, repeat_frac=0.6,
   near_frac=0.3, seed=0)``: bench_batch's r = 256 and three bucket cells,
   (1024, 1024), (2048, 2048) and (512, 1024), features U(0.05, 1.05),
   Dirichlet weights) through ``OTService(method=..., tol=1e-6,
   max_batch=16, max_wait=0.004)`` in float32, for ``log_factored`` (the
   log contract and half-step with their problem axis) and then
   ``factored`` (the flat contract and the row kernel). For each method:
   ``warmup(traffic_cells(...))``; a closed loop (a client keeping 64
   requests in flight, ``solve_many`` a window); the same closed loop
   with ``warm_starts=False`` and again under ``torch.profiler``, both
   through the same runners; the open loop (``run_open_loop``) at half
   the closed loop's rate; and bench_serve's sequential cold baseline,
   ``engine.solve_many([p])`` a request after an untimed pass. It prints
   each loop's rps, p50 / p99 and mean batch, the warm-start hits (exact
   / near / miss) and mean iterations warm and cold, the serve speedup
   (closed loop over sequential), kernel launches, loop replays and host
   reads a dispatch, the closed loop's device busy share, and the host's
   ms a request in ``kernel_data``, fingerprint, pad and upload,
   dispatch, pull and unpad, and ``classify``. Gates: every ticket
   served; every cost within 1e-4 relative of its sequential cold solve,
   exact repeats within 1e-5; without warm starts each lane's f and g
   within 1e-4 of max |value| of its sequential solve's, the same dead
   atoms, and |d n_iter| <= 1 (with warm starts the potentials are printed
   up to the constant (f + c, g - c)); exact and near hits, and mean warm
   iterations below cold for ``log_factored`` and not above cold for
   ``factored`` (a warm lane's padded atoms start at 0 as in the JAX
   package, u = 1 in scaling space, which spoils the first ``K^T u``, so
   a warm scaling start on a padded lane saves nothing there either); no capture after warmup in the service's
   runners, the engine's ``RunnerCache`` or ``RUNNERS``. Then the
   ``ot_service`` driver in-process, as the reference's CI runs it:
   ``--strict --rank 256``, ``--stream --strict`` and ``--chaos --strict
   --rank 256`` (NaN / inf feature rows, NaN weights, Gaussian features
   underflowing at eps 1e-4, injected runner faults, a poisoned warm
   entry, a skewed clock, quarantine and shedding; its gates include
   ``runner_faults`` equal to the injector's count and parity within
   1e-3 of the log-domain truth), each returning 0. A kernel build,
   launch or capture failure is never absorbed by the service, its
   ladder or the driver: it raises and fails the run.
11. (a) the autotuner (``repro_torch.kernels.autotune``) with tuning on
   and a fresh cache at ``build/tuning/tuning.json``: six keys (the flat
   contract at P = 32, n = 1024, r = 256 and at n = 16384, r = 1024, the
   row kernel, the log contract and the log half-step at n = 16384,
   r = 1024, float32, and the log megakernel at the OT-GAN shape, bf16),
   each candidate pinned and held against the plain version at its
   phase-2 tolerance on real inputs, rerun bit-identical; each key's
   static plan, winner, both times (phase 3's method) and trials; the
   memory cache dropped and every key resolved again from the file (zero
   trials, all disk hits); tuning off again: every plan static and the
   flat contract's digest the one from before. (b) the sharded solves:
   phase 4's annealed request (``solve_annealed(..., mesh=)``, auto ->
   ``sharded_log``), phase 6's feature problem (r = 1024, eps 0.5, 20
   iterations, auto -> ``sharded``) and the divergence with its
   gradients in x, y and the anchors (the first 4096 points of phase 4's
   clouds, eps 0.5), first on one process (the yardstick), then in an
   NCCL world of 1 and a gloo world of 2 ranks on card 0 (spawned; the
   kernels are built by phase 1, the ranks only load them; gloo is first
   checked to take CUDA tensors for MAX and all-gather, and where it does
   not its lane says so and stops). Gates: cost 1e-4 relative, |d
   iterations| <= 1 a stage, the feature solve's iterations equal,
   gradients 1e-3 of max |grad|, every rank's results bit-identical, each
   rank's counters showing the contract, half-step and feature-map
   kernels launched, no plain operator built in the solves and no
   megakernel launch. Per world: ms an iteration, the collectives' ms an
   iteration (the same all-reduces and host read, timed alone) and their
   share, and the world's seconds.

Phases 2 and 4-7 also drive the solve loop as the port runs it on the
card: every fused-plan solve replays its cell's captured CUDA graph
(``repro_torch.core.runners``). Phase 2 captures each kernel wrapper in a
graph (the contracts' cooperative launches, the megakernels' cluster
launches) and holds two replays bit-identical to the eager launch. Phases
4-7 print each solve's captures, replays and host reads, require the
captures to equal the distinct cells and not to grow after warmup (phase
5: the trainer's ``--strict`` zero post-warmup captures; phase 7:
``StreamingSolver.traces`` flat), and hold each solve against the same
solve through the eager host loop (one block and one host read at a time)
on the same kernels: ``n_iter`` equal and the potentials bit-identical.
Each prints the wall per iteration, solve, step or update and the busy
share through both loops; phase 4 also times K, the blocks a replay runs,
at 2, 4, 8 and 16.

The line before the last is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``. TF32 is off throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
    check_log_contract(torch, device, record)
    check_halfstep(torch, device, record)
    check_block(torch, np, device, block_shapes, record)
    check_scaling(torch, np, device, scaling_shapes, record)
    check_scaling_block(torch, device, scaling_block_shapes, record)
    check_paged(torch, np, device, record)
    check_log_matvec(torch, device, record)
    check_batched(torch, device, record)
    check_capture(torch, np, device, record)
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
    ``dead`` zero-weight atoms on each side (potentials -inf; a pair of
    row ranges kills those rows of each side), the carry (f0 = g0 = 0, t0
    = LSE_i(log_xi + f0/eps)) and, with ``dead``, one anchor whose
    constant is -inf (an all -inf factor column)."""
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
    if isinstance(dead, tuple):         # whole row ranges of each side
        (i0, i1), (j0, j1) = dead
        a[i0:i1] = 0.0
        b[j0:j1] = 0.0
    elif dead:
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
    from repro_torch.kernels import fused_loop, ref
    from repro_torch.kernels.fused_loop import (
        block_plan_fits,
        log_sinkhorn_block,
    )

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        eps = 0.5
        plan = (fused_loop._block_plan(n, m, r, dtype)
                if hasattr(fused_loop, "_block_plan") else None)
        if dead == "rank":     # every row of rank 1's slices dead
            dead = ((plan.slice(1, n), plan.slice(1, m)) if plan else
                    ((n // 8, n // 4), (m // 8, m // 4)))
        args = block_inputs(torch, np, n, m, r, D, eps, dtype, dead,
                            n + m + r, device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if plan is not None:
            lib_smem = fused_loop._lib().log_sinkhorn_block_smem_bytes(
                n, m, r, int(dtype == torch.bfloat16), plan.cluster,
                plan.threads, plan.groups, plan.lanes, plan.ldw)
            case += (f" C={plan.cluster} threads={plan.threads} "
                     f"G={plan.groups} L={plan.lanes} smem={plan.smem}")
            if lib_smem != plan.smem:
                record("log_sinkhorn_block", case + f" (library smem "
                       f"{lib_smem} != plan)", float("inf"), False)
                continue
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


def check_log_contract(torch, device, record):
    """The one-launch log contract against its plain version at B = 1, 3
    and 8, n = 1, 7, 2048 and 16384 (r = 128, and r = 1024 at n = 16384),
    float32 and bf16 factors with -inf rows, a dead anchor column (an all
    -inf output column) and, at B > 1, an all -inf column of s: atol
    LSE_ATOL + rtol LSE_RTOL, and a second launch bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_feature_contract

    cases = [(n, 128, B) for n in (1, 7, GAN_BIG_BATCH, N) for B in (1, 3, 8)]
    cases += [(N, R_ANCHORS, B) for B in (1, 3)]
    for n, r, B in cases:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=device).manual_seed(n * 17 + r + B)
            lw = (30.0 * torch.randn((n, r), generator=g, device=device)
                  - 50.0).to(dtype)
            s = 10.0 * torch.randn((n, B), generator=g, device=device)
            lw[:, r // 2] = -math.inf           # an all -inf output column
            lw[n // 3, :] = -math.inf
            s[n // 5, :] = -math.inf
            if B > 1:
                s[:, B - 1] = -math.inf         # an all -inf column of s
            got = log_feature_contract(lw, s)
            again = log_feature_contract(lw, s)
            want = ref.log_feature_contract_ref(lw, s)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            same = torch.equal(got, again)
            record("log_feature_contract",
                   f"{str(dtype)[6:]} n={n} r={r} B={B} -inf column "
                   f"repeat_identical={same}", err, ok and same)


def check_halfstep(torch, device, record):
    """The log half-step against its plain version on every branch of its
    plan: t in registers (float32 r = 4, 40, 128, 256, 512; bf16 r = 8,
    128, 256, 1024: a row of fewer than 32 vectors on fewer lanes) and in
    shared memory (float32 r = 1024, 4096; bf16 r = 2048, 4096: rows of
    more than 8 vectors a lane, taken in rounds), B = 3 on the scalar path,
    unaligned rows (float32 r = 1001, bf16 r = 1028), m = 1003, 16 and 1
    (not a multiple of the rows a warp reduces at once), m = 16383 and
    3001 (groups taking 2, 4 and 8 rows a batch: every kernel of the
    register path), the trainer's batch 2048 at r = 128 and the solve's
    16384 at r = 1024; each with an all -inf row (which must give -inf
    exactly), a row half -inf, and a -inf entry of t, at both scales: atol
    LSE_ATOL + rtol LSE_RTOL, and a second launch bit-identical."""
    from repro_torch.kernels import logmatvec, ref
    from repro_torch.kernels.backend import sm_count
    from repro_torch.kernels.logmatvec import log_halfstep

    f32, bf = torch.float32, torch.bfloat16
    cases = [(m, r, 1, dtype) for dtype, rs in (
        (f32, (4, 40, 128, 256, 512, 1024, 4096)),
        (bf, (8, 128, 256, 1024, 2048, 4096))) for r in rs
        for m in (1003, 16)]
    cases += [(16383, r, 1, dtype) for dtype, rs in (
        (f32, (40, 128, 256, 512)), (bf, (128, 256, 1024))) for r in rs]
    cases += [(m, 512, 1, bf) for m in (16383, 3001, 1003)]
    cases += [(3001, r, 1, dtype) for dtype in (f32, bf) for r in (128, 256)]
    cases += [(1003, r, 3, dtype) for dtype in (f32, bf) for r in (128, 1000)]
    cases += [(1003, 1001, 1, f32), (1003, 1028, 1, bf), (1, 128, 1, bf),
              (1, 1024, 1, f32), (GAN_BIG_BATCH, 128, 1, bf),
              (GAN_BIG_BATCH, 128, 1, f32), (N, R_ANCHORS, 1, f32)]
    planner = getattr(logmatvec, "_halfstep_kernel", None)
    for m, r, B, dtype in cases:
        g = torch.Generator(device=device).manual_seed(m * 5 + r + B)
        lw = (30.0 * torch.randn((m, r), generator=g, device=device)
              - 50.0).to(dtype)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        lw[m // 3] = -math.inf                  # an all -inf row
        lw[m // 2, ::2] = -math.inf             # a row half -inf
        t[r // 3] = -math.inf
        tag = f"{str(dtype)[6:]} m={m} r={r} B={B}"
        if planner is not None:
            vec = logmatvec._vectorized(lw, B)
            es, sms = lw.element_size(), sm_count(lw.device)
            nv, _, q, smem = planner(m, r, B, vec, es, sms)
            p = logmatvec._halfstep_plan(
                m, r, B, vec, es, sms, logmatvec._halfstep_blocks_per_sm(
                    lw.device.index, dtype == bf, nv, q, smem))
            tag += (f" (t in registers, {p.nv} vectors, {p.lanes} lanes a "
                    f"row, {p.rows} rows a batch, grid {p.grid})" if p.nv
                    else f" (t in shared memory, grid {p.grid})")
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw, t, lm, scale=scale)
            again = log_halfstep(lw, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            same = torch.equal(got, again)
            dead = bool(torch.isinf(got[m // 3]).all())
            record("log_halfstep",
                   f"{tag} scale={scale} -inf row {'inf' if dead else 'FINITE'}"
                   f" rerun {'bit-identical' if same else 'DIFFERS'}", err,
                   ok and same and dead)


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
    if isinstance(dead, tuple):         # whole row ranges of each side
        (i0, i1), (j0, j1) = dead
        a[i0:i1] = 0.0
        b[j0:j1] = 0.0
    elif dead:
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
    from repro_torch.kernels import fused_loop, ref
    from repro_torch.kernels.fused_loop import block_plan_fits, sinkhorn_block

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        plan = (fused_loop._block_plan(n, m, r, dtype, "scaling")
                if hasattr(fused_loop, "_scaling_block_plan") else None)
        if dead == "rank":     # every row of rank 1's slices dead
            dead = ((plan.slice(1, n), plan.slice(1, m)) if plan else
                    ((n // 8, n // 4), (m // 8, m // 4)))
        args = scaling_block_inputs(torch, n, m, r, dtype, dead, n + m + r,
                                    device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if plan is not None:
            lib_smem = fused_loop._lib().sinkhorn_block_smem_bytes(
                n, m, r, int(dtype == torch.bfloat16), plan.cluster,
                plan.threads, plan.groups, plan.lanes, plan.ldw)
            case += (f" C={plan.cluster} threads={plan.threads} "
                     f"G={plan.groups} L={plan.lanes} smem={plan.smem}")
            if lib_smem != plan.smem:
                record("sinkhorn_block", case + f" (library smem "
                       f"{lib_smem} != plan)", float("inf"), False)
                continue
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


BATCH_P = 32                    # bench_batch's accelerator shape: P
BATCH_N = 1024                  # problems of n = m = 1024 supports,
BATCH_R = 256                   # r = 256 features, eps 0.5
BATCH_EPS = 0.5


def check_batched(torch, device, record):
    """The four kernels with a problem axis (the flat contract, the row
    kernel as half-step and matvec, the log contract and the log
    half-step) on P = 1, 3 and 32 stacked problems against their plain
    batched twins (``kernels.ref``, ``@`` / LSE over each problem's axes),
    in float32 and bf16: at the engine's shape (n = 1024, r = 256), with a
    ragged last tile (n = 1001 and 1003: no slab or batch of rows divides
    it), t in shared memory (float32 r = 1024), the scalar paths (B = 3,
    r = 1000) and unaligned rows (r = 37); and in float32 at every shape
    phase 10's service sends them: P = 1, 2, 4, 8 and 16 (its batch
    buckets) on sides of 512, 1024 and 2048 (its padded supports), r =
    256. Each case also holds a second
    launch bit-identical, each problem within the same tolerance of the 2-D
    kernel on that problem alone, and, with P > 1, a problem whose factor
    holds a NaN row leaving every other problem's bits unchanged.
    Tolerances are phase 2's: the scaling kernels within 1e-5 of max
    |value|, the LSE kernels atol 1e-4 + rtol 1e-5."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    f32, bf = torch.float32, torch.bfloat16
    cases = [(P, BATCH_N, BATCH_R, 1) for P in (1, 3, BATCH_P)]
    cases += [(P, 1001, BATCH_R, 1) for P in (3, BATCH_P)]
    cases += [(3, 1003, 1024, 1), (BATCH_P, 1003, 40, 1), (3, 777, 1000, 3),
              (5, 301, 37, 1)]
    cases = [c + ((f32, bf),) for c in cases]
    # phase 10's megabatches: every batch bucket on every padded side
    cases += [(P, n, SERVE_TRACE["r"], 1, (f32,))
              for P in SERVE_BUCKETS for n in SERVE_SIDES
              if (P, n) != (1, BATCH_N)]
    for (P, n, r, B, dtypes) in cases:
        for dtype in dtypes:
            g = torch.Generator(device=device).manual_seed(P * 101 + n + r + B)
            xi = (torch.rand((P, n, r), generator=g, device=device)
                  + 0.05).to(dtype)
            lw = (30.0 * torch.randn((P, n, r), generator=g, device=device)
                  - 50.0).to(dtype)
            u = torch.rand((P, n, B), generator=g, device=device)
            t = torch.rand((P, r, B), generator=g, device=device)
            s = 10.0 * torch.randn((P, n, B), generator=g, device=device)
            lt = 10.0 * torch.randn((P, r, B), generator=g, device=device)
            marg = torch.full((P, n, B), 1.0 / n, device=device)
            lmarg = torch.log(marg)
            lw[:, n // 3] = -math.inf               # an all -inf row
            s[:, n // 5] = -math.inf                # dead atoms
            tag = f"{str(dtype)[6:]} P={P} n={n} r={r} B={B}"
            runs = (
                ("feature_contract", lambda x: feature_contract(x, u),
                 lambda x: ref.feature_contract_ref(x, u), xi, "scaling"),
                ("feature_matvec", lambda x: feature_matvec(x, t),
                 lambda x: ref.feature_matvec_ref(x, t), xi, "scaling"),
                ("sinkhorn_halfstep", lambda x: sinkhorn_halfstep(x, t, marg),
                 lambda x: ref.sinkhorn_halfstep_ref(x, t, marg), xi,
                 "scaling"),
                ("log_feature_contract", lambda x: log_feature_contract(x, s),
                 lambda x: ref.log_feature_contract_ref(x, s), lw, "lse"),
                ("log_halfstep",
                 lambda x: log_halfstep(x, lt, lmarg, scale=BATCH_EPS),
                 lambda x: ref.log_halfstep_ref(x, lt, lmarg,
                                                scale=BATCH_EPS), lw, "lse"),
            )
            one = {  # the 2-D kernel on problem i alone
                "feature_contract": lambda x, i: feature_contract(
                    x[i].contiguous(), u[i].contiguous()),
                "feature_matvec": lambda x, i: feature_matvec(
                    x[i].contiguous(), t[i].contiguous()),
                "sinkhorn_halfstep": lambda x, i: sinkhorn_halfstep(
                    x[i].contiguous(), t[i].contiguous(),
                    marg[i].contiguous()),
                "log_feature_contract": lambda x, i: log_feature_contract(
                    x[i].contiguous(), s[i].contiguous()),
                "log_halfstep": lambda x, i: log_halfstep(
                    x[i].contiguous(), lt[i].contiguous(),
                    lmarg[i].contiguous(), scale=BATCH_EPS),
            }
            for name, kernel, plain, x, kind in runs:
                kw = (dict(rel_to_max=SCALING_REL_TOL) if kind == "scaling"
                      else dict(atol=LSE_ATOL, rtol=LSE_RTOL))
                got = kernel(x)
                again = kernel(x)
                want = plain(x)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, **kw)
                same = torch.equal(got, again)
                lanes_ok = True
                for i in sorted({0, P // 2, P - 1}):
                    e_i, ok_i = compare(torch, got[i], one[name](x, i), **kw)
                    lanes_ok = lanes_ok and ok_i
                    err = max(err, e_i)
                iso = "n/a"
                if P > 1:
                    bad = x.clone()
                    bad[1, n // 2] = math.nan
                    poisoned = kernel(bad)
                    torch.cuda.synchronize()
                    others = [i for i in range(P) if i != 1]
                    iso = torch.equal(poisoned[others], got[others]) and \
                        bool(torch.isnan(poisoned[1]).any())
                record(name, f"batched {tag} rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}, lanes vs "
                       f"2-D {'ok' if lanes_ok else 'OFF'}, NaN lane "
                       f"isolated {iso}", err,
                       ok and same and lanes_ok and iso is not False)


def check_capture(torch, np, device, record):
    """Every kernel wrapper captured into a CUDA graph (as the solve
    runners capture them; the contracts are cooperative launches, the
    megakernels cluster launches) and replayed twice: each replay's output
    bit-identical to the eager launch on the same inputs."""
    from repro_torch import kernels as K

    g = torch.Generator(device=device).manual_seed(19)

    def rnd(*shape, dtype=torch.float32):
        return (torch.rand(shape, generator=g, device=device) + 0.05
                ).to(dtype).contiguous()

    xi, u, t = rnd(N, R_ANCHORS), rnd(N, 1), rnd(R_ANCHORS, 1)
    lxi = torch.log(xi)
    live = torch.full((N // STREAM_PAGE,), STREAM_PAGE, dtype=torch.int32,
                      device=device)
    live[1::2] = 0
    lx, lz = (torch.log(rnd(GAN_BATCH, 128)).to(torch.bfloat16)
              for _ in range(2))
    sx, sz = (rnd(GAN_BATCH, 128, dtype=torch.bfloat16) for _ in range(2))
    w = torch.full((GAN_BATCH, 1), 1.0 / GAN_BATCH, device=device)
    lw = torch.log(w)
    f0 = torch.zeros((GAN_BATCH, 1), device=device)
    t0 = K.log_feature_contract(lx, f0)
    x, anchors = rnd(N, D), rnd(R_ANCHORS, D)
    const = rnd(R_ANCHORS)
    kw = dict(page_size=STREAM_PAGE)
    cases = {
        "gaussian_feature_map": lambda: K.gaussian_feature_map(
            x, anchors, const, inv_eps=1 / EPS, log_space=True),
        "feature_contract": lambda: K.feature_contract(xi, u),
        "sinkhorn_halfstep": lambda: K.sinkhorn_halfstep(xi, t, u),
        "feature_matvec": lambda: K.feature_matvec(xi, t),
        "sinkhorn_block": lambda: K.sinkhorn_block(
            sx, sz, w, w, w, w, w, inner_steps=8)[0],
        "log_feature_contract": lambda: K.log_feature_contract(lxi, u),
        "log_halfstep": lambda: K.log_halfstep(lxi, t, u, scale=EPS),
        "log_sinkhorn_block": lambda: K.log_sinkhorn_block(
            lx, lz, lw, lw, w, f0, f0, t0, inner_steps=8, eps=0.5)[0],
        "log_matvec": lambda: K.log_matvec(lxi, t[:, 0].contiguous()),
        "paged_feature_contract": lambda: K.paged_feature_contract(
            xi, u, live, **kw),
        "paged_halfstep": lambda: K.paged_halfstep(xi, t, u, live, **kw),
        "paged_feature_matvec": lambda: K.paged_feature_matvec(
            xi, t, live, **kw),
    }
    for name, fn in cases.items():
        want = fn().clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        same = []
        for _ in range(2):
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(got, want))
        record(name, "captured in a CUDA graph, 2 replays bit-identical",
               0.0, all(same))


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
    from repro_torch.kernels.logmatvec import log_feature_contract
    from repro_torch.kernels.paged import paged_feature_contract

    x, u, c = feature_inputs(torch, np, N, R_ANCHORS, D, EPS, 0, device)
    xi = torch.rand((N, R_ANCHORS), device=device)
    xi16 = xi.to(torch.bfloat16)
    w = torch.rand((N, 1), device=device)
    # the trainer's batch-2048 factor and weights, built outside the
    # profiled call so that only the wrapper's launches are counted
    xi16_gan = xi16[:GAN_BIG_BATCH, :128].contiguous()
    w_gan = w[:GAN_BIG_BATCH]
    live = torch.full((N // STREAM_PAGE,), STREAM_PAGE, dtype=torch.int32,
                      device=device)
    live[::2] = 0
    for label, fn in (
            ("gaussian_feature_map", lambda: gaussian_feature_map(
                x, u, c, inv_eps=1 / EPS, log_space=True)),
            ("feature_contract f32", lambda: feature_contract(xi, w)),
            ("feature_contract bf16", lambda: feature_contract(xi16, w)),
            ("log_feature_contract f32",
             lambda: log_feature_contract(xi, w)),
            ("log_feature_contract bf16 2048x128",
             lambda: log_feature_contract(xi16_gan, w_gan)),
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
    # one log iteration in the plan's order on two factors of 64 MiB
    y = 0.3 * torch.randn((M, d), generator=g, device=device)
    log_z = gaussian_feature_map(y, u, c, inv_eps=inv, log_space=True)
    lmarg_n = torch.full((n, 1), -math.log(n), device=device)
    zero = torch.zeros_like(lmarg)

    def iteration():
        gz = log_halfstep(log_z, t, lmarg, scale=EPS)
        t2 = log_feature_contract(log_z, gz)
        f = log_halfstep(log_w, t2, lmarg_n, scale=EPS)
        t3 = log_feature_contract(log_w, f)
        log_halfstep(log_z, t3, zero, scale=-1.0)

    time_plan_iteration(torch, iteration, f"log f32 n={n} r={r}, two "
                        "factors of 64 MiB", order="half-step, contract, "
                        "half-step, contract, raw LSE")
    return rows


def time_halfstep_cold(torch, np, device):
    """The log half-step at the row kernel's four cold shapes (n = 16384,
    r = 1024 and 256, float32 and bf16, B = 1), on log-features log(U(0, 1)
    + 0.05), cycling through copies past 100 MB (the bound counts
    device-memory bytes), and warm on one copy; beside its plain version
    and ``torch.logsumexp`` on the same copies."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_halfstep

    n, B = N, 1
    g = torch.Generator(device=device).manual_seed(13)
    lmarg = torch.full((n, B), -math.log(n), device=device)
    for r in (R_ANCHORS, 256):
        lw32 = torch.log(torch.as_tensor(explicit_features(np, n, r, r + 1),
                                         device=device))
        t = torch.randn((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            copies = [lw32.to(dtype, copy=True) for _ in
                      range(max(1, math.ceil(100e6 / (fb * n * r))))]
            cold = [time_ms(torch, cycling(fn, copies)) for fn in (
                lambda w: log_halfstep(w, t, lmarg, scale=EPS),
                lambda w: ref.log_halfstep_ref(w, t, lmarg, scale=EPS),
                lambda w: torch.logsumexp(w.float()[:, :, None]
                                          + t[None, :, :], dim=1))]
            warm = time_ms(torch, lambda: log_halfstep(copies[0], t, lmarg,
                                                       scale=EPS))
            b_ms, b_by = bound(fb * n * r + 4.0 * (r * B + 2 * n * B),
                               3.0 * n * r * B)
            tag = "f32" if dtype == torch.float32 else "bf16"
            log(f"  log_halfstep           {tag} n={n} r={r} cold: kernel "
                f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain {cold[1]:.4f} "
                f"ms  library {cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
                f"  kernel/bound {cold[0] / b_ms:.2f}")
            del copies


def time_training_kernels(torch, np, device):
    """Phase 3 at the training path's shapes: the bf16 contract and
    half-step at the streaming plan's batch 2048, r = 128 (float32 beside
    them), and the megakernel at the OT-GAN shape n = m = 256, r = 128,
    bf16, inner_steps = 8. No PyTorch call computes eight Sinkhorn
    iterations, so the megakernel has no library time."""
    from repro_torch.kernels import fused_loop, logmatvec, ref
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
        # The contract's two paths forced, beside the one the wrapper takes
        # (a checkout from before the one-launch contract took the scalar
        # path at r = 128; the one-launch contract takes 16-byte vectors
        # in row groups).
        parts = []
        for vec in (True, False):
            with log_contract_path(logmatvec, vec):
                parts.append(f"{'16-byte vector' if vec else 'scalar'} path "
                             f"forced {time_ms(torch, lambda: log_feature_contract(log_w, s)):.4f} ms")
        log(f"  log_feature_contract   {tag} n={n} r={r}: {'; '.join(parts)}")

    n = m = GAN_BATCH
    steps = 8
    args = block_inputs(torch, np, n, m, 128, D, 0.5, torch.bfloat16, 0, 7,
                        device)
    nbytes = 2.0 * (n + m) * 128 + 4.0 * (3 * n + 4 * m + 2 * 128 + 1)
    flops = 3.0 * 128 * (steps * 2 * (n + m) + m)

    def block(inner=steps):
        return log_sinkhorn_block(*args, inner_steps=inner, eps=0.5)

    ms = time_ms(torch, block)
    plain_ms = time_ms(torch, lambda: ref.log_sinkhorn_block_ref(
        *args, inner_steps=steps, eps=0.5))
    b_ms, b_by = bound(nbytes, flops)
    rows["log_sinkhorn_block"] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=None, bound_ms=b_ms,
                                      bound_by=b_by)
    plan_of = getattr(fused_loop, "_block_plan", None)
    shape = (f"cluster of {plan_of(n, m, 128, torch.bfloat16).cluster} CTAs"
             if plan_of else "one CTA")
    log(f"  log_sinkhorn_block     bf16 n=m={n} r=128 inner_steps={steps} "
        f"({shape}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
        f"none  bound {b_ms:.5f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    # a launch of one iteration splits the fixed cost (the launch, staging
    # the factors, the block-end error) from the cost of an iteration
    one_ms = time_ms(torch, lambda: block(1))
    log(f"  log_sinkhorn_block     inner_steps=1: kernel {one_ms:.4f} ms; "
        f"each further iteration {(ms - one_ms) / (steps - 1):.4f} ms")
    # the yardstick: the same iterations through the per-iteration kernels
    unfused = unfused_log_block(torch, args, steps, 0.5)
    unfused_ms = time_ms(torch, unfused, per_batch=4)
    got, want = block(), unfused()
    diff = max(float((x - y).abs().nan_to_num(0.0).max())
               for x, y in zip(got[:3], want[:3]))
    log(f"  log_sinkhorn_block     the same {steps} iterations unfused (2 "
        f"log contracts, 2 log half-steps an iteration, then the check): "
        f"{unfused_ms:.4f} ms; megakernel/unfused {ms / unfused_ms:.2f}; "
        f"max |d f, g, t| {diff:.2e}, err {float(got[3]):.4e} / "
        f"{float(want[3]):.4e}")
    return rows


def unfused_log_block(torch, args, steps, eps):
    """``steps`` log-domain iterations at momentum 1 through the
    per-iteration kernels, in the log plan's order (``ops._log_plan``:
    half-step zeta, contract zeta, half-step xi, contract xi), then the
    block-end check: the megakernel's yardstick."""
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    lxi, lzt, loga, logb, b, _, _, t0 = args
    zero = torch.zeros_like(logb)

    def run():
        t = t0
        for _ in range(steps):
            g = log_halfstep(lzt, t, logb, scale=eps)
            t = log_feature_contract(lzt, g / eps)
            f = log_halfstep(lxi, t, loga, scale=eps)
            t = log_feature_contract(lxi, f / eps)
        lse = log_halfstep(lzt, t, zero, scale=-1.0)
        return f, g, t, torch.sum(torch.abs(torch.exp(lse + g / eps) - b))

    return run


def log_contract_path(logmatvec, vec):
    """A context forcing the log contract's 16-byte path on (``vec``,
    where the rows allow it) or off: through ``_contract_vectorized`` in a
    checkout whose wrapper has that rule, else through ``_vectorized``."""
    name = ("_contract_vectorized" if hasattr(logmatvec,
                                              "_contract_vectorized")
            else "_vectorized")
    base = logmatvec._vectorized

    @contextlib.contextmanager
    def ctx():
        old = getattr(logmatvec, name)
        setattr(logmatvec, name, lambda w, B: vec and base(w, B))
        try:
            yield
        finally:
            setattr(logmatvec, name, old)

    return ctx()


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
    from repro_torch.kernels import fused_loop, kermatvec, ref
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
    plan_of = getattr(fused_loop, "_scaling_block_plan", None)
    shape = (f"cluster of {plan_of(n, m, r, torch.bfloat16).cluster} CTAs"
             if plan_of else "one CTA")
    log(f"  sinkhorn_block         bf16 n=m={n} r={r} inner_steps={steps} "
        f"({shape}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
        f"none  bound {b_ms:.6f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    # a launch of one iteration splits the fixed cost (staging the factors,
    # the block-end error) from the cost of an iteration
    one_ms = time_ms(torch, lambda: sinkhorn_block(*args, inner_steps=1))
    log(f"  sinkhorn_block         inner_steps=1: kernel {one_ms:.4f} ms; "
        f"each further iteration {(ms - one_ms) / (steps - 1):.4f} ms")
    # the yardstick: the same iterations through the per-iteration kernels
    unfused = unfused_scaling_block(torch, args, steps)
    unfused_ms = time_ms(torch, unfused, per_batch=4)
    got, want = sinkhorn_block(*args, inner_steps=steps), unfused()
    diff = max(float((x - y).abs().max()) for x, y in zip(got[:3], want[:3]))
    log(f"  sinkhorn_block         the same {steps} iterations unfused (2 "
        f"contracts, a half-step and a matvec an iteration, then the "
        f"check): {unfused_ms:.4f} ms; megakernel/unfused "
        f"{ms / unfused_ms:.2f}; max |d u, v, s| {diff:.2e}, err "
        f"{float(got[3]):.4e} / {float(want[3]):.4e}")
    return rows


def unfused_scaling_block(torch, args, steps):
    """``steps`` scaling-space iterations at momentum 1 through the
    per-iteration kernels, in the scaling plan's order
    (``ops._scaling_plan``: v = b / s, contract zeta, half-step xi,
    contract xi, matvec zeta), then the block-end error: the scaling
    megakernel's yardstick."""
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    xi, zeta, a, b, u0, v0, s0 = args

    def run():
        u, v, s = u0, v0, s0
        for _ in range(steps):
            v = b / s
            t = feature_contract(zeta, v)
            u = sinkhorn_halfstep(xi, t, a)
            s = feature_matvec(zeta, feature_contract(xi, u))
        return u, v, s, torch.sum(torch.abs(v * s - b))

    return run


def time_plan_iteration(torch, iteration, what, module=None,
                        order="contract, half-step, contract, matvec"):
    """One Sinkhorn iteration in the plan's order (``ops._scaling_plan``'s
    and ``_paged_scaling_plan``'s step: contract zeta, half-step xi,
    contract xi, matvec zeta; ``ops._log_plan``'s: half-step zeta,
    contract zeta, half-step xi, contract xi, raw LSE of zeta), run back
    to back on two factors as a solve runs it: each row kernel is followed
    by the contract of its own factor, which finds it in the L2 where the
    row kernel left it there, and each contract by a row kernel of the
    other factor. With ``module``, also with its evict-first loads forced
    on and off."""
    parts = []
    for label, value in (("evict-first on", True),
                         ("evict-first off", False)):
        with forced(module, "stream", value) as ok:
            if ok:
                parts.append(f"{label} {time_ms(torch, iteration):.4f} ms")
    parts.append(f"as planned {time_ms(torch, iteration):.4f} ms")
    log(f"  plan iteration         {what} ({order}): {'; '.join(parts)}")


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
    return h.hexdigest()


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


def build_problem(torch, np, seed, device, eps=EPS):
    """A user's request: numpy clouds and anchors, the default device."""
    from repro_torch.core import OTProblem
    x, y = clouds(np, seed)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    u, _ = anchors_for(torch, np, R_ANCHORS, D, eps, R, seed, "cpu")
    prob = OTProblem.from_point_clouds(x, y, u.numpy(), eps=eps, R=R)
    if prob.a.device != device:
        raise RuntimeError(f"the default device put the request on "
                           f"{prob.a.device}, not {device}")
    return prob


def runners_module():
    """``repro_torch.core.runners``, or None in a checkout from before the
    captured loops (``--src``)."""
    try:
        from repro_torch.core import runners
    except ImportError:
        return None
    return runners


def loop_stats(cache=None):
    """Captures, replays, hits and host reads of a runner cache (default
    the solves' ``RUNNERS``); zeros where the checkout has none."""
    mod = runners_module()
    if cache is None:
        cache = None if mod is None else mod.RUNNERS
    if cache is None:
        return {"runners": 0, "captures": 0, "replays": 0, "hits": 0,
                "reads": 0}
    return cache.stats()


def loop_delta(before, after):
    return {k: after[k] - before[k] for k in ("captures", "replays",
                                               "reads")}


def clear_runners():
    """Drop the solves' runners, so a phase counts its own captures."""
    mod = runners_module()
    if mod is not None:
        mod.RUNNERS.clear()


def eager_loop():
    """A context running every fused-plan solve through the eager host
    loop (one check block, one host read at a time), the graph path's
    yardstick on the same kernels; a checkout from before the captured
    loops runs that loop anyway. Raises where the checkout has runners but
    no such option: the graph path would be held against itself."""
    from repro_torch.core import sinkhorn
    if runners_module() is not None and \
            "graphs" not in getattr(sinkhorn, "_FORCE", {}):
        raise RuntimeError("core.sinkhorn has runners but no "
                           "_FORCE['graphs']: no eager loop to compare with")
    return forced(sinkhorn, "graphs", False)


def run_main_path(torch, np, device):
    """The counted run: three solve() requests and one divergence. Every
    solve's loop replays its cell's captured graph: the first request
    captures one runner a stage eps, the rest (the divergence's three
    terms share the last stage's cell) must capture nothing."""
    from repro_torch.core import EpsSchedule, sinkhorn_divergence_geometry, solve
    from repro_torch.kernels import launch_counts, reset_launch_counts

    schedule = EpsSchedule(eps_init=1.0, decay=0.5)
    problems = [build_problem(torch, np, s, device) for s in SEEDS]
    clear_runners()
    phase0 = loop_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    results, failures, later_captures = [], [], 0
    reset_launch_counts()
    for seed, prob in zip(SEEDS, problems):
        before, loop0 = launch_counts(), loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after, loop = launch_counts(), loop_delta(loop0, loop_stats())
        delta = {k: after[k] - before[k] for k in after}
        results.append(res)
        if seed != SEEDS[0]:
            later_captures += loop["captures"]
        log(f"  solve seed={seed}: cost={float(res.cost):.7f} "
            f"n_iter={res.n_iter} marginal_err={float(res.marginal_err):.3e} "
            f"wall={wall:.4f} s ({wall / res.n_iter * 1e3:.4f} ms/iteration)"
            f"  loop {loop}  launches={delta}")
    before, loop0 = launch_counts(), loop_stats()
    t0 = time.perf_counter()
    div = sinkhorn_divergence_geometry(problems[0].geometry, tol=TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after, loop = launch_counts(), loop_delta(loop0, loop_stats())
    later_captures += loop["captures"]
    delta = {k: after[k] - before[k] for k in after}
    log(f"  divergence seed=0: value={float(div):.7f} wall={wall:.3f} s  "
        f"loop {loop}  launches={delta}")
    counts = launch_counts()
    stats = loop_stats()
    cells = stats["runners"]
    mib = 1 << 20
    log(f"  device memory past the problems: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / mib:.1f} MiB, held "
        f"after {(torch.cuda.memory_allocated() - base) / mib:.1f} MiB "
        f"(runner buffers {stats.get('bytes', 0) / mib:.1f} MiB)")
    stats = loop_delta(phase0, stats)
    ok = (runners_module() is None or
          (later_captures == 0 and stats["captures"] == cells
           == len(EpsSchedule(eps_init=1.0, decay=0.5).stages(EPS))))
    log(f"  solve loops: {stats['captures']} captures for {cells} cells (one "
        f"a stage eps), {later_captures} after the first request; "
        f"{stats['replays']} replays, {stats['reads']} host reads "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("captures after warmup")
    return problems, results, div, counts, failures


def kernel_rows(torch, prof):
    """The profiler's rows that are device kernels. A CPU-side row (an aten
    op, the autograd Function around a solve) also reports the device time
    of the kernels it launched, so summing every row counts them twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda]


def profile_solve(torch, problem, schedule):
    """Device busy share of one annealed solve request, through the graph
    loop and through the eager host loop."""
    from repro_torch.core import solve
    profile_call(torch, "solve seed=0 (graph loop)",
                 lambda: solve(problem, schedule=schedule, tol=TOL))
    with eager_loop():
        profile_call(torch, "solve seed=0 (eager host loop)",
                     lambda: solve(problem, schedule=schedule, tol=TOL))


def time_static_copies(torch, device):
    """Device time of what a runner adds to each solve of the main path's
    cell before its replays: the copy of the plan's two (n, r) float32
    factors into the runner's static buffers, beside the copy's bound
    (each byte read once and written once at 3.35 TB/s)."""
    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    src = [torch.rand((N, R_ANCHORS), device=device) for _ in range(2)]
    dst = [torch.empty_like(t) for t in src]

    def copy():
        for d, t in zip(dst, src):
            d.copy_(t)

    ms = time_ms(torch, copy)
    nbytes = 2 * 2 * N * R_ANCHORS * 4
    log(f"  static copies of a solve stage (two {N} x {R_ANCHORS} float32 "
        f"factors): {ms:.4f} ms, bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f}"
        " ms")


def time_replay_blocks(torch, problem, schedule, solves=3):
    """Wall of one annealed request (median of ``solves``) with K, the
    check blocks a replay runs, set to 2, 4, 8 and 16 in place of
    ``sinkhorn._replay_blocks``'s: host reads against the iterations run
    past each stage's stop (the log half-step's launches over 3, less
    n_iter). Each K is a cell of its own, captured by a first solve that
    is not timed."""
    from repro_torch.core import sinkhorn, solve
    from repro_torch.kernels import launch_counts

    if runners_module() is None:
        return
    real = sinkhorn._replay_blocks
    for blocks in (2, 4, 8, 16):
        sinkhorn._replay_blocks = \
            lambda cadence, max_iter, dev, k=blocks: min(
                k, -(-max_iter // cadence))
        try:
            solve(problem, schedule=schedule, tol=TOL)
            walls = []
            for _ in range(solves):
                before, loop0 = launch_counts(), loop_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve(problem, schedule=schedule, tol=TOL)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                loop = loop_delta(loop0, loop_stats())
                run = (launch_counts()["log_halfstep"]
                       - before["log_halfstep"]) // 3
        finally:
            sinkhorn._replay_blocks = real
        wall = statistics.median(walls)
        log(f"  K={blocks:2d} blocks a replay: {wall * 1e3:.3f} ms a solve "
            f"({wall / res.n_iter * 1e3:.4f} ms/iteration), n_iter "
            f"{res.n_iter}, iterations run {run} ({run - res.n_iter} past "
            f"the stops), {loop['reads']} host reads, {loop['replays']} "
            "replays")


def time_cache_pressure(torch, np, device, problem, repeats=3, one_off=4):
    """Requests that test the solves' runner cache, on this checkout's
    loop (the parent's through ``--src``): a 9-stage annealed request
    (``EpsSchedule(1.0, 0.75)`` down to eps 0.1, 9 cells), ``repeats``
    times from an empty cache; then ``one_off`` one-stage requests, each
    at an eps no request used before (cells never repeated; the problem's
    set-up not timed); the device memory each part adds at its peak and
    holds after, and what the runners' buffers hold."""
    from repro_torch.core import EpsSchedule, solve

    nine = EpsSchedule(eps_init=1.0, decay=0.75)
    mod = runners_module()
    clear_runners()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in range(repeats):
        loop0 = loop_stats()
        t0 = time.perf_counter()
        res = solve(problem, schedule=nine, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  9-stage request {k}: {wall * 1e3:.3f} ms, n_iter "
            f"{res.n_iter} ({wall / res.n_iter * 1e3:.4f} ms/iteration), "
            f"loop {loop_delta(loop0, loop_stats())}")
    mib = 1 << 20
    held = 0 if mod is None else mod.RUNNERS.nbytes
    log(f"  9-stage requests, device memory past the start: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / mib:.1f} MiB, held "
        f"after {(torch.cuda.memory_allocated() - base) / mib:.1f} MiB "
        f"(runner buffers {held / mib:.1f} MiB, "
        f"{loop_stats()['runners']} runners)")
    for k in range(one_off):
        prob = build_problem(torch, np, 0, device, eps=EPS + 0.01 * (k + 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loop0 = loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  one-off request eps={prob.eps:.2f}: {wall * 1e3:.3f} ms, "
            f"n_iter {res.n_iter} ({wall / res.n_iter * 1e3:.4f} "
            f"ms/iteration), peak +"
            f"{(torch.cuda.max_memory_allocated() - start) / mib:.1f} MiB, "
            f"loop {loop_delta(loop0, loop_stats())}")
        del prob, res
    clear_runners()


def profile_call(torch, label, fn):
    """Device busy share of one call of ``fn`` (a solve): the device time
    of every kernel the profiler saw over the call's wall time (both under
    the profiler, which slows the host side). Returns the share, or None
    where the profiler saw no device time."""
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
        return None
    log(f"  device busy share {device_us / 1e6 / wall:.3f} "
        f"(idle {1 - device_us / 1e6 / wall:.3f}) under the profiler")
    for e in top[:6]:
        log(f"    {e.key[:60]:60s} {e.count:6d} calls "
            f"{e.self_device_time_total / 1e3:9.3f} ms")
    return device_us / 1e6 / wall


def compare_main_path(torch, problems, results, div, schedule_cls):
    """Rerun each request on the kernels and with use_pallas=False; both
    must agree (cost rel <= 1e-4, |d n_iter| <= 1 per stage)."""
    from repro_torch.core import sinkhorn_log_geometry, solve_annealed

    failures = []
    schedule = schedule_cls(eps_init=1.0, decay=0.5)
    for seed, prob, res in zip(SEEDS, problems, results):
        loop0 = loop_stats()
        t0 = time.perf_counter()
        k = solve_annealed(prob, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall_k = time.perf_counter() - t0
        loop = loop_delta(loop0, loop_stats())
        with eager_loop():
            t0 = time.perf_counter()
            e = solve_annealed(prob, schedule=schedule, tol=TOL)
            torch.cuda.synchronize()
            wall_e = time.perf_counter() - t0
        # the same kernels in the same order on the same inputs: the graph
        # replays give the eager loop's iterations and its potentials bit
        # for bit
        same_e = (k.stage_iters == e.stage_iters
                  and torch.equal(k.result.f, e.result.f)
                  and torch.equal(k.result.g, e.result.g))
        it = k.result.n_iter
        log(f"  seed={seed}: graph loop {wall_k * 1e3:.3f} ms "
            f"({wall_k / it * 1e3:.4f} ms/iteration, loop {loop}), eager "
            f"host loop {wall_e * 1e3:.3f} ms ({wall_e / it * 1e3:.4f} "
            f"ms/iteration); stage_iters {k.stage_iters} / "
            f"{e.stage_iters}, potentials bit-identical {same_e} "
            f"{'ok' if same_e and loop['captures'] == 0 else 'FAIL'}")
        if not same_e or loop["captures"] != 0:
            failures.append(f"graph loop against the eager loop seed={seed}")
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
    by name: through the graph loop, then through the eager host loop."""
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
    for ((data, z), adv), graphs in zip(
            [(b, a) for b, a in zip(batches[1:], (True, False))] * 2,
            (True, True, False, False)):
        with (contextlib.nullcontext() if graphs else eager_loop()), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            d, _ = ot_gan.train_step(model, z, data, obj, adv=adv)
            float(d)
            wall = time.perf_counter() - t0
        rows = kernel_rows(torch, prof)
        dev_us = sum(e.self_device_time_total for e in rows)
        kind = ("adversary" if adv else "generator") + \
            (" (graph loop)" if graphs else " (eager host loop)")
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


def compare_step_plans(torch, device, steps=24):
    """ms per trainer step at the default configuration with the auto
    cadence (the megakernel, 8 iterations a launch) through the graph loop
    and through the eager host loop, and the streaming per-iteration plan
    (inner_steps=1) through the graph loop, on the same data, in the order
    graph, eager, streaming, streaming, eager, graph, each from fresh
    weights."""
    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan

    gen = torch.Generator(device=device).manual_seed(2)
    batches = [(ot_gan.make_data(gen, GAN_BATCH),
                torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen,
                            device=device)) for _ in range(steps)]
    out = {}
    for label in ("megakernel", "megakernel eager", "streaming", "streaming",
                  "megakernel eager", "megakernel"):
        policy = ExecutionPolicy.training(
            inner_steps=1 if label == "streaming" else None)
        obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40, policy=policy)
        model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                                  device)
        loop = eager_loop() if "eager" in label else contextlib.nullcontext()
        with loop:
            ot_gan.train_step(model, batches[0][1], batches[0][0], obj,
                              adv=True)
            torch.cuda.synchronize()
            times = []
            for k, (data, z) in enumerate(batches):
                t0 = time.perf_counter()
                d, _ = ot_gan.train_step(model, z, data, obj, adv=k % 4 != 3)
                float(d)                # as the trainer reads each step's
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
        out.setdefault(label, []).append(ms)
        log(f"  {label:16s} plan: {ms:.3f} ms per trainer step (median of "
            f"{steps}, 3 adversary : 1 generator; mean "
            f"{statistics.mean(times):.3f})")
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
    clear_runners()
    reset_launch_counts()
    loop0 = loop_stats()
    t0 = time.perf_counter()
    out_k = run_trainer(torch, device=device)
    wall = time.perf_counter() - t0
    loop = loop_delta(loop0, loop_stats())
    counts_train = launch_counts()
    adv_ms, gen_ms = step_summary(out_k)
    per_step = 3 * math.ceil(40 / 8)
    warm = out_k.get("warmup_launches", 0)
    log(f"  trainer --strict: {GAN_STEPS} steps in {wall:.3f} s; median "
        f"{adv_ms:.3f} ms per adversary step, {gen_ms:.3f} ms per generator "
        f"step; Wbar {out_k['divergences'][0]:.5f} -> "
        f"{out_k['divergences'][-1]:.5f}; launches {counts_train} "
        f"({sum(out_k['block_launches']) / GAN_STEPS:.1f} megakernel "
        f"launches a step, expected {per_step}; {warm} in the warm-up)")
    if counts_train["log_sinkhorn_block"] != per_step * GAN_STEPS + warm:
        failures.append("trainer megakernel launches")
    # the warm-up's 3 solves: one capture and one read each
    log(f"  trainer solve loops: {loop['captures']} captures (the warm-up), "
        f"{out_k.get('captures', 0)} after it; {loop['replays']} replays and "
        f"{loop['reads']} host reads, {(loop['reads'] - 3) / GAN_STEPS:.2f} a "
        f"step after the warm-up (the eager host loop: "
        f"{3 * math.ceil(40 / 8)} a step)")
    if runners_module() is not None and (out_k["captures"] != 0
                                         or loop["captures"] != 1):
        failures.append("trainer captures after warmup")
    first, z, data = trainer_step0(torch, device)
    obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                      policy=ExecutionPolicy.training())
    with torch.no_grad():
        d_graph, _ = ot_gan.gan_losses(first, z, data, obj)
        with eager_loop():
            d_eager, _ = ot_gan.gan_losses(first, z, data, obj)
    same = float(d_graph) == float(d_eager)
    log(f"  trainer step-0 Wbar through the graph loop {float(d_graph):.9f}, "
        f"the eager host loop {float(d_eager):.9f}: bit-identical {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("trainer graph loop against the eager loop")

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
    clear_runners()
    phase0 = loop_stats()
    torch.cuda.synchronize()
    out = {"feats": {}, "clouds": []}
    failures = []
    reset_launch_counts()
    for r, prob in feats.items():
        for precision in ("highest", "bf16"):
            before, loop0 = launch_counts(), loop_stats()
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
                f" loop {loop_delta(loop0, loop_stats())}"
                f" launches={counts_delta(before, launch_counts())}")
    for seed, prob in zip(SEEDS, clouds_):
        before, loop0 = launch_counts(), loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, method="factored", tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["clouds"].append(res)
        dead_rows = sum(int((w.sum(1) == 0).sum()) for w in
                        prob.geometry.features())
        log(f"  clouds seed={seed} eps=1.0 method=factored: cost="
            f"{float(res.cost):.7f} n_iter={res.n_iter} marginal_err="
            f"{float(res.marginal_err):.3e} wall={wall:.4f} s "
            f"({wall / res.n_iter * 1e3:.4f} ms/iteration); feature rows "
            f"that underflow to 0: {dead_rows}; loop "
            f"{loop_delta(loop0, loop_stats())} launches="
            f"{counts_delta(before, launch_counts())}")
    before, loop0 = launch_counts(), loop_stats()
    obj = scaling_objective()
    t0 = time.perf_counter()
    out["gan"] = obj.solve(gan, *obj.uniform_weights(gan))
    torch.cuda.synchronize()
    delta = counts_delta(before, launch_counts())
    loop = loop_delta(loop0, loop_stats())
    log(f"  OTObjective.solve n=m={GAN_BATCH} r=128 bf16 40 iterations: cost="
        f"{float(out['gan'].cost):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"loop {loop} launches={delta}")
    # the first solve of the cell: its warm-up block, then 5 a replay
    if delta["sinkhorn_block"] != 40 // 8 + min(loop["captures"], 1):
        failures.append("objective solve did not take the megakernel 5 times")
    before, loop0 = launch_counts(), loop_stats()
    t0 = time.perf_counter()
    out["div"] = scaling_divergence(torch, leaves)
    torch.cuda.synchronize()
    log(f"  scaling divergence n=m=4096 r=256: value "
        f"{float(out['div'][0]):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"(value and 4 gradients) loop {loop_delta(loop0, loop_stats())} "
        f"launches={counts_delta(before, launch_counts())}")
    counts = launch_counts()
    missing = [k for k in SCALING_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    stats = loop_stats()
    cells = stats["runners"]
    stats = loop_delta(phase0, stats)
    # four feature cells, the clouds', the objective's, the divergence's
    # (its three terms share one)
    ok = runners_module() is None or stats["captures"] == cells == 7
    log(f"  solve loops: {stats['captures']} captures for {cells} cells, "
        f"{stats['replays']} replays, {stats['reads']} host reads "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("captures against cells")
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
        loop0 = loop_stats()
        t0 = time.perf_counter()
        g = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                  precision=precision)
        torch.cuda.synchronize()
        wall_g = time.perf_counter() - t0
        loop = loop_delta(loop0, loop_stats())
        with eager_loop():
            t0 = time.perf_counter()
            e = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                      precision=precision)
            torch.cuda.synchronize()
            wall_e = time.perf_counter() - t0
        check(f"features r={r} {precision}: graph loop again "
              f"{wall_g / g.n_iter * 1e3:.4f} ms/iteration (loop {loop}), "
              f"eager host loop {wall_e / e.n_iter * 1e3:.4f} ms/iteration; "
              f"n_iter {g.n_iter}/{e.n_iter}, u and v bit-identical to the "
              "eager loop's and the counted run's",
              loop["captures"] == 0 and g.n_iter == e.n_iter == res.n_iter
              and all(torch.equal(x, y) for x, y in
                      ((g.u, e.u), (g.v, e.v), (res.u, e.u), (res.v, e.v))))
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
    profile_call(torch, f"feature solve r={R_ANCHORS} f32 (graph loop)",
                 lambda: solve(prob, tol=0.0, max_iter=SCALING_ITERS))
    with eager_loop():
        profile_call(torch, f"feature solve r={R_ANCHORS} f32 (eager host "
                     "loop)",
                     lambda: solve(prob, tol=0.0, max_iter=SCALING_ITERS))
    for seed, prob, res in zip(SEEDS, clouds_, out["clouds"]):
        with eager_loop():
            e = solve(prob, method="factored", tol=TOL)
        check(f"clouds seed={seed}: eager host loop n_iter {e.n_iter}, u "
              "and v bit-identical to the graph loop's",
              e.n_iter == res.n_iter and torch.equal(e.u, res.u)
              and torch.equal(e.v, res.v))
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
    obj = scaling_objective()
    with eager_loop():
        e = obj.solve(gan, *obj.uniform_weights(gan))
    check(f"objective solve: eager host loop n_iter {e.n_iter}, u and v "
          "bit-identical to the graph loop's",
          e.n_iter == out["gan"].n_iter and torch.equal(e.u, out["gan"].u)
          and torch.equal(e.v, out["gan"].v))
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
    (the scaling megakernel, 8 iterations a launch) through the graph loop
    and the eager host loop, against the streaming plan (inner_steps=1),
    in the order graph, eager, streaming, streaming, eager, graph."""
    for label in ("megakernel", "megakernel eager", "streaming",
                  "streaming", "megakernel eager", "megakernel"):
        obj = scaling_objective(
            {"inner_steps": 1 if label == "streaming" else None})
        a, b = obj.uniform_weights(gan)
        loop = eager_loop() if "eager" in label else contextlib.nullcontext()
        with loop:
            obj.solve(gan, a, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(solves):
                res = obj.solve(gan, a, b)
            float(res.cost)
            ms = (time.perf_counter() - t0) * 1e3 / solves
        log(f"  {label:16s} plan: {ms:.4f} ms per objective solve (mean of "
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
        traces_warm = getattr(solver, "traces", 0)
        loop0 = loop_stats(getattr(solver, "_runners", None))
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
    loop = loop_delta(loop0, loop_stats(getattr(solver, "_runners", None)))
    stats = svc.stats()
    log(f"  {method} {precision}: warmup {warmup_s:.3f} s; {resolved} "
        f"mutations in {stats['solves']} flushes (coalesce ratio "
        f"{stats['coalesce_ratio']:.1f}); pages live "
        f"{pair.x.store.stats()['live_pages']}/{pair.x.store.n_pages}; "
        f"launches {delta}")
    log(f"  {method} {precision} solve loops: traces {traces_warm} after the "
        f"warmup, {getattr(solver, 'traces', 0)} after "
        f"{len(records)} solves; {loop['replays']} replays and "
        f"{loop['reads']} host reads over them "
        f"({loop['reads'] / len(records):.1f} a solve)")
    return dict(method=method, precision=precision, solver=solver,
                pair=pair, records=records, delta=delta,
                events=[(e["mode"], e["kind"]) for e in events],
                resolved=resolved, solves=stats["solves"],
                traces=(traces_warm, getattr(solver, "traces", 0)),
                loop=loop)


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
    graph_ms, eager_ms, eager_ok = [], [], True
    runners = ({"runners": solver._runners} if hasattr(solver, "_runners")
               else {})
    for rec in run["records"]:
        st, res = rec["state"], rec["res"]
        args = ([torch.as_tensor(st[s]["feats"], device=device)
                 for s in "xy"]
                + [st[s][k] for k in ("page_live", "weights", "f0")
                   for s in "xy"])
        kw = dict(page_size=STREAM_PAGE, eps=STREAM_EPS, method=method,
                  tol=TOL, max_iter=solver.max_iter,
                  momentum=solver.momentum, precision=precision)
        # the solve alone from the same state, through the solver's runner
        # and through the eager host loop, on the stores' storage dtype:
        # the same kernels in the same order, so bit for bit the same
        stored = [args[0].to(solver.storage_dtype),
                  args[1].to(solver.storage_dtype)] + args[2:]
        for loop, walls in ((contextlib.nullcontext(), graph_ms),
                            (eager_loop(), eager_ms)):
            with loop:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = run_paged(*stored, **kw, **runners,
                                  use_pallas=solver.use_pallas)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            eager_ok = eager_ok and again.n_iter == res.n_iter and \
                torch.equal(again.f, res.f) and torch.equal(again.g, res.g)
        # the plain operators on the same host state; a bf16 run's float32
        # rows round to the bf16 values its stores hold
        p = run_paged(*args, **kw, use_pallas=False)
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
    traces = run["traces"] + (getattr(solver, "traces", 0),)
    ok = eager_ok and (not hasattr(solver, "traces") or traces == (1, 1, 1))
    log(f"  {method} {precision} re-solves alone from the same states: graph "
        f"loop {' '.join(f'{t:.3f}' for t in graph_ms)} ms, eager host loop "
        f"{' '.join(f'{t:.3f}' for t in eager_ms)} ms; n_iter and "
        f"potentials bit-identical {eager_ok}; traces after warmup, traffic "
        f"and these re-solves {traces} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{method} {precision} graph loop")
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
    for label, loop in (("graph loop", contextlib.nullcontext()),
                        ("eager host loop", eager_loop())):
        gx, ax = stream_mutation(np, rng, live_ids["x"], "x", label)
        gy, ay = stream_mutation(np, rng, live_ids["y"], "y", label)
        with loop:
            profile_call(torch, f"streaming update {method} {precision} "
                         f"({label})",
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
# Phase 8: the families path
# ---------------------------------------------------------------------------

FAM_SIGMA = 1.5                 # arc-cosine anchors 1.5 N(0, I): r = 1024 ->
                                # r + 1 = 1025 features, off the 16-byte paths
FAM_SMALL, FAM_SMALL_R = 256, 127   # r + 1 = 128 at the trainer's batch: the
                                # log megakernel admits it in bf16 only
FAM_ORACLE_N = 2048             # the dense log_quadratic oracle's n = m
FAM_ORACLE_TOL = 1e-5
FAM_SCALING_EPS = 0.5           # method="factored" on the arc-cosine kernel
NYS_RANK = 1024
NYS_EPS = (0.5, 0.02)           # converges; the reference's failure regime
NYS_COST_RTOL = 1e-4            # card against the CPU on the same landmarks:
                                # cuSOLVER's eigh against LAPACK's, both f32;
                                # 3.85e-06 read on the H100, so ~25x margin
GRID_SIDE, GRID_ORACLE_SIDE, GRID_EPS = 128, 64, 0.1
GRID_COST_RTOL = 1e-5
ACC_EPS = 0.5
ACC_MAX_ITER, ACC_CHECK = 20000, 10
ACC_RTOL, ACC_ATOL = 2e-3, 1e-4     # tests/test_extensions.py:26-34
BARY_N, BARY_K, BARY_EPS = 4096, 3, 0.5
FAMILY_PATH_KERNELS = ("log_feature_contract", "log_halfstep",
                       "log_sinkhorn_block")


def family_inputs(np):
    """The families path's data, numpy from seeds: phase 4's clouds (seed
    0) with arc-cosine anchors; positive-orthant clouds at n = 256 with one
    anchor in the negative orthant (a feature column 0 on both sides); the
    clouds scaled into the unit ball (benchmarks/bench_tradeoff.py's
    Nystrom problem); blob weights on the grids; three blob histograms on
    n = 4096 points of the clouds."""
    rng = np.random.default_rng(80)
    x, y = clouds(np, 0)
    anchors = (FAM_SIGMA * rng.standard_normal((R_ANCHORS, D))).astype(
        np.float32)
    xs = np.abs(rng.standard_normal((FAM_SMALL, D)) + 1.0).astype(np.float32)
    ys = (np.abs(math.sqrt(0.1) * rng.standard_normal((FAM_SMALL, D)))
          + 0.05).astype(np.float32)
    us = (FAM_SIGMA * rng.standard_normal((FAM_SMALL_R, D))).astype(
        np.float32)
    us[0] = -FAM_SIGMA
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))

    def blobs(side, c1, c2):
        g = np.stack(np.meshgrid(*[np.linspace(0, 1, side)] * 2,
                                 indexing="ij"), -1)
        out = []
        for c, w in ((c1, 0.02), (c2, 0.05)):
            h = np.exp(-np.sum((g - np.asarray(c)) ** 2, -1) / w) + 1e-3
            out.append((h / h.sum()).reshape(-1).astype(np.float32))
        return out

    pts = x[:BARY_N]
    centers = (np.full(D, 1.0), np.full(D, 0.0), np.r_[np.full(D // 2, 2.0),
                                                       np.zeros(D - D // 2)])
    hists = []
    for c in centers:
        z = -np.sum((pts - c) ** 2, 1) / 2.0
        h = np.exp(z - z.max())
        hists.append(h / h.sum())
    return dict(x=x, y=y, anchors=anchors, xs=xs, ys=ys, us=us, R=R,
                grid=blobs(GRID_SIDE, (0.3, 0.3), (0.7, 0.6)),
                grid_small=blobs(GRID_ORACLE_SIDE, (0.3, 0.3), (0.7, 0.6)),
                hists=np.stack(hists).astype(np.float32))


def arccos_problem(torch, x, y, anchors, eps, device):
    """A user's arc-cosine request: the clouds and anchors as tensors."""
    from repro_torch.core import ArcCosinePointCloud, OTProblem

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return OTProblem.from_geometry(ArcCosinePointCloud(
        t(x), t(y), t(anchors), eps=eps, sigma=FAM_SIGMA), device=device)


def log_step_ms(torch, geom, precision="highest"):
    """Device time of one iteration of the log plan on ``geom`` in its
    order (three log half-steps, two log contracts), and of one log
    contract and one log half-step on its x factor alone, CUDA events."""
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep
    from repro_torch.kernels.ops import geometry_ops

    plan = geometry_ops(geom, mode="log", precision=precision)
    n, m = geom.shape
    a = torch.full((n,), 1.0 / n, device=geom.device)
    b = torch.full((m,), 1.0 / m, device=geom.device)
    step, init = plan.make_step(a, b)
    carry = init(torch.zeros_like(a), torch.zeros_like(b))
    lxi = plan.features[0]
    s = torch.zeros((n, 1), device=geom.device)
    t = log_feature_contract(lxi, s)
    loga = torch.log(a)[:, None].contiguous()
    return (time_ms(torch, lambda: step(carry)),
            time_ms(torch, lambda: log_feature_contract(lxi, s)),
            time_ms(torch, lambda: log_halfstep(lxi, t, loga,
                                                scale=geom.eps)))


def solve_line(res, wall):
    it = res.n_iter
    return (f"cost={float(res.cost):.7f} n_iter={it} "
            f"converged={bool(res.converged)} diverged={bool(res.diverged)} "
            f"err={float(res.marginal_err):.3e} wall={wall * 1e3:.3f} ms "
            f"({wall / max(it, 1) * 1e3:.4f} ms/iteration)")


def run_families_path(torch, np, device):
    """The counted run of phase 8: every family's requests through the
    entry points, with the launch counters set to 0 just before and read
    just after. Each arc-cosine solve must launch its plan's kernels (the
    log megakernel at n = 256 in bf16, and not in float32)."""
    from repro_torch.core import (
        OTProblem,
        barycenter_log_factored,
        gaussian_log_features,
        sinkhorn_divergence_geometry,
        solve,
    )
    from repro_torch.examples import sphere_barycenter
    from repro_torch.kernels import launch_counts, reset_launch_counts

    inp = family_inputs(np)
    x, y, u = inp["x"], inp["y"], inp["anchors"]
    probs = {
        "arc": arccos_problem(torch, x, y, u, EPS, device),
        "arc_scaling": arccos_problem(torch, x, y, u, FAM_SCALING_EPS,
                                      device),
        "arc_small": arccos_problem(torch, inp["xs"], inp["ys"], inp["us"],
                                    EPS, device),
    }
    ga, _ = anchors_for(torch, np, R_ANCHORS, D, EPS, inp["R"], 81, "cpu")
    probs["gauss_2k"] = OTProblem.from_point_clouds(
        x[:FAM_ORACLE_N], y[:FAM_ORACLE_N], ga.numpy(), eps=EPS)
    R = inp["R"]
    gu, _ = anchors_for(torch, np, R_ANCHORS, D, EPS, 1.0, 82, "cpu")
    probs["unit"] = {e: OTProblem.from_point_clouds(x / R, y / R, gu.numpy(),
                                                    eps=e) for e in NYS_EPS}
    axes = {side: [np.linspace(0, 1, side).astype(np.float32)] * 2
            for side in (GRID_SIDE, GRID_ORACLE_SIDE)}
    probs["grid"] = OTProblem.from_grid(axes[GRID_SIDE], a=inp["grid"][0],
                                        b=inp["grid"][1], eps=GRID_EPS)
    probs["grid_small"] = OTProblem.from_grid(
        axes[GRID_ORACLE_SIDE], a=inp["grid_small"][0],
        b=inp["grid_small"][1], eps=GRID_EPS)
    ua, qa = anchors_for(torch, np, R_ANCHORS, D, ACC_EPS, R, 83, "cpu")
    probs["gauss_acc"] = OTProblem.from_point_clouds(x, y, ua.numpy(),
                                                     eps=ACC_EPS, R=R)
    torch.cuda.synchronize()

    clear_runners()
    out, failures = {}, []
    reset_launch_counts()

    def timed(label, fn, need=(), refuse=()):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = counts_delta(before, launch_counts())
        shown = {k: v for k, v in delta.items() if v}
        line = solve_line(res, wall) if hasattr(res, "cost") else \
            f"wall={wall * 1e3:.3f} ms"
        log(f"  {label}: {line}  launches={shown}")
        missing = [k for k in need if delta[k] <= 0]
        extra = [k for k in refuse if delta[k] != 0]
        if missing or extra:
            failures.append(f"{label}: never launched {missing}, launched "
                            f"{extra}")
        out[label] = (res, wall, delta)
        return res

    logk = ("log_feature_contract", "log_halfstep")
    timed("arccos f32", lambda: solve(probs["arc"], tol=TOL), need=logk)
    timed("arccos bf16", lambda: solve(probs["arc"], tol=TOL,
                                       precision="bf16"), need=logk)
    timed(f"arccos factored eps={FAM_SCALING_EPS}",
          lambda: solve(probs["arc_scaling"], method="factored", tol=TOL),
          need=("feature_contract", "sinkhorn_halfstep", "feature_matvec"))
    timed(f"arccos n={FAM_SMALL} bf16",
          lambda: solve(probs["arc_small"], tol=TOL, precision="bf16"),
          need=("log_sinkhorn_block",))
    timed(f"arccos n={FAM_SMALL} f32",
          lambda: solve(probs["arc_small"], tol=TOL), need=logk,
          refuse=("log_sinkhorn_block",))
    timed(f"arccos n={FAM_ORACLE_N} (rank=, key=)",
          lambda: solve(probs["gauss_2k"], method="arccos", rank=R_ANCHORS,
                        key=torch.Generator().manual_seed(81),
                        tol=FAM_ORACLE_TOL), need=logk)
    xg = probs["arc"].geometry.x.clone().requires_grad_(True)

    def divergence():
        geom = dataclasses.replace(probs["arc"].geometry, x=xg)
        val = sinkhorn_divergence_geometry(geom, tol=TOL)
        (grad,) = torch.autograd.grad(val, [xg])
        return val.detach(), grad

    timed("arccos divergence + grad", divergence, need=logk)
    for e in NYS_EPS:
        timed(f"nystrom eps={e} (rank=, key=)",
              lambda e=e: solve(probs["unit"][e], method="nystrom",
                                rank=NYS_RANK,
                                key=torch.Generator().manual_seed(90),
                                tol=TOL))
    timed(f"grid {GRID_SIDE}x{GRID_SIDE}",
          lambda: solve(probs["grid"], tol=TOL))
    timed(f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE}",
          lambda: solve(probs["grid_small"], tol=TOL))
    timed("accelerated", lambda: solve(
        probs["gauss_acc"], method="accelerated", tol=TOL,
        max_iter=ACC_MAX_ITER, check_every=ACC_CHECK))
    timed("gaussian log_factored eps=0.5",
          lambda: solve(probs["gauss_acc"], tol=TOL),
          need=("gaussian_feature_map",) + logk)
    timed("sphere barycenter",
          lambda: sphere_barycenter.main(["--device", str(device)]))
    pts = torch.as_tensor(x[:BARY_N], device=device)
    lxi = gaussian_log_features(pts, ua.to(device), eps=BARY_EPS, q=qa)
    hists = torch.as_tensor(inp["hists"], device=device)
    timed(f"barycenter n={BARY_N} k={BARY_K}",
          lambda: barycenter_log_factored(lxi, hists, eps=BARY_EPS,
                                          tol=1e-6, max_iter=500))
    counts = launch_counts()
    missing = [k for k in FAMILY_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return inp, probs, out, counts, failures


def held(label, ok, detail):
    log(f"  {label}: {detail} {'ok' if ok else 'FAIL'}")
    return [] if ok else [label]


def hold_solve(torch, label, k, p):
    """A fused solve against the plain operators: cost 1e-4 relative,
    |d n_iter| <= 1, both potentials within 1e-4 of max |value|."""
    rel = abs(float(k.cost) - float(p.cost)) / abs(float(p.cost))
    ef, okf = compare(torch, k.f, p.f, rel_to_max=COST_RTOL)
    eg, okg = compare(torch, k.g, p.g, rel_to_max=COST_RTOL)
    ok = (rel <= COST_RTOL and abs(k.n_iter - p.n_iter) <= 1 and okf and okg
          and math.isfinite(float(k.cost)))
    return held(label, ok, f"kernel cost={float(k.cost):.7f} n_iter="
                f"{k.n_iter}, plain cost={float(p.cost):.7f} n_iter="
                f"{p.n_iter}, rel_diff={rel:.3e}, f err {ef:.3e}, g err "
                f"{eg:.3e}")


def compare_families(torch, np, device, inp, probs, out):
    """Phase 8's checks, after the counted run."""
    from repro_torch.core import (
        ArcCosineFeatureMap,
        ArcCosinePointCloud,
        NystromLowRank,
        OTProblem,
        sinkhorn_divergence_geometry,
        solve,
    )

    failures = []
    res = {k: v[0] for k, v in out.items()}
    for label, kw in (("arccos f32", {}),
                      ("arccos bf16", {"precision": "bf16"})):
        p = solve(probs["arc"], tol=TOL, use_pallas=False, **kw)
        failures += hold_solve(torch, f"{label} against the plain operators",
                               res[label], p)
    label = f"arccos factored eps={FAM_SCALING_EPS}"
    p = solve(probs["arc_scaling"], method="factored", tol=TOL,
              use_pallas=False)
    failures += hold_solve(torch, f"{label} against the plain operators",
                           res[label], p)
    for label, kw in ((f"arccos n={FAM_SMALL} bf16",
                       {"precision": "bf16", "inner_steps": 8}),
                      (f"arccos n={FAM_SMALL} f32", {})):
        # the plain operators at the megakernel's cadence (8 iterations a
        # check) where it ran
        p = solve(probs["arc_small"], tol=TOL, use_pallas=False, **kw)
        failures += hold_solve(torch, f"{label} against the plain operators",
                               res[label], p)
    xi = probs["arc_small"].geometry.features()[0][:, :-1]
    dead = int(torch.all(xi == 0, dim=0).sum())
    failures += held(f"arccos n={FAM_SMALL} dead anchor columns", dead >= 1,
                     f"{dead} all-zero feature columns (log -inf)")
    big = probs["arc"].geometry.features()[0][:, :-1]
    log(f"  arccos n={N}: {float((big == 0).float().mean()):.3f} of the "
        f"rectified features are 0, {int(torch.all(big == 0, 0).sum())} "
        "columns all 0")
    g2 = probs["gauss_2k"].geometry
    anchors = ArcCosineFeatureMap(r=R_ANCHORS, d=D).init(
        torch.Generator().manual_seed(81), device=device)
    arc2k = ArcCosinePointCloud(g2.x, g2.y, anchors, eps=EPS)
    oracle = solve(OTProblem.from_cost(arc2k.cost_matrix(), eps=EPS),
                   method="log_quadratic", tol=FAM_ORACLE_TOL, max_iter=5000)
    k = res[f"arccos n={FAM_ORACLE_N} (rank=, key=)"]
    rel = abs(float(k.cost) - float(oracle.cost)) / abs(float(oracle.cost))
    failures += held(f"arccos n={FAM_ORACLE_N} against the dense oracle",
                     rel <= COST_RTOL and bool(k.converged)
                     and bool(oracle.converged),
                     f"cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                     f"log_quadratic cost={float(oracle.cost):.7f} n_iter="
                     f"{oracle.n_iter}, rel_diff={rel:.3e}")
    val, grad = res["arccos divergence + grad"]
    xg = probs["arc"].geometry.x.clone().requires_grad_(True)
    pval = sinkhorn_divergence_geometry(
        dataclasses.replace(probs["arc"].geometry, x=xg), tol=TOL,
        use_pallas=False)
    (pgrad,) = torch.autograd.grad(pval, [xg])
    pval = pval.detach()
    gerr, gok = compare(torch, grad, pgrad, rel_to_max=GRAD_REL_TOL)
    dv = abs(float(val) - float(pval))
    scale = abs(float(res["arccos f32"].cost))
    failures += held("arccos divergence against the plain operators",
                     gok and dv <= COST_RTOL * scale
                     and bool(torch.isfinite(grad).all()),
                     f"value {float(val):.7f} / {float(pval):.7f}, grad err "
                     f"{gerr:.3e} (max |grad| {float(pgrad.abs().max()):.3e})")
    x, y, R = inp["x"], inp["y"], inp["R"]
    for e in NYS_EPS:
        k = res[f"nystrom eps={e} (rank=, key=)"]
        cpu_geom = NystromLowRank.from_point_clouds(
            torch.as_tensor(x / R), torch.as_tensor(y / R), eps=e,
            rank=NYS_RANK, generator=torch.Generator().manual_seed(90))
        c = solve(OTProblem.from_geometry(cpu_geom, device="cpu"), tol=TOL)
        if e == NYS_EPS[0]:
            rel = abs(float(k.cost) - float(c.cost)) / abs(float(c.cost))
            ok = (bool(k.converged) and not bool(k.diverged)
                  and rel <= NYS_COST_RTOL)
            detail = (f"card cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                      f"CPU cost={float(c.cost):.7f} n_iter={c.n_iter}, "
                      f"rel_diff={rel:.3e}")
        else:
            ok = bool(k.diverged) == bool(c.diverged) \
                and not bool(k.converged)
            detail = (f"card diverged={bool(k.diverged)} converged="
                      f"{bool(k.converged)} n_iter={k.n_iter}, CPU "
                      f"diverged={bool(c.diverged)} n_iter={c.n_iter} (the "
                      "flag reports it, no exception)")
        failures += held(f"nystrom eps={e} against the CPU, same landmarks",
                         ok, detail)
    a, b = inp["grid"]
    k = res[f"grid {GRID_SIDE}x{GRID_SIDE}"]
    axes = [np.linspace(0, 1, GRID_SIDE).astype(np.float32)] * 2
    c = solve(OTProblem.from_grid(axes, a=a, b=b, eps=GRID_EPS,
                                  device="cpu"), tol=TOL)
    rel = abs(float(k.cost) - float(c.cost)) / abs(float(c.cost))
    failures += held(f"grid {GRID_SIDE}x{GRID_SIDE} against the CPU",
                     rel <= GRID_COST_RTOL and abs(k.n_iter - c.n_iter) <= 1,
                     f"card cost={float(k.cost):.7f} n_iter={k.n_iter}, CPU "
                     f"cost={float(c.cost):.7f} n_iter={c.n_iter}, "
                     f"rel_diff={rel:.3e}")
    gs = probs["grid_small"]
    k = res[f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE}"]
    oracle = solve(OTProblem.from_cost(gs.geometry.cost_matrix(), gs.a, gs.b,
                                       eps=GRID_EPS),
                   method="log_quadratic", tol=TOL)
    rel = abs(float(k.cost) - float(oracle.cost)) / abs(float(oracle.cost))
    failures += held(f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE} against "
                     "the dense oracle", rel <= GRID_COST_RTOL,
                     f"cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                     f"log_quadratic cost={float(oracle.cost):.7f} n_iter="
                     f"{oracle.n_iter}, rel_diff={rel:.3e}")
    acc, lf = res["accelerated"], res["gaussian log_factored eps=0.5"]
    diff = abs(float(acc.cost) - float(lf.cost))
    failures += held("accelerated against log_factored",
                     bool(acc.converged)
                     and diff <= ACC_RTOL * abs(float(lf.cost)) + ACC_ATOL,
                     f"accelerated cost={float(acc.cost):.7f} n_iter="
                     f"{acc.n_iter} (converged={bool(acc.converged)}), "
                     f"log_factored cost={float(lf.cost):.7f} n_iter="
                     f"{lf.n_iter}, |diff|={diff:.3e}")
    sph = res["sphere barycenter"]
    failures += held("sphere barycenter", sph["angle"] < 25.0,
                     f"peak {sph['angle']:.2f} deg from the octant centre")
    bary = res[f"barycenter n={BARY_N} k={BARY_K}"]
    w = bary.weights
    ok = bool(torch.isfinite(w).all()) and bool((w >= 0).all()) and \
        abs(float(w.sum()) - 1.0) <= 1e-5
    failures += held(f"barycenter n={BARY_N} k={BARY_K}", ok,
                     f"n_iter={bary.n_iter} err={float(bary.err):.3e} "
                     f"converged={bool(bary.converged)} sum={float(w.sum()):.7f}"
                     f" min={float(w.min()):.3e}")
    return failures


def time_families(torch, probs, out):
    """One line a family: ms an iteration and ms a solve (from the counted
    run), the arc-cosine log solve's busy share (profiler), and one log
    iteration of the arc-cosine plan (r + 1 = 1025) beside the Gaussian
    one (r = 1024) on the same clouds (CUDA events)."""
    from repro_torch.core import solve

    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    gauss = probs["gauss_acc"].geometry
    arc = probs["arc"].geometry
    steps = {(name, prec): log_step_ms(torch, g, prec)
             for name, g in (("arccos", arc), ("gaussian", gauss))
             for prec in ("highest", "bf16")}
    share = profile_call(torch, f"arccos log solve n={N} r+1={R_ANCHORS + 1}",
                         lambda: solve(probs["arc"], tol=TOL))

    def warm(fn):
        """Wall of a second call of a solve (its runner captured)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    warm_runs = {
        "arccos f32": warm(lambda: solve(probs["arc"], tol=TOL)),
        "arccos bf16": warm(lambda: solve(probs["arc"], tol=TOL,
                                          precision="bf16")),
        "gaussian": warm(lambda: solve(probs["gauss_acc"], tol=TOL)),
    }
    gres, gwall = warm_runs["gaussian"]
    gline = (f"Gaussian r={R_ANCHORS} log_factored (eps 0.5, warm) "
             f"{gwall / gres.n_iter * 1e3:.4f} ms/iteration, "
             f"{gwall * 1e3:.3f} ms a solve ({gres.n_iter} iterations)")

    def per(label):
        r, wall = warm_runs[label] if label in warm_runs else out[label][:2]
        it = getattr(r, "n_iter", 0) or 1
        return (f"{wall / it * 1e3:.4f} ms/iteration, {wall * 1e3:.3f} ms a "
                f"solve ({it} iterations{', warm' * (label in warm_runs)})")

    for prec in ("highest", "bf16"):
        (a, ac, ah), (g, gc, gh) = steps[("arccos", prec)], \
            steps[("gaussian", prec)]
        label = "arccos f32" if prec == "highest" else "arccos bf16"
        log(f"  family {label}: {per(label)}; one log plan iteration "
            f"r+1={R_ANCHORS + 1} {a:.4f} ms against Gaussian r={R_ANCHORS}"
            f" {g:.4f} ms ({a / g:.3f}x; log contract {ac:.4f} / {gc:.4f}, "
            f"log half-step {ah:.4f} / {gh:.4f}); {gline}; busy share "
            f"{'not measured' if share is None else f'{share:.3f}'}")
    for label in (f"arccos factored eps={FAM_SCALING_EPS}",
                  f"arccos n={FAM_SMALL} bf16", f"arccos n={FAM_SMALL} f32",
                  f"nystrom eps={NYS_EPS[0]} (rank=, key=)",
                  f"grid {GRID_SIDE}x{GRID_SIDE}", "accelerated",
                  f"barycenter n={BARY_N} k={BARY_K}"):
        log(f"  family {label}: {per(label)}; {gline}")
    wall = out["sphere barycenter"][1]
    log(f"  family sphere barycenter (200 IBP steps, r=3): "
        f"{wall * 1e3:.3f} ms a solve, {wall / 200 * 1e3:.4f} ms/iteration;"
        f" {gline}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phases 3 and 9: the batched engine (P problems on a leading axis)
# ---------------------------------------------------------------------------


def batch_features(torch, np, P, n, r, seed, device):
    """bench_batch's stacked features: U(0.05, 1) from a numpy seed, (P,
    n, r) float32 on the card."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.05, 1.0, (P, n, r)).astype(
        np.float32), device=device)


def time_batched_kernels(torch, np, device):
    """Phase 3 for the four kernels with a problem axis at the batched
    engine's shape (P = 32, n = 1024, r = 256, B = 1), float32 and bf16:
    each wrapper on the stacked (P, n, r) factor beside its plain batched
    twin, the one PyTorch call computing the same function
    (``torch.bmm``, ``marg / torch.bmm``, ``torch.logsumexp``), and the
    same work as P launches of the 2-D kernel, one a problem. A stacked
    factor is 32 MiB in float32, inside the 50 MB L2, so each call is
    timed cold (cycling through copies past 100 MB; the bound counts
    device-memory bytes) and warm. Returns the float32 rows by kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    P, n, r, B = BATCH_P, BATCH_N, BATCH_R, 1
    rows = {}
    g = torch.Generator(device=device).manual_seed(23)
    u = torch.rand((P, n, B), generator=g, device=device)
    t = torch.rand((P, r, B), generator=g, device=device)
    s = torch.randn((P, n, B), generator=g, device=device)
    lt = torch.randn((P, r, B), generator=g, device=device)
    marg = torch.full((P, n, B), 1.0 / n, device=device)
    lmarg = torch.log(marg)
    xi32 = batch_features(torch, np, P, n, r, 5, device)
    for dtype in (torch.float32, torch.bfloat16):
        fb = torch.finfo(dtype).bits // 8
        ncopy = max(2, math.ceil(100e6 / (fb * P * n * r)))
        copies = [xi32.to(dtype, copy=True) for _ in range(ncopy)]
        logs = [torch.log(c.float()).to(dtype) for c in copies]
        tag = "f32" if dtype == torch.float32 else "bf16"
        fac = fb * P * n * r
        vec_in, vec_out = 4.0 * P * n * B, 4.0 * P * r * B
        cases = (
            ("feature_contract", copies,
             lambda x: feature_contract(x, u),
             lambda x: ref.feature_contract_ref(x, u),
             lambda x: torch.bmm(x.float().mT, u),
             lambda x, i: feature_contract(x[i], u[i]),
             fac + vec_in + vec_out, 2.0 * P * n * r * B),
            ("sinkhorn_halfstep", copies,
             lambda x: sinkhorn_halfstep(x, t, marg),
             lambda x: ref.sinkhorn_halfstep_ref(x, t, marg),
             lambda x: marg / torch.bmm(x.float(), t),
             lambda x, i: sinkhorn_halfstep(x[i], t[i], marg[i]),
             fac + vec_out + 2 * vec_in, 2.0 * P * n * r * B + P * n * B),
            ("feature_matvec", copies,
             lambda x: feature_matvec(x, t),
             lambda x: ref.feature_matvec_ref(x, t),
             lambda x: torch.bmm(x.float(), t),
             lambda x, i: feature_matvec(x[i], t[i]),
             fac + vec_out + vec_in, 2.0 * P * n * r * B),
            ("log_feature_contract", logs,
             lambda x: log_feature_contract(x, s),
             lambda x: ref.log_feature_contract_ref(x, s),
             lambda x: torch.logsumexp(x.float() + s, dim=1),
             lambda x, i: log_feature_contract(x[i], s[i]),
             fac + vec_in + vec_out, 2.0 * P * n * r * B),
            ("log_halfstep", logs,
             lambda x: log_halfstep(x, lt, lmarg, scale=BATCH_EPS),
             lambda x: ref.log_halfstep_ref(x, lt, lmarg, scale=BATCH_EPS),
             lambda x: BATCH_EPS * (lmarg[..., 0] - torch.logsumexp(
                 x.float() + lt.mT, dim=2)),
             lambda x, i: log_halfstep(x[i], lt[i], lmarg[i],
                                       scale=BATCH_EPS),
             fac + vec_out + 2 * vec_in, 2.0 * P * n * r * B),
        )
        for name, xs, kernel, plain, library, one, nbytes, flops in cases:
            cold = [time_ms(torch, cycling(fn, xs))
                    for fn in (kernel, plain, library)]
            warm = time_ms(torch, lambda: kernel(xs[0]))

            def looped(x):
                for i in range(P):
                    one(x, i)

            loop_ms = time_ms(torch, cycling(looped, xs), per_batch=2)
            b_ms, b_by = bound(nbytes, flops)
            row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                       bound_ms=b_ms, bound_by=b_by, warm_ms=warm,
                       looped_ms=loop_ms, shape=f"P={P} n={n} r={r} {tag}")
            if tag == "f32":
                rows[name] = row
            log(f"  {name:22s} batched {tag} P={P} n={n} r={r}: kernel "
                f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain "
                f"{cold[1]:.4f} ms  library {cold[2]:.4f} ms  bound "
                f"{b_ms:.5f} ms ({b_by})  kernel/bound {cold[0] / b_ms:.2f}"
                f"  {P} 2-D launches {loop_ms:.4f} ms")
        del copies, logs
    return rows


BATCH_SUPPORTS = (300, 700, 1024, 1500, 2048)   # the ragged solve_many list
BATCH_CLOUD_EPS = 0.1
BATCH_ITERS = 50                # bench_batch's fixed iteration count
BATCH_PATH_KERNELS = ("gaussian_feature_map", "feature_contract",
                      "sinkhorn_halfstep", "feature_matvec",
                      "log_feature_contract", "log_halfstep")
BATCH_RUNS = (("factored", "highest"), ("factored", "bf16"),
              ("log_factored", "highest"), ("log_factored", "bf16"))


def batch_inputs(torch, np, device):
    """Phase 9's inputs: the stacked features (P = 32, n = m = 1024, r =
    256) and their logs, uniform weights; 32 pairs of ``gaussian_clouds``
    (1024 points, d = 2, seeds 0-31) and r = 256 shared Lemma-1 anchors at
    eps 0.1; the ragged list's features (U(0.05, 1), n = m = each of
    ``BATCH_SUPPORTS``, r = 256)."""
    from repro_torch.core import GaussianFeatureMap, data_radius
    from repro_torch.data import gaussian_clouds

    P, n, r = BATCH_P, BATCH_N, BATCH_R
    xi = batch_features(torch, np, P, n, r, 0, device)
    zeta = batch_features(torch, np, P, n, r, 1, device)
    w = torch.full((P, n), 1.0 / n, device=device)
    pairs = [gaussian_clouds(i, n, 2, device=device) for i in range(P)]
    x = torch.stack([p[0] for p in pairs])
    y = torch.stack([p[1] for p in pairs])
    R = math.ceil(float(data_radius(x, y)) * 2.0) / 2.0
    fm = GaussianFeatureMap(r=r, d=2, eps=BATCH_CLOUD_EPS, R=R)
    anchors = fm.init(torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(2)
    ragged = [tuple(torch.as_tensor(rng.uniform(0.05, 1.0, (k, r)).astype(
        np.float32), device=device) for _ in range(2))
        for k in BATCH_SUPPORTS]
    return dict(xi=xi, zeta=zeta, lxi=torch.log(xi), lzeta=torch.log(zeta),
                w=w, x=x, y=y, R=R, anchors=anchors, ragged=ragged)


def batch_engine(method, precision, **kw):
    from repro_torch.core import BatchedSinkhorn
    args = dict(eps=BATCH_EPS, method=method, tol=TOL, max_iter=2000,
                precision=precision)
    args.update(kw)
    return BatchedSinkhorn(**args)


def stacked_args(inp, method):
    ka, kb = ((inp["xi"], inp["zeta"]) if method == "factored"
              else (inp["lxi"], inp["lzeta"]))
    return ka, kb, inp["w"], inp["w"]


def run_batched_path(torch, np, device):
    """The counted run of phase 9, with the launch counters set to 0 just
    before and read just after: ``solve_stacked`` at P = 32, n = m = 1024,
    r = 256, eps 0.5 for ``factored`` and ``log_factored`` in float32 and
    bf16 (each twice: the second solve must capture nothing), 32 cloud
    pairs through ``solve_point_clouds`` annealed to eps 0.1 (twice), the
    ragged ``solve_many`` (twice) and the quickstart."""
    from repro_torch.core import EpsSchedule, solve_many
    from repro_torch.core.api import OTProblem
    from repro_torch.examples import quickstart
    from repro_torch.kernels import launch_counts, reset_launch_counts

    inp = batch_inputs(torch, np, device)
    ragged = [OTProblem.from_features(a_, b_, eps=BATCH_EPS, device=device)
              for a_, b_ in inp["ragged"]]
    engines = {run: batch_engine(*run) for run in BATCH_RUNS}
    cloud_engine = batch_engine(
        "log_factored", "highest", eps=BATCH_CLOUD_EPS,
        schedule=EpsSchedule(eps_init=0.8, decay=0.4))
    out, failures = {}, []
    torch.cuda.synchronize()
    reset_launch_counts()
    for run, eng in engines.items():
        args = stacked_args(inp, run[0])
        for k in range(2):
            c0 = eng.runners.captures
            t0 = time.perf_counter()
            res = eng.solve_stacked(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            new = eng.runners.captures - c0
            if k and new:
                failures.append(f"{run} captured {new} after warmup")
        out[run] = res
        log(f"  solve_stacked {run[0]} {run[1]} P={BATCH_P} n=m={BATCH_N} "
            f"r={BATCH_R}: n_iter {res.n_iter.min().item()}-"
            f"{res.n_iter.max().item()}, cost {float(res.cost.min()):.6f}-"
            f"{float(res.cost.max()):.6f}, second solve {wall * 1e3:.2f} ms "
            f"({wall * 1e3 / int(res.n_iter.max()):.4f} ms an iteration), "
            f"runners {eng.runners.stats()}")
    for k in range(2):
        c0 = cloud_engine.runners.captures
        t0 = time.perf_counter()
        res = cloud_engine.solve_point_clouds(inp["x"], inp["y"],
                                              inp["anchors"], R=inp["R"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if k and cloud_engine.runners.captures != c0:
            failures.append("point clouds captured after warmup")
    out["clouds"] = res
    log(f"  solve_point_clouds P={BATCH_P} n=m={BATCH_N} d=2 r={BATCH_R} "
        f"EpsSchedule(0.8, 0.4) -> eps {BATCH_CLOUD_EPS}: n_iter "
        f"{res.n_iter.min().item()}-{res.n_iter.max().item()}, second "
        f"solve {wall * 1e3:.2f} ms, runners {cloud_engine.runners.stats()}")
    for k in range(2):
        t0 = time.perf_counter()
        res = solve_many(ragged, method="factored", tol=TOL, max_iter=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["ragged"] = res
    log(f"  solve_many supports {BATCH_SUPPORTS}: n_iter "
        f"{[r_.n_iter for r_ in res]}, second call {wall * 1e3:.2f} ms")
    t0 = time.perf_counter()
    out["quickstart"] = quickstart.main([])
    torch.cuda.synchronize()
    log(f"  quickstart (n=4000, r=500, its five steps): "
        f"{time.perf_counter() - t0:.2f} s")
    counts = launch_counts()
    missing = [k for k in BATCH_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return inp, ragged, engines, cloud_engine, out, counts, failures


def lane_check(label, got, want, i, failures, n_tol=1):
    """One lane against its yardstick: cost COST_RTOL relative, |d n_iter|
    <= ``n_tol``."""
    rel = abs(float(got.cost[i]) - float(want.cost)) / abs(float(want.cost))
    dn = abs(int(got.n_iter[i]) - int(want.n_iter))
    if not (rel <= COST_RTOL and dn <= n_tol):
        failures.append(f"{label} lane {i}: rel {rel:.2e}, d n_iter {dn}")
    return rel, dn


def compare_batched_path(torch, np, device, inp, ragged, engines,
                         cloud_engine, out):
    """Each lane of phase 9's counted run against its own single solve
    (``solve(SolveSpec)``, the same method and policy) and against the
    ``use_pallas=False`` engine: cost 1e-4 relative, |d n_iter| <= 1, the
    check cadence of both (every iteration: the megakernels refuse these
    shapes). Then the launches a replay of the P = 1 and the P = 32 cell
    (equal), and times at bench_batch's fixed 50 iterations."""
    from repro_torch.core import EpsSchedule, ExecutionPolicy, SolveSpec, solve
    from repro_torch.core.api import OTProblem

    failures = []
    for run, eng in engines.items():
        method, precision = run
        ka, kb, a, b = stacked_args(inp, method)
        res = out[run]
        worst = [0.0, 0]
        pol = ExecutionPolicy(precision=precision)
        t0 = time.perf_counter()
        singles = []
        for i in range(BATCH_P):
            maker = (OTProblem.from_features if method == "factored"
                     else OTProblem.from_log_features)
            prob = maker(ka[i], kb[i], eps=BATCH_EPS, device=device)
            singles.append(solve(SolveSpec.from_problem(
                prob, method=method, tol=TOL, max_iter=2000, policy=pol)))
        torch.cuda.synchronize()
        loop_wall = time.perf_counter() - t0
        plain = batch_engine(method, precision,
                             use_pallas=False).solve_stacked(ka, kb, a, b)
        for i in range(BATCH_P):
            for label, want in (("single", singles[i]),
                                ("plain", unpad_lane(plain, i))):
                rel, dn = lane_check(f"{run} {label}", res, want, i,
                                     failures)
                worst = [max(worst[0], rel), max(worst[1], dn)]
        log(f"  {run[0]} {run[1]}: {BATCH_P} lanes against their single "
            f"solves and use_pallas=False: worst cost rel {worst[0]:.2e}, "
            f"worst |d n_iter| {worst[1]} (32 single solves {loop_wall:.3f}"
            " s)")
    res = out["clouds"]
    worst = [0.0, 0]
    sched = EpsSchedule(eps_init=0.8, decay=0.4)
    stages = len(sched.stages(BATCH_CLOUD_EPS))
    plain = batch_engine("log_factored", "highest", eps=BATCH_CLOUD_EPS,
                         schedule=sched, use_pallas=False).solve_point_clouds(
        inp["x"], inp["y"], inp["anchors"], R=inp["R"])
    for i in range(BATCH_P):
        prob = OTProblem.from_point_clouds(inp["x"][i], inp["y"][i],
                                           inp["anchors"],
                                           eps=BATCH_CLOUD_EPS, R=inp["R"],
                                           device=device)
        single = solve(SolveSpec.from_problem(
            prob, method="log_factored", tol=TOL, max_iter=2000,
            schedule=sched))
        for label, want in (("single", single), ("plain",
                                                 unpad_lane(plain, i))):
            rel, dn = lane_check(f"clouds {label}", res, want, i, failures,
                                 n_tol=stages)
            worst = [max(worst[0], rel), max(worst[1], dn)]
    log(f"  point clouds: {BATCH_P} lanes against their single annealed "
        f"solves and use_pallas=False: worst cost rel {worst[0]:.2e}, "
        f"worst |d n_iter| {worst[1]} (within 1 a stage, {stages} stages)")
    for k, (p, got) in enumerate(zip(ragged, out["ragged"])):
        want = solve(SolveSpec.from_problem(p, method="factored", tol=TOL,
                                            max_iter=2000))
        rel = abs(float(got.cost) - float(want.cost)) / abs(float(want.cost))
        dn = abs(got.n_iter - want.n_iter)
        ok = rel <= COST_RTOL and dn <= 1 and got.f.shape == p.a.shape
        log(f"  solve_many n=m={BATCH_SUPPORTS[k]}: cost rel {rel:.2e}, "
            f"d n_iter {dn} against its single solve {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ragged n={BATCH_SUPPORTS[k]}")
    qs = out["quickstart"]
    ok = (abs(qs["factored"] - qs["exact"]) < 0.05 * abs(qs["exact"])
          and qs["after_step"] < qs["divergence"]
          and bool(torch.isfinite(qs["batch_costs"]).all()))
    log(f"  quickstart: exact {qs['exact']:.5f}, factored "
        f"{qs['factored']:.5f}, cold {qs['cold_iters']} / annealed "
        f"{qs['annealed_iters']} iterations, divergence "
        f"{qs['divergence']:.5f} -> {qs['after_step']:.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("quickstart")
    failures += launches_per_replay(torch, inp, engines)
    failures += time_batched_engine(torch, device, inp)
    return failures


def unpad_lane(res, i):
    from repro_torch.core.api import unpad_result
    return unpad_result(res, i, res.f.shape[1], res.g.shape[1])


def launches_per_replay(torch, inp, engines):
    """The launches a replay of the P = 1 cell and of the P = 32 cell make
    (K = 8 iterations a replay, one per-iteration step each): equal for
    each method, the problems riding on the kernels' leading axis."""
    failures = []
    for run, eng in engines.items():
        if run[1] != "highest":
            continue
        ka, kb, a, b = stacked_args(inp, run[0])
        eng.solve_stacked(ka[:1], kb[:1], a[:1], b[:1])
        per = {key.P: r_.per_replay for key, r_ in
               ((k, eng.runners._runners[k]) for k in eng.runners.keys())}
        same = per.get(1) == per.get(BATCH_P) and per.get(1)
        log(f"  {run[0]}: launches a replay (8 iterations) at P=1 "
            f"{per.get(1)} and at P={BATCH_P} {per.get(BATCH_P)} "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{run[0]} launches a replay differ")
    return failures


def graph_replay(torch, fn):
    """``fn`` captured in a CUDA graph after one eager call: its replay,
    so that CUDA events time the device work and not the host's
    launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def time_batched_engine(torch, device, inp):
    """bench_batch's comparison on the card: P = 32 problems at a fixed 50
    iterations (tol 0), through one ``solve_stacked`` against a loop of 32
    single solves (each its own replays and reads), host clock ending in a
    sync, best of 3 after a warm-up, each lane's cost held against its
    single solve's (1e-4 relative); and one iteration's device time (CUDA
    events over a captured graph) of the stacked plan's step against 32
    steps of the single-problem plan. Returns the failures."""
    from repro_torch.core import ExecutionPolicy, SolveSpec, solve
    from repro_torch.core.api import OTProblem
    from repro_torch.kernels import ops

    failures = []
    calibrate_sleep(torch)
    for method in ("factored", "log_factored"):
        ka, kb, a, b = stacked_args(inp, method)
        eng = batch_engine(method, "highest", tol=0.0, max_iter=BATCH_ITERS)
        maker = (OTProblem.from_features if method == "factored"
                 else OTProblem.from_log_features)
        probs = [maker(ka[i], kb[i], eps=BATCH_EPS, device=device)
                 for i in range(BATCH_P)]
        specs = [SolveSpec.from_problem(p, method=method, tol=0.0,
                                        max_iter=BATCH_ITERS,
                                        policy=ExecutionPolicy())
                 for p in probs]

        got, singles_res = {}, {}

        def batched():
            got["res"] = eng.solve_stacked(ka, kb, a, b)
            torch.cuda.synchronize()

        def looped():
            singles_res["res"] = [solve(s_) for s_ in specs]
            torch.cuda.synchronize()

        walls = {}
        for name, fn in (("batched", batched), ("loop", looped)):
            fn()
            best = math.inf
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            walls[name] = best
        mode = "scaling" if method == "factored" else "log"
        kind = method
        spec = ({"kind": kind, "xi": ka, "zeta": kb} if mode == "scaling"
                else {"kind": kind, "log_xi": ka, "log_zeta": kb})
        plan = ops.stacked_ops(spec, problems=BATCH_P, eps=BATCH_EPS,
                               mode=mode)
        res = got["res"]
        worst = 0.0
        for i, one in enumerate(singles_res["res"]):
            rel = abs(float(res.cost[i]) - float(one.cost)) / abs(
                float(one.cost))
            worst = max(worst, rel)
            if rel > COST_RTOL or int(res.n_iter[i]) != one.n_iter:
                failures.append(f"{method} {BATCH_ITERS} iterations lane {i}"
                                f": rel {rel:.2e}")
        step, init = plan.make_step(a, b)
        c0 = init(torch.ones_like(a) if mode == "scaling"
                  else torch.zeros_like(a), torch.ones_like(b))
        step_ms = time_ms(torch, graph_replay(torch, lambda: step(c0)))
        singles = []
        for i in range(BATCH_P):
            p1 = ops.geometry_ops(probs[i].geometry, mode=mode)
            s1, i1 = p1.make_step(a[i], b[i])
            singles.append((s1, i1(*(t_[i] for t_ in c0[:2]))))

        def loop_steps():
            for s1, c1 in singles:
                s1(c1)

        loop_ms = time_ms(torch, graph_replay(torch, loop_steps),
                          per_batch=4)
        log(f"  batched {method} P={BATCH_P} n=m={BATCH_N} r={BATCH_R} "
            f"{BATCH_ITERS} iterations: one solve_stacked "
            f"{walls['batched'] * 1e3:.2f} ms, a loop of {BATCH_P} single "
            f"solves {walls['loop'] * 1e3:.2f} ms, loop/batched "
            f"{walls['loop'] / walls['batched']:.2f} (lanes against their "
            f"single solves: worst cost rel {worst:.2e}, n_iter equal); one "
            f"iteration (device, CUDA events on a captured graph) "
            f"{step_ms:.4f} ms stacked, {loop_ms:.4f} ms as {BATCH_P} "
            f"single steps ({loop_ms / step_ms:.2f}x)")
    return failures


# ---------------------------------------------------------------------------
# Phase 10: the serving front end
# ---------------------------------------------------------------------------

SERVE_TRACE = dict(n_requests=400, eps=0.5, r=256,
                   size_classes=((1024, 1024), (2048, 1536), (512, 700)),
                   pool_size=32, repeat_frac=0.6, near_frac=0.3, seed=0)
SERVE_TOL = 1e-6                # the reference's serving tol
SERVE_MAX_BATCH = 16
SERVE_BUCKETS = (1, 2, 4, 8, 16)    # ot_batch_bucket up to SERVE_MAX_BATCH
SERVE_SIDES = (512, 1024, 2048)     # the cells' padded supports
SERVE_MAX_WAIT = 0.004
SERVE_WINDOW = 64               # requests a closed-loop client keeps in flight
SERVE_METHODS = ("log_factored", "factored")
SERVE_EXACT_RTOL = 1e-5         # an exact repeat against its cold solve
SERVE_POT_TOL = 1e-4            # a cold lane's f, g: of max |value|
SERVE_WARM_SAVES = ("log_factored",)   # warm iterations below cold
SERVE_LANES = (("--strict", "--rank", "256"), ("--stream", "--strict"),
               ("--chaos", "--strict", "--rank", "256"))
SERVE_PATH_KERNELS = ("feature_contract", "sinkhorn_halfstep",
                      "feature_matvec", "log_feature_contract",
                      "log_halfstep")


def closed_loop(svc, problems, window=SERVE_WINDOW):
    """A client that keeps ``window`` requests in flight: submit them,
    drain, repeat (``OTService.solve_many`` a window at a time). Returns the
    tickets and the wall (host clock; every drain ends in its loops' last
    host read and the results' read)."""
    tickets = []
    t0 = time.perf_counter()
    for k in range(0, len(problems), window):
        part = [svc.submit(p) for p in problems[k:k + window]]
        svc.drain()
        tickets += part
    return tickets, time.perf_counter() - t0


def busy_share(torch, fn):
    """Device busy share of ``fn()`` under torch.profiler (the kernel rows'
    device time over the wall, both under the profiler); None where the
    profiler saw no device time. Returns ``(share, wall, top rows)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(torch, prof)
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    share = device_us / 1e6 / wall if device_us > 0 else None
    return share, wall, top


def potentials_err(torch, got, want, shift=False):
    """Worst of f and g of ``got`` against ``want`` (both unpadded CPU
    results), over max |value| of ``want``; inf where their dead (-inf)
    atoms differ. ``shift`` first takes out the constant (f + c, g - c)
    that leaves a solution's cost and plan unchanged (a warm start may
    land on another one)."""
    diffs = []
    pairs = [(x.cpu(), w.cpu()) for x, w in ((got.f, want.f),
                                              (got.g, want.g))]
    for x, w in pairs:
        live = torch.isfinite(w)
        if not torch.equal(live, torch.isfinite(x)):
            return math.inf
        diffs.append(x[live].double() - w[live].double())
    if shift:
        c = float(diffs[0].median())
        diffs = [diffs[0] - c, diffs[1] + c]
    scale = max(float(w[torch.isfinite(w)].abs().max()) for _, w in pairs)
    return max(float(d.abs().max()) for d in diffs) / max(scale, 1.0)


def percentiles_ms(np, latencies):
    lat = np.asarray(latencies, np.float64) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def serve_method(torch, np, method, trace, device):
    """One method's serving run (see the module doc, phase 10): warmup,
    the closed loop with warm starts, again without (same runners), again
    under the profiler (a fresh warm cache, same runners), the open loop
    at half the closed loop's rate, and bench_serve's sequential cold
    baseline; then its gates. Returns the failures."""
    from repro_torch.core import runners as core_runners
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import OTService, run_open_loop, traffic_cells
    from repro_torch.serving.service import HOST_SPLIT
    from repro_torch.serving.traffic import Request, TrafficSpec

    failures = []
    problems = [req.problem for req in trace]
    n_req = len(problems)

    def service(**kw):
        return OTService(eps=SERVE_TRACE["eps"], method=method,
                         tol=SERVE_TOL, max_batch=SERVE_MAX_BATCH,
                         max_wait=SERVE_MAX_WAIT, device=device, **kw)

    svc = service()
    engine = svc.engine
    cells = traffic_cells(trace, engine)
    t0 = time.perf_counter()
    built = svc.warmup(cells)
    torch.cuda.synchronize()
    log(f"  serve {method}: warmup {built} runners over {len(cells)} cells "
        f"{[(c.n_pad, c.m_pad, c.r) for c in cells]} in "
        f"{time.perf_counter() - t0:.2f} s")
    loops0 = svc.runners.loop_stats()
    engine0 = engine.runners.captures
    global0 = core_runners.RUNNERS.captures

    # -- closed loop, warm starts on --------------------------------------
    s0, c0 = svc.stats(), launch_counts()
    warm_t, wall = closed_loop(svc, problems)
    s1, c1, loops1 = svc.stats(), launch_counts(), svc.runners.loop_stats()
    batches = s1["batches"] - s0["batches"]
    launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    rps = n_req / wall
    p50, p99 = percentiles_ms(np, [t.latency for t in warm_t])
    w = s1["warm"]
    converged = sum(bool(t.result.converged) for t in warm_t if t.result)
    log(f"  serve {method} closed loop ({SERVE_WINDOW} in flight, warm "
        f"starts on): {n_req} requests in {wall:.3f} s = {rps:.1f} rps, "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms, {batches} dispatches, mean "
        f"batch {n_req / batches:.2f}; warm hits exact {w['exact_hits']} "
        f"near {w['near_hits']} miss {w['misses']} (hit rate "
        f"{w['hit_rate']:.3f}); mean iterations warm "
        f"{s1['mean_iters_warm']:.2f} cold {s1['mean_iters_cold']:.2f}; "
        f"converged {converged}/{n_req} at tol {SERVE_TOL}")
    log(f"  serve {method} per dispatch: kernel launches "
        f"{sum(launches.values()) / batches:.2f} ({launches}), loop "
        f"replays {(loops1['replays'] - loops0['replays']) / batches:.2f}, "
        f"loop host reads {(loops1['reads'] - loops0['reads']) / batches:.2f}"
        f" (+1 read of the results a dispatch, +2 reads a request: its "
        f"weights and its fingerprint)")
    split = {k: (s1["host_s"][k] - s0["host_s"][k]) / n_req * 1e3
             for k in HOST_SPLIT}
    log(f"  serve {method} host ms a request: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
        + f"; sum {sum(split.values()):.3f} of {wall / n_req * 1e3:.3f}")

    # -- closed loop, warm starts off, the same runners --------------------
    cold = service(warm_starts=False)
    cold.runners = svc.runners
    cold_t, cold_wall = closed_loop(cold, problems)
    cs = cold.stats()
    cp50, cp99 = percentiles_ms(np, [t.latency for t in cold_t])
    csplit = sum(cs["host_s"].values()) / n_req * 1e3
    log(f"  serve {method} closed loop, warm starts off: "
        f"{n_req / cold_wall:.1f} rps, p50 {cp50:.2f} ms p99 {cp99:.2f} ms, "
        f"mean batch "
        f"{cs['mean_batch']:.2f}, mean iterations {cs['mean_iters_cold']:.2f}"
        f", host {csplit:.3f} ms a request (fingerprint "
        f"{cs['host_s']['fingerprint'] / n_req * 1e3:.3f})")

    # -- the closed loop under the profiler --------------------------------
    prof = service()
    prof.runners = svc.runners
    share, pwall, top = busy_share(torch, lambda: closed_loop(prof, problems))
    if share is None:
        log(f"  serve {method} closed loop busy share: not measured (the "
            "profiler saw no device time)")
    else:
        log(f"  serve {method} closed loop under the profiler: wall "
            f"{pwall:.3f} s, device busy share {share:.3f} (idle "
            f"{1 - share:.3f})")
        for e in top:
            log(f"    {e.key[:60]:60s} {e.count:6d} calls "
                f"{e.self_device_time_total / 1e3:9.3f} ms")

    # -- open loop at half the closed loop's rate --------------------------
    rate = rps / 2
    stretch = TrafficSpec(**SERVE_TRACE).rate_hz / rate
    open_trace = [Request(r.t_offset * stretch, r.problem, r.kind)
                  for r in trace]
    o0 = svc.stats()
    report = run_open_loop(svc, open_trace)
    o1 = svc.stats()
    ob = o1["batches"] - o0["batches"]
    log(f"  serve {method} open loop at {rate:.1f} rps offered: "
        f"{report.completed}/{n_req} served in {report.duration_s:.3f} s = "
        f"{report.rps:.1f} rps, p50 {report.p50_ms:.2f} ms p99 "
        f"{report.p99_ms:.2f} ms (from the scheduled arrival), mean batch "
        f"{(o1['served'] - o0['served']) / max(ob, 1):.2f}")

    # -- sequential cold baseline: engine.solve_many([p]) a request --------
    engine_served = engine.runners.captures
    firsts = {}
    for p, c in zip(problems, (engine.batch_shape(*engine.kernel_data(p))
                               for p in problems)):
        firsts.setdefault(c, p)
    for p in firsts.values():                   # the untimed pass
        engine.solve_many([p])
    torch.cuda.synchronize()
    e1 = engine.runners.captures
    seq, seq_lat = [], []
    t0 = time.perf_counter()
    for p in problems:
        t1 = time.perf_counter()
        seq.append(engine.solve_many([p])[0])
        seq_lat.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    e2 = engine.runners.captures
    seq_rps = n_req / seq_wall
    sp50, sp99 = percentiles_ms(np, seq_lat)
    log(f"  serve {method} sequential cold (engine.solve_many([p]) a "
        f"request): {seq_rps:.1f} rps, p50 {sp50:.2f} ms p99 {sp99:.2f} "
        f"ms (a request's own solve, ending in its loop's host read); "
        f"serve speedup (closed loop over "
        f"sequential) {rps / seq_rps:.3f}, without warm starts "
        f"{n_req / cold_wall / seq_rps:.3f}")

    # -- gates --------------------------------------------------------------
    for label, tickets in (("closed", warm_t), ("no-warm", cold_t)):
        undone = sum(not t.done or t.result is None for t in tickets)
        if undone:
            failures.append(f"{method} {label}: {undone} tickets not served")
            continue
        worst = worst_exact = pot = 0.0
        d_iter = 0
        for t, s_ in zip(tickets, seq):
            rel = abs(float(t.result.cost) - float(s_.cost)) / abs(
                float(s_.cost))
            worst = max(worst, rel)
            if t.warm_exact:
                worst_exact = max(worst_exact, rel)
            # a cold lane starts where its sequential solve starts; a
            # warm one is compared up to the constant (f + c, g - c)
            pot = max(pot, potentials_err(torch, t.result, s_,
                                          shift=t.warm_hit))
            if not t.warm_hit:
                d_iter = max(d_iter, abs(int(t.result.n_iter)
                                         - int(s_.n_iter)))
        log(f"  serve {method} {label}: worst cost rel to the sequential "
            f"cold solve {worst:.2e}, exact repeats {worst_exact:.2e}; "
            f"f, g {pot:.2e} of max |value| (warm lanes up to a "
            f"constant); cold lanes' max |d n_iter| {d_iter}")
        if worst > COST_RTOL or worst_exact > SERVE_EXACT_RTOL:
            failures.append(f"{method} {label}: cost rel {worst:.2e} "
                            f"(exact {worst_exact:.2e})")
        if label == "no-warm" and (pot > SERVE_POT_TOL or d_iter > 1):
            failures.append(f"{method} {label}: f, g {pot:.2e}, "
                            f"|d n_iter| {d_iter}")
    if report.completed != n_req:
        failures.append(f"{method} open loop served {report.completed}")
    # a warm lane's padded atoms start at 0, as the JAX package pads them:
    # in scaling space that is u = 1 there, which spoils the first K^T u,
    # so a warm `factored` start saves no iteration on a padded lane (the
    # reference's too) and only must not cost one
    saves = method in SERVE_WARM_SAVES
    if not (w["exact_hits"] and w["near_hits"]
            and (s1["mean_iters_warm"] < s1["mean_iters_cold"] if saves
                 else s1["mean_iters_warm"] <= s1["mean_iters_cold"])):
        failures.append(f"{method}: warm hits {w} and iterations "
                        f"{s1['mean_iters_warm']:.2f} warm, "
                        f"{s1['mean_iters_cold']:.2f} cold")
    snap = svc.runners.snapshot()
    captured = {
        "service runners": svc.runners.loop_stats()["captures"]
        - loops0["captures"],
        "service builds": snap["misses"] - built,
        "service extra_traces": snap["extra_traces"],
        "engine (service loops)": engine_served - engine0,
        "engine (timed sequential)": e2 - e1,
        "RUNNERS": core_runners.RUNNERS.captures - global0,
    }
    log(f"  serve {method} captures after warmup: {captured}")
    if any(captured.values()):
        failures.append(f"{method}: captures after warmup {captured}")
    return failures


def run_serving_path(torch, np, device):
    """Phase 10's counted run, with the launch counters set to 0 just
    before and read just after: both methods' serving runs over one trace
    at the card's width, then the ot_service driver's three lanes
    in-process."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ot_service
    from repro_torch.serving import TrafficSpec, make_traffic

    t0 = time.perf_counter()
    trace = make_traffic(TrafficSpec(**SERVE_TRACE), device=device)
    torch.cuda.synchronize()
    kinds = {k: sum(r.kind == k for r in trace)
             for k in ("fresh", "repeat", "near")}
    log(f"  trace: {len(trace)} requests {kinds} over "
        f"{SERVE_TRACE['pool_size']} pairs, made in "
        f"{time.perf_counter() - t0:.2f} s")
    failures = []
    reset_launch_counts()
    for method in SERVE_METHODS:
        failures += serve_method(torch, np, method, trace, device)
    for lane in SERVE_LANES:
        t0 = time.perf_counter()
        rc = ot_service.main(list(lane))
        log(f"  ot_service {' '.join(lane)}: rc {rc} in "
            f"{time.perf_counter() - t0:.2f} s")
        if rc != 0:
            failures.append(f"ot_service {' '.join(lane)} returned {rc}")
    counts = launch_counts()
    missing = [k for k in SERVE_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return counts, failures


# ---------------------------------------------------------------------------
# Phase 11: the autotuner and the sharded solves
# ---------------------------------------------------------------------------

TUNE_CACHE = Path(__file__).resolve().parent / "build" / "tuning" / \
    "tuning.json"
SHARD_DIV_N = 4096              # the divergence's supports (phase 6's n)
SHARD_TIMEOUT_S = 240           # a world's spawn, run and join
SHARD_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep", "feature_contract",
                      "sinkhorn_halfstep", "feature_matvec")


def tuner_keys(torch, np, device):
    """Phase 11(a)'s keys on real inputs: (label, kernel, extents, dtype,
    the wrapper's call, its plain version, the phase-2 tolerance)."""
    from repro_torch.kernels import kermatvec, logmatvec, ref
    from repro_torch.kernels.fused_loop import log_sinkhorn_block
    from repro_torch.kernels.kermatvec import (feature_contract,
                                               sinkhorn_halfstep)
    from repro_torch.kernels.logmatvec import (log_feature_contract,
                                               log_halfstep)

    g = torch.Generator(device=device).manual_seed(11)

    def rand(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=device) + lo

    keys = []
    for P, n, r in ((32, 1024, 256), (1, N, R_ANCHORS)):
        xi = rand(P, n, r, lo=0.05) if P > 1 else rand(n, r, lo=0.05)
        u = rand(*xi.shape[:-1], 1)
        keys.append((f"flat contract P={P} n={n} r={r} f32",
                     "feature_contract",
                     kermatvec._contract_extents(
                         xi, 1, kermatvec._flat_vectorized(xi, 1)),
                     xi.dtype, lambda xi=xi, u=u: feature_contract(xi, u),
                     lambda xi=xi, u=u: ref.feature_contract_ref(xi, u),
                     dict(rel_to_max=SCALING_REL_TOL)))
    xi = rand(N, R_ANCHORS, lo=0.05)
    t = rand(R_ANCHORS, 1) / R_ANCHORS
    marg = rand(N, 1, lo=0.5) / N
    keys.append((f"row kernel (half-step) n={N} r={R_ANCHORS} f32",
                 "feature_rows",
                 kermatvec._rows_extents(xi, 1, kermatvec._vectorized(xi, 1),
                                         True),
                 xi.dtype, lambda: sinkhorn_halfstep(xi, t, marg),
                 lambda: ref.sinkhorn_halfstep_ref(xi, t, marg),
                 dict(rel_to_max=SCALING_REL_TOL)))
    lw = -4.0 * rand(N, R_ANCHORS)
    s = -rand(N, 1)
    keys.append((f"log contract n={N} r={R_ANCHORS} f32", "log_contract",
                 logmatvec._contract_extents(lw, 1,
                                             logmatvec._vectorized(lw, 1)),
                 lw.dtype, lambda: log_feature_contract(lw, s),
                 lambda: ref.log_feature_contract_ref(lw, s),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    lt = -rand(R_ANCHORS, 1)
    lm = -rand(N, 1)
    keys.append((f"log half-step n={N} r={R_ANCHORS} f32", "log_halfstep",
                 logmatvec._halfstep_extents(lw, 1,
                                             logmatvec._vectorized(lw, 1)),
                 lw.dtype, lambda: log_halfstep(lw, lt, lm, scale=0.1),
                 lambda: ref.log_halfstep_ref(lw, lt, lm, scale=0.1),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    args = block_inputs(torch, np, GAN_BATCH, GAN_BATCH, 128, D, 0.5,
                        torch.bfloat16, 0, 7, device)
    keys.append((f"log megakernel n=m={GAN_BATCH} r=128 bf16 8 iterations",
                 "log_sinkhorn_block",
                 dict(n=GAN_BATCH, m=GAN_BATCH, r=128, esize=2),
                 torch.bfloat16,
                 lambda: log_sinkhorn_block(*args, inner_steps=8, eps=0.5),
                 lambda: ref.log_sinkhorn_block_ref(*args, inner_steps=8,
                                                    eps=0.5),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    return keys


def held_within(torch, got, want, tol):
    """``got`` against ``want`` (a tensor, or the megakernel's (f, g, t,
    err)) at ``tol``: (max abs error, ok)."""
    if isinstance(got, tuple):
        worst, ok = 0.0, True
        for x, y in zip(got[:3], want[:3]):
            err, good = compare(torch, x, y, **tol)
            worst, ok = max(worst, err), ok and good
        e, w = float(got[3]), float(want[3])
        return worst, ok and abs(e - w) <= 1e-4 * abs(w) + 1e-6
    return compare(torch, got, want, **tol)


def same_bits(torch, x, y):
    if isinstance(x, tuple):
        return all(torch.equal(a, b) for a, b in zip(x, y))
    return torch.equal(x, y)


def run_tuner(torch, np, device):
    """Phase 11(a): tune the keys into a fresh cache with tuning on; hold
    every candidate against the plain version (reruns bit-identical); time
    the static plan and the winner; resolve again from the file alone
    (zero trials); with tuning off every plan is static and the flat
    contract's digest is unchanged."""
    from repro_torch.kernels import autotune

    failures = []
    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    digest0 = flat_contract_digest(torch, device)
    keys = tuner_keys(torch, np, device)
    TUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    TUNE_CACHE.unlink(missing_ok=True)
    autotune.clear_cache()
    winners = {}
    with autotune.tuning(cache_path=str(TUNE_CACHE)):
        for label, kernel, ext, dtype, call, plain, tol in keys:
            static = autotune.static_plan(kernel, ext)
            cands = autotune.candidates(kernel, ext)
            want = plain()
            for cand in cands:
                with autotune.pinned(kernel, **cand):
                    got, again = call(), call()
                torch.cuda.synchronize()
                err, ok = held_within(torch, got, want, tol)
                same = same_bits(torch, got, again)
                if not (ok and same):
                    failures.append(f"{label} {cand}: err {err:.3e} "
                                    f"repeat identical {same}")
            autotune.reset_stats()
            t0 = time.perf_counter()
            win = autotune.resolve(kernel, ext, dtype, device)
            tune_s = time.perf_counter() - t0
            trials = autotune.stats()["trials"]
            winners[label] = win
            times = {}
            for name, knobs in (("static", static), ("winner", win)):
                with autotune.pinned(kernel, **knobs):
                    times[name] = time_ms(torch, call)
            log(f"  tune {label}: candidates {list(cands)}; static {static}"
                f" {times['static']:.4f} ms, winner {win} "
                f"{times['winner']:.4f} ms (winner/static "
                f"{times['winner'] / times['static']:.3f}); {trials} trials "
                f"in {tune_s:.2f} s; every candidate within its phase-2 "
                f"tolerance, reruns bit-identical")
            if len(cands) > 1 and trials != len(cands):
                failures.append(f"{label}: {trials} trials for "
                                f"{len(cands)} candidates")
        autotune.clear_cache()
        autotune.reset_stats()
        again = {label: autotune.resolve(kernel, ext, dtype, device)
                 for label, kernel, ext, dtype, *_ in keys}
        warm = autotune.stats()
    log(f"  warm cache ({TUNE_CACHE.name}, {len(keys)} keys): {warm}")
    if warm["trials"] or warm["disk_hits"] != len(keys) or again != winners:
        failures.append(f"warm cache: {warm}, plans equal "
                        f"{again == winners}")
    autotune.reset_stats()
    static_ok = all(autotune.resolve(kernel, ext, dtype, device)
                    == autotune.static_plan(kernel, ext)
                    for _, kernel, ext, dtype, *_ in keys)
    digest1 = flat_contract_digest(torch, device)
    log(f"  tuning off: every plan static {static_ok}, trials "
        f"{autotune.stats()['trials']}; flat contract digest unchanged "
        f"{digest1 == digest0}")
    if not static_ok or digest1 != digest0 or autotune.stats()["trials"]:
        failures.append("tuning off: plans or digest changed")
    return failures


def shard_inputs(torch, np, device):
    """Phase 11(b)'s requests, built alike in every process: phase 4's
    annealed request, phase 6's feature problem (r = 1024, eps 0.5) and
    the divergence's clouds (the first 4096 points of phase 4's, r = 1024
    anchors, eps 0.5)."""
    from repro_torch.core import GaussianPointCloud, OTProblem
    main = build_problem(torch, np, 0, device)
    feats = OTProblem.from_features(
        explicit_features(np, N, R_ANCHORS, 2 * R_ANCHORS),
        explicit_features(np, M, R_ANCHORS, 2 * R_ANCHORS + 1),
        eps=SCALING_EPS)
    x, y = clouds(np, 0)
    x, y = x[:SHARD_DIV_N], y[:SHARD_DIV_N]
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    u, _ = anchors_for(torch, np, R_ANCHORS, D, SCALING_EPS, R, 0, "cpu")
    leaves = [torch.as_tensor(v, device=device) for v in (x, y, u.numpy())]
    return main, feats, leaves, R, GaussianPointCloud


def shard_requests(torch, np, device, mesh=None):
    """The three requests, on ``mesh`` or on one device: the annealed
    solve's result and stage iterations, the feature solve's, and the
    divergence with its gradients in x, y and the anchors. Returns
    (results, {name: (wall s, iterations)})."""
    from repro_torch.core import (EpsSchedule, sinkhorn_divergence_geometry,
                                  solve, solve_annealed)
    main, feats, leaves, R, cls = shard_inputs(torch, np, device)
    out, walls = {}, {}
    sync(torch)
    t0 = time.perf_counter()
    ann = solve_annealed(main, schedule=EpsSchedule(eps_init=1.0, decay=0.5),
                         tol=TOL, mesh=mesh)
    sync(torch)
    walls["main"] = (time.perf_counter() - t0, ann.result.n_iter)
    out["main"] = (ann.result, [int(k) for k in ann.stage_iters])
    t0 = time.perf_counter()
    res = solve(feats, tol=0.0, max_iter=SCALING_ITERS, mesh=mesh)
    sync(torch)
    walls["feats"] = (time.perf_counter() - t0, res.n_iter)
    out["feats"] = res
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    t0 = time.perf_counter()
    val = sinkhorn_divergence_geometry(
        cls.build(*leaves, eps=SCALING_EPS, R=R), tol=TOL, mesh=mesh)
    grads = torch.autograd.grad(val, leaves)
    sync(torch)
    walls["div"] = (time.perf_counter() - t0, 0)
    out["div"] = (val.detach(), grads)
    return out, walls


def sync(torch):
    """Wait for the card (a no-op in a CPU rehearsal)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _shard_rank(rank, world, backend, port, src, queue, device="cuda"):
    """One rank of a phase-11 world (a spawned process): join the world,
    run the three requests through the sharded front door with the launch
    counters set to 0 just before and read just after, time the
    collectives of an iteration, and send back what the parent holds."""
    import hashlib
    import traceback
    from datetime import timedelta

    try:
        sys.path.insert(0, src)
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels import backend as kbackend
        if device == "cuda":
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        else:
            device = torch.device(device)
        kbackend.DEFAULT_DEVICE = str(device)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        if backend == "gloo":
            # gloo must take CUDA tensors for MAX and for all-gather; where
            # it does not, the lane reports it and stops (the run is never
            # staged onto the host)
            try:
                t = torch.full((4,), float(rank), device=device)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                parts = [torch.empty(2, device=device) for _ in range(world)]
                dist.all_gather(parts, torch.full((2,), float(rank),
                                                  device=device))
                got = (float(t[0]), [float(p[0]) for p in parts])
            except RuntimeError as exc:
                got = f"{type(exc).__name__}: {exc}"
            if got != (world - 1.0, [float(r) for r in range(world)]):
                queue.put(dict(rank=rank, refused=str(got)))
                return
        from repro_torch.core import sharded
        from repro_torch.distributed import MeshAxis
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(world, device=device)
        plain = {"operators": 0, "log_operators": 0}
        for name in plain:
            orig = getattr(sharded._PsumOps, name)

            def counted(self, *a, _orig=orig, _name=name, **kw):
                plain[_name] += 1
                return _orig(self, *a, **kw)
            setattr(sharded._PsumOps, name, counted)
        shard_requests(torch, np, device, mesh)          # warm: builds, plans
        reset_launch_counts()
        plain.update(operators=0, log_operators=0)
        out, walls = shard_requests(torch, np, device, mesh)
        counts = launch_counts()
        # the envelope VJP's backward applies the log operator, three terms
        solve_plain = dict(plain, log_operators=plain["log_operators"] - 3)
        # the collectives of one iteration: log 2 (MAX, SUM) per combine x 2
        # and the error's SUM; scaling 2 r-vector SUMs and the error's
        axis = MeshAxis(mesh, "data")
        vec = torch.zeros((R_ANCHORS, 1), device=device)
        one = torch.zeros((), device=device)
        coll = {}
        for mode, ops in (("log", (axis.max_, axis.sum_, axis.max_,
                                   axis.sum_)),
                          ("scaling", (axis.sum_, axis.sum_))):
            reps = 200
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(reps):
                for op in ops:
                    op(vec)
                axis.sum_(one)
                float(one)          # the check block's host read
            sync(torch)
            coll[mode] = (time.perf_counter() - t0) / reps * 1e3
        (res, stages), fres = out["main"], out["feats"]
        val, grads = out["div"]
        arrays = [res.f, res.g, fres.f, fres.g, val, *grads]
        h = hashlib.sha256()
        for a in arrays:
            h.update(a.detach().cpu().numpy().tobytes())
        queue.put(dict(
            rank=rank, counts=counts, plain=solve_plain,
            walls=walls, coll=coll, digest=h.hexdigest(),
            main=(float(res.cost), stages, res.f.cpu().numpy()),
            feats=(float(fres.cost), fres.n_iter),
            div=(float(val), [g_.cpu().numpy() for g_ in grads])))
        dist.barrier(**({"device_ids": [0]} if backend == "nccl" else {}))
        dist.destroy_process_group()
    except Exception:
        queue.put(dict(rank=rank, error=traceback.format_exc()))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world, backend, src, device="cuda"):
    """Spawn a world of ``world`` ranks on card 0 and collect each rank's
    report, or the failure; every process is joined or killed."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, backend, port, str(src), q,
                               device))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, deadline = [], time.monotonic() + SHARD_TIMEOUT_S
    try:
        while len(reports) < world:
            try:
                rep = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    return None, f"{backend} world of {world} timed out"
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    return None, f"{backend} world: a rank exited {dead}"
                continue
            if "error" in rep:
                return None, (f"{backend} world rank {rep['rank']}:\n"
                              f"{rep['error']}")
            if "refused" in rep:
                return None, rep
            reports.append(rep)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return sorted(reports, key=lambda r: r["rank"]), None


def run_sharded_path(torch, np, device, src):
    """Phase 11(b): the single-process requests on the card (after a warm
    run, as each rank does), then an NCCL world of 1 and a gloo world of 2
    ranks on the same card, each held against them. Returns (rank 0's
    launch counts of the NCCL world, failures)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    failures = []
    shard_requests(torch, np, device)           # warm: captures, plans
    reset_launch_counts()
    want, walls = shard_requests(torch, np, device)
    single = launch_counts()
    (wres, wstages), wfeats = want["main"], want["feats"]
    wval, wgrads = want["div"]
    log(f"  one process: annealed cost={float(wres.cost):.7f} stages "
        f"{wstages} ({walls['main'][0] / wres.n_iter * 1e3:.4f} ms/iteration"
        f"); features cost={float(wfeats.cost):.7f} "
        f"({walls['feats'][0] / wfeats.n_iter * 1e3:.4f} ms/iteration); "
        f"divergence {float(wval):.7f} ({walls['div'][0]:.3f} s) "
        f"launches={single}")
    nccl_counts = None
    for backend, world in (("nccl", 1), ("gloo", 2)):
        t0 = time.perf_counter()
        reports, err = run_world(world, backend, src, device.type)
        secs = time.perf_counter() - t0
        if isinstance(err, dict):
            log(f"  gloo refuses CUDA tensors for MAX or all-gather "
                f"({err['refused']}): the gloo lane stops here, the NCCL "
                "lane stands")
            continue
        if err:
            failures.append(err)
            log(f"  {backend} world of {world}: FAILED\n{err}")
            continue
        r0 = reports[0]
        (cost, stages, f) = r0["main"]
        fcost, fiters = r0["feats"]
        val, grads = r0["div"]
        same = len({r["digest"] for r in reports}) == 1
        gerr = max(float(np.abs(g - w.cpu().numpy()).max()
                         / max(float(w.abs().max()), 1e-30))
                   for g, w in zip(grads, wgrads))
        fdiff = float(np.abs(f - wres.f.cpu().numpy()).max())
        ok = (abs(cost - float(wres.cost)) <= COST_RTOL * abs(float(wres.cost))
              and len(stages) == len(wstages)
              and all(abs(a - b) <= 1 for a, b in zip(stages, wstages))
              and abs(fcost - float(wfeats.cost))
              <= COST_RTOL * abs(float(wfeats.cost))
              and fiters == wfeats.n_iter
              and abs(val - float(wval)) <= COST_RTOL * abs(float(wval))
              and gerr <= GRAD_REL_TOL and same)
        for r in reports:
            c = r["counts"]
            missing = [k for k in SHARD_PATH_KERNELS if c[k] <= 0]
            mega = c["sinkhorn_block"] + c["log_sinkhorn_block"]
            plain_ops = sum(r["plain"].values())
            log(f"  {backend} rank {r['rank']}/{world}: launches {c}; plain "
                f"operators built in the solves {r['plain']}; megakernel "
                f"launches {mega}")
            if missing or mega or plain_ops:
                failures.append(f"{backend} rank {r['rank']}: kernels "
                                f"missing {missing}, megakernels {mega}, "
                                f"plain operators {r['plain']}")
        wm, wf = r0["walls"]["main"], r0["walls"]["feats"]
        ms_log = wm[0] / wm[1] * 1e3
        ms_sc = wf[0] / wf[1] * 1e3
        log(f"  {backend} world of {world} (card 0): annealed cost={cost:.7f} "
            f"(one process {float(wres.cost):.7f}) stages {stages} (one "
            f"process {wstages}) max |d f| {fdiff:.2e}; features "
            f"cost={fcost:.7f} n_iter {fiters}; divergence {val:.7f} "
            f"(one process {float(wval):.7f}), gradients within "
            f"{gerr:.2e} of max |grad|; every rank equal {same}; "
            f"{'ok' if ok else 'FAIL'}")
        log(f"  {backend} world of {world}: log {ms_log:.4f} ms/iteration, "
            f"its collectives {r0['coll']['log']:.4f} ms (share "
            f"{r0['coll']['log'] / ms_log:.3f}); scaling {ms_sc:.4f} "
            f"ms/iteration, collectives {r0['coll']['scaling']:.4f} ms "
            f"(share {r0['coll']['scaling'] / ms_sc:.3f}); divergence "
            f"{r0['walls']['div'][0]:.3f} s; the world {secs:.1f} s")
        if not ok:
            failures.append(f"{backend} world of {world} disagrees with the "
                            "single-process solves")
        if backend == "nccl":
            nccl_counts = r0["counts"]
    return nccl_counts, failures


SCALING_PATH_KERNELS = ("feature_contract", "sinkhorn_halfstep",
                        "feature_matvec", "sinkhorn_block")
TRAIN_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep", "log_sinkhorn_block")
SOLVE_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep")
STREAM_PATH_KERNELS = ("paged_feature_contract", "paged_halfstep",
                       "paged_feature_matvec", "log_feature_contract",
                       "log_halfstep")


ALL_PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (default: all; the "
                    "result lines need all eleven)")
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
            (20, 24, 1100, bf, 1.0, 1, 8),                  # r wider than the CTA
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, "rank", 8),  # a rank all dead
            (GAN_BATCH, 200, 128, bf, 1.3, "rank", 8),
            (3, 200, 24, f32, 1.0, 0, 8),                   # n < C
            (200, 3, 13, bf, 1.3, 0, 8),                    # m < C, odd r
            (1, 688, 128, bf, 1.0, 0, 8),                   # one xi row
            (352, 352, 128, bf, 1.0, 2, 8),                 # largest bf16
            (352, 352, 128, bf, 1.3, 0, 1),
            (353, 353, 128, bf, 1.0, 0, 8),                 # not admitted
            (176, 176, 128, f32, 1.3, 0, 8),                # largest f32
            (177, 177, 128, f32, 1.0, 0, 8),                # not admitted
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
            (20, 24, 1100, bf, 1.3, 1, 8),                  # r > 512 threads
            (GAN_BATCH, GAN_BATCH, 128, f32, 1.0, 0, 8),    # not admitted
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
            (GAN_BATCH, 200, 128, bf, 1.3, 5, 8),           # n != m
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, "rank", 8),  # a rank all dead
            (GAN_BATCH, 200, 128, bf, 1.3, "rank", 8),
            (3, 200, 24, f32, 1.0, 0, 8),                   # n < C
            (200, 3, 13, bf, 1.3, 2, 8),                    # m < C, odd r
            (1, 688, 128, bf, 1.0, 0, 8),                   # one xi row
            (37, 53, 13, bf, 1.3, 2, 5),
            (352, 352, 128, bf, 1.3, 2, 8),                 # largest bf16
            (352, 352, 128, bf, 1.0, 0, 1),
            (353, 353, 128, bf, 1.0, 0, 8),                 # not admitted
            (176, 176, 128, f32, 1.3, 3, 1),                # largest f32
            (177, 177, 128, f32, 1.0, 0, 8),                # not admitted
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
        time_halfstep_cold(torch, np, device)
        flat_contract_digest(torch, device)
        times.update(time_paged_kernels(torch, np, device))
        batched_rows = time_batched_kernels(torch, np, device)
        for name, row in batched_rows.items():
            times[name] = dict(times[name], batched=row)

    counts = {}
    if 4 in phases:
        log(f"== phase 4: main path (n=m={N}, d={D}, r={R_ANCHORS}, "
            f"eps={EPS}, tol={TOL}, EpsSchedule(eps_init=1.0, decay=0.5))")
        problems, results, div, c4, failures = run_main_path(torch, np,
                                                             device)
        log(f"  launches on the main path: {c4}")
        if failures:
            log(f"phase 4 FAILED: {failures}")
            return 1
        counts["solve"] = c4
        missing = [k for k in SOLVE_PATH_KERNELS if c4[k] <= 0]
        if missing:
            log(f"phase 4 FAILED: kernels never launched: {missing}")
            return 1
        profile_solve(torch, problems[0],
                      EpsSchedule(eps_init=1.0, decay=0.5))
        time_replay_blocks(torch, problems[0],
                           EpsSchedule(eps_init=1.0, decay=0.5))
        time_static_copies(torch, device)
        failures = compare_main_path(torch, problems, results, div,
                                     EpsSchedule)
        if failures:
            log(f"phase 4 FAILED: {failures}")
            return 1
        time_cache_pressure(torch, np, device, problems[0])

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
    if 8 in phases:
        log(f"== phase 8: families path (arc-cosine n=m={N}, r={R_ANCHORS} "
            f"-> {R_ANCHORS + 1} features, eps={EPS}, f32 and bf16, and at "
            f"n={FAM_SMALL}, r+1={FAM_SMALL_R + 1}; Nystrom rank {NYS_RANK} "
            f"at eps {NYS_EPS}; grid {GRID_SIDE}x{GRID_SIDE} eps={GRID_EPS};"
            f" accelerated at eps={ACC_EPS}; barycenters; tol={TOL})")
        t8 = time.perf_counter()
        inp, probs, out, c8, failures = run_families_path(torch, np, device)
        log(f"  launches on the families path: {c8}")
        counts["families"] = c8
        failures += compare_families(torch, np, device, inp, probs, out)
        time_families(torch, probs, out)
        log(f"  phase 8: {time.perf_counter() - t8:.1f} s")
        if failures:
            log(f"phase 8 FAILED: {failures}")
            return 1
    if 9 in phases:
        log(f"== phase 9: batched path (P={BATCH_P} problems of n=m="
            f"{BATCH_N}, r={BATCH_R}, eps={BATCH_EPS}, factored and "
            f"log_factored in f32 and bf16; {BATCH_P} cloud pairs annealed "
            f"to eps {BATCH_CLOUD_EPS}; solve_many over {BATCH_SUPPORTS}; "
            f"the quickstart; tol={TOL})")
        t9 = time.perf_counter()
        (inp, ragged, engines, cloud_engine, out, c9,
         failures) = run_batched_path(torch, np, device)
        log(f"  launches on the batched path: {c9}")
        counts["batched"] = c9
        failures += compare_batched_path(torch, np, device, inp, ragged,
                                         engines, cloud_engine, out)
        log(f"  phase 9: {time.perf_counter() - t9:.1f} s")
        if failures:
            log(f"phase 9 FAILED: {failures}")
            return 1
    if 10 in phases:
        log(f"== phase 10: serving path (trace of "
            f"{SERVE_TRACE['n_requests']} requests over "
            f"{SERVE_TRACE['pool_size']} pairs, r={SERVE_TRACE['r']}, "
            f"eps={SERVE_TRACE['eps']}, size classes "
            f"{SERVE_TRACE['size_classes']}; OTService {SERVE_METHODS}, "
            f"tol={SERVE_TOL}, max_batch={SERVE_MAX_BATCH}, max_wait="
            f"{SERVE_MAX_WAIT}; the ot_service lanes)")
        t10 = time.perf_counter()
        c10, failures = run_serving_path(torch, np, device)
        log(f"  launches on the serving path: {c10}")
        counts["serving"] = c10
        log(f"  phase 10: {time.perf_counter() - t10:.1f} s")
        if failures:
            log(f"phase 10 FAILED: {failures}")
            return 1
    if 11 in phases:
        log("== phase 11: the autotuner (a fresh cache under build/, tuning "
            "on: the flat contract, the row kernel, the log contract, the "
            "log half-step and the log megakernel) and the sharded solves "
            f"(an NCCL world of 1 and a gloo world of 2 on card 0: phase 4's"
            f" annealed request, phase 6's feature solve, the divergence "
            f"with gradients at n=m={SHARD_DIV_N})")
        t11 = time.perf_counter()
        failures = run_tuner(torch, np, device)
        c11, more = run_sharded_path(torch, np, device, src)
        failures += more
        if c11 is not None:
            counts["sharded"] = c11
        log(f"  phase 11: {time.perf_counter() - t11:.1f} s")
        if failures:
            log(f"phase 11 FAILED: {failures}")
            return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if phases != set(ALL_PHASES):
        log(f"phases {sorted(phases)} passed; no result line without all "
            "eleven")
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
