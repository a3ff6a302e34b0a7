#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (``nvcc``, in
   parallel);
2. each kernel against its plain PyTorch version on the card: at the main
   path's shape, at ragged shapes, and on inputs with ``-inf`` rows,
   columns and constants. Tolerances: the feature map within 1e-5 of
   max |value|; the two LSE kernels atol 1e-4 + rtol 1e-5 (summation
   order differs);
3. times (CUDA events, median of 21 batches of 10 launches, queued behind a
   device spin so that host overhead is not timed) of each kernel, its plain
   version and one PyTorch library call computing the same function,
   beside the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger);
4. the main path: three annealed ``solve()`` requests on Gaussian point
   clouds (N(1, I) against N(0, 0.1 I), n = m = 16384, d = 8, r = 1024,
   eps = 0.1, seeds 0, 1, 2, tol = 1e-4, well above the float32 noise floor
   of the marginal error at this n) and one ``sinkhorn_divergence_geometry``,
   with the launch counters set to 0 before and read after; each request
   is then rerun with ``use_pallas=False`` (the plain torch operators) and
   must agree: cost within 1e-4 relative, iterations within 1 per stage.

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
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


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


def check_kernels(torch, np, device, shapes, lse_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    errs = {k: 0.0 for k in KERNEL_INFO}
    failures = []

    def record(name, case, err, ok):
        errs[name] = max(errs[name], err) if math.isfinite(err) else err
        log(f"  {name:22s} {case:40s} max_abs_err={err:.3e} "
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
    return errs, failures


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


def profile_solve(torch, problem, schedule):
    """Device busy share of one solve request: the device time of every
    kernel the profiler saw over the request's wall time (both under the
    profiler, which slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solve

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve(problem, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    top = sorted(rows, key=lambda e: -getattr(e, "self_device_time_total", 0))
    log(f"  profiled solve seed=0: wall={wall:.4f} s n_iter={res.n_iter} "
        f"device kernel time={device_us / 1e3:.3f} ms")
    if device_us <= 0:
        log("  device busy share: not measured (the profiler saw no device "
            "time)")
        return
    log(f"  device busy share {device_us / 1e6 / wall:.3f} "
        f"(idle {1 - device_us / 1e6 / wall:.3f}) under the profiler")
    for e in top[:6]:
        log(f"    {e.key[:60]:60s} {e.count:6d} calls "
            f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:9.3f} ms")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}/repro_torch;"
              " run this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import EpsSchedule
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    log("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip() if smi.returncode == 0 else
        f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        report = Path(str(path) + ".log")
        if report.is_file():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    log("== phase 2: kernels against their plain versions")
    shapes = [(N, R_ANCHORS, D, EPS, False), (1001, 3, 5, 0.5, True),
              (777, 1000, 3, 0.1, True), (33, 70, 20, 1.0, False)]
    lse_shapes = [(N, M, R_ANCHORS, 1, False), (1001, 777, 3, 1, True),
                  (1001, 777, 1000, 3, True), (777, 1001, 1000, 1, False),
                  (1001, 777, 1000, 1, True), (5, 3, 129, 3, True),
                  (5, 3, 128, 1, True)]
    errs, failures = check_kernels(torch, np, device, shapes, lse_shapes)
    if failures:
        log(f"phase 2 FAILED: {failures}")
        return 1

    log("== phase 3: times at the main path's shape "
        f"(n={N}, r={R_ANCHORS}, d={D}, B=1)")
    calibrate_sleep(torch)
    log(f"  device spin ahead of each batch: {SLEEP_MS[0]:.3f} ms")
    times = time_kernels(torch, np, device)

    log(f"== phase 4: main path (n=m={N}, d={D}, r={R_ANCHORS}, eps={EPS}, "
        f"tol={TOL}, EpsSchedule(eps_init=1.0, decay=0.5))")
    problems, results, div, counts = run_main_path(torch, np, device)
    log(f"  launches on the main path: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        log(f"phase 4 FAILED: kernels never launched: {missing}")
        return 1
    profile_solve(torch, problems[0], EpsSchedule(eps_init=1.0, decay=0.5))
    failures = compare_main_path(torch, problems, results, div, EpsSchedule)
    if failures:
        log(f"phase 4 FAILED: {failures}")
        return 1

    kernels = []
    for name, info in KERNEL_INFO.items():
        kernels.append(dict(name=name, route="cuda", source=info["source"],
                            replaces=info["replaces"],
                            launches=counts[name], max_abs_err=errs[name],
                            **times[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
