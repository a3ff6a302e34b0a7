"""Quickstart: linear-time Sinkhorn divergences through the unified API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
        [--device cuda|cpu] [--n 4000] [--r 500] [--small 500]
        [--batch 8] [--batch-n 256]

One entry point, ``repro_torch.core.solve``, reaches every solver:

    problem = OTProblem.from_point_clouds(x, y, anchors, eps=0.5)
    res = solve(problem, method="log_factored")

Walks the paper's pipeline end to end:

  1. sample two clouds and build a geometry problem (Lemma-1 features);
  2. solve with the factored O(r(n+m)) path and the exact dense oracle;
  3. solve a small-eps problem with and without annealing;
  4. solve a GAN-shaped minibatch of problems with the batched engine
     (one loop, every kernel launch serving the whole batch);
  5. differentiate the divergence with respect to the cloud (the envelope
     theorem: no backprop through the loop) and take one gradient step.

The defaults are the JAX example's sizes; ``--device cpu`` with smaller
``--n`` / ``--r`` / ``--small`` / ``--batch-n`` runs on the CPU.
Counterpart of ``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from ..core import (
    BatchedSinkhorn,
    EpsSchedule,
    GaussianFeatureMap,
    OTProblem,
    data_radius,
    sinkhorn_divergence_gaussian,
    solve,
    solve_annealed,
)
from ..data import gaussian_clouds
from ..kernels.backend import resolve_device

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the five steps; returns their numbers (costs, iteration counts,
    the batch's costs, the divergence before and after the step)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=4000, help="points a cloud")
    ap.add_argument("--r", type=int, default=500, help="Lemma-1 anchors")
    ap.add_argument("--small", type=int, default=500,
                    help="points a cloud of the small-eps problem")
    ap.add_argument("--batch", type=int, default=8,
                    help="problems of the batched step")
    ap.add_argument("--batch-n", type=int, default=256,
                    help="points a cloud of each batched problem")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, d, eps, r = args.n, 2, 0.5, args.r
    x, y = gaussian_clouds(0, n, d, device=device)
    R = float(data_radius(x, y))
    print(f"clouds: n={n}, d={d}, radius={R:.2f}, eps={eps}, r={r}, "
          f"device={device}")

    fm = GaussianFeatureMap(r=r, d=d, eps=eps, R=R)
    U = fm.init(torch.Generator().manual_seed(0)).to(device)
    problem = OTProblem.from_point_clouds(x, y, U, eps=eps, R=R,
                                          device=device)

    # --- exact (quadratic) reference through the same front end ---
    t0 = time.perf_counter()
    ref = solve(problem, method="log_quadratic", tol=1e-6, max_iter=5000)
    _sync(device)
    t_ref = time.perf_counter() - t0
    print(f"exact ROT   = {float(ref.cost):+.5f}   ({t_ref:.2f}s, "
          f"{int(ref.n_iter)} iters, O(n^2) per iter)")

    # --- linear-time positive features (method='auto' picks them) ---
    t0 = time.perf_counter()
    rf = solve(problem, tol=1e-6, max_iter=5000)
    _sync(device)
    t_rf = time.perf_counter() - t0
    off = abs(float(rf.cost - ref.cost) / float(ref.cost)) * 100
    print(f"RF ROT      = {float(rf.cost):+.5f}   ({t_rf:.2f}s, "
          f"{int(rf.n_iter)} iters, O(nr) per iter): {off:.2f}% off")

    # --- small eps: annealing cuts iterations ---
    k = min(args.small, n)
    small = OTProblem.from_point_clouds(x[:k], y[:k], U, eps=0.02, R=R,
                                        device=device)
    cold = solve(small, method="log_factored", tol=1e-4, max_iter=50000)
    ann = solve_annealed(small, method="log_factored", tol=1e-4,
                         max_iter=50000,
                         schedule=EpsSchedule(eps_init=0.8, decay=0.4))
    gap = abs(float(ann.result.cost - cold.cost))
    print(f"eps=0.02    : cold {int(cold.n_iter)} iters vs annealed "
          f"{int(ann.result.n_iter)} iters over {len(ann.stage_eps)} stages "
          f"(same cost to {gap:.1e})")

    # --- GAN-shaped minibatch: one batched engine call, B problems ---
    B, nb = args.batch, min(args.batch_n, n // args.batch)
    xs = x[: B * nb].reshape(B, nb, d)
    ys = y[: B * nb].reshape(B, nb, d)
    engine = BatchedSinkhorn(eps=eps, method="log_factored", tol=1e-6,
                             max_iter=2000)
    t0 = time.perf_counter()
    batch = engine.solve_point_clouds(xs, ys, U, R=R)
    _sync(device)
    t_b = time.perf_counter() - t0
    print(f"batched     : {B} problems of n={nb} in {t_b:.2f}s, costs "
          f"[{float(batch.cost.min()):+.4f}, {float(batch.cost.max()):+.4f}]")

    # --- differentiable Sinkhorn divergence (envelope theorem) ---
    def div_fn(x_):
        return sinkhorn_divergence_gaussian(x_, y, U, eps=eps, q=fm.q,
                                            tol=1e-6, max_iter=2000)

    xg = x.clone().requires_grad_(True)
    div = div_fn(xg)
    (g,) = torch.autograd.grad(div, [xg])
    div = div.detach()
    print(f"divergence  = {float(div):+.5f}; |grad wrt locations| = "
          f"{float(torch.linalg.norm(g)):.4f} "
          "(envelope theorem: no backprop through the loop)")
    with torch.no_grad():
        after = div_fn(x - 50.0 * g)
    print(f"after one gradient step: divergence = {float(after):+.5f}")
    return dict(exact=float(ref.cost), factored=float(rf.cost),
                cold_iters=int(cold.n_iter),
                annealed_iters=int(ann.result.n_iter),
                batch_costs=batch.cost.detach().cpu(),
                batch_iters=batch.n_iter.clone(), divergence=float(div),
                after_step=float(after), device=str(device))


if __name__ == "__main__":
    main()
