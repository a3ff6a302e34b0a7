"""Paper Fig. 6 / Remark 1: Wasserstein barycenters on the positive sphere
with the cost c(x, y) = -log(x^T y).

    PYTHONPATH=src python -m repro_torch.examples.sphere_barycenter
        [--device cuda|cpu]

On the positive sphere the Gibbs kernel of this cost at eps = 1 is the
LINEAR kernel k(x, y) = x^T y: the positive feature map is the identity,
phi(x) = x, with r = 3 features, so a Sinkhorn iteration costs O(3n), the
most extreme instance of the paper's factorization.

The positive octant is discretized (50 x 50), three blurred corner
histograms are placed (the paper's a, b, c), and 200 iterative Bregman
projections [Benamou et al. '15] through the factored kernel, the k
histograms as one (k, n) batch, give their barycenter. A softmax
sharpening shows its mass between the corners, as in the paper's panel
(e): the peak must lie within 25 degrees of the octant's centre.
Counterpart of ``examples/sphere_barycenter.py``.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, Optional, Sequence

import torch

from ..kernels.backend import resolve_device
from ..kernels.ref import ieee_fp32

__all__ = ["positive_sphere_grid", "corner_hist", "barycenter_ibp", "main"]


def positive_sphere_grid(m: int = 50, device=None) -> torch.Tensor:
    """(m * m, 3) points on the positive octant of the unit sphere."""
    th = torch.linspace(0.02, math.pi / 2 - 0.02, m, device=device)
    ph = torch.linspace(0.02, math.pi / 2 - 0.02, m, device=device)
    T, P = torch.meshgrid(th, ph, indexing="xy")
    pts = torch.stack([torch.sin(T) * torch.cos(P),
                       torch.sin(T) * torch.sin(P), torch.cos(T)], dim=-1)
    return pts.reshape(-1, 3)


def corner_hist(pts: torch.Tensor, corner: torch.Tensor,
                sharp: float = 60.0) -> torch.Tensor:
    with ieee_fp32():
        w = torch.exp(sharp * (pts @ corner - 1.0))
    return w / torch.sum(w)


def barycenter_ibp(Phi: torch.Tensor, hists: torch.Tensor,
                   n_iter: int = 200) -> torch.Tensor:
    """IBP barycenter of ``hists`` (k, n) through the factored kernel
    K = Phi Phi^T (r = 3), symmetric, applied to the k scalings at once."""
    def K(v):                                    # (k, n) -> (k, n), O(3n)
        with ieee_fp32():
            return (v @ Phi) @ Phi.T

    u = torch.ones_like(hists)
    v = torch.ones_like(hists)
    b = None
    for _ in range(n_iter):
        Ktu = K(u)
        logb = torch.mean(torch.log(torch.clamp(v * Ktu, min=1e-38)), dim=0)
        b = torch.exp(logb)
        v = b[None, :] / torch.clamp(Ktu, min=1e-38)
        u = hists / torch.clamp(K(v), min=1e-38)
    return b


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the example; returns ``{"angle", "peak", "mass_near_center",
    "weights", "device"}``. Raises if the peak is 25 degrees or more from
    the octant's centre."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pts = positive_sphere_grid(50, device=device)
    corners = torch.eye(3, device=device)
    hists = torch.stack([corner_hist(pts, c) for c in corners])
    b = barycenter_ibp(pts, hists)
    # softmax sharpening (paper temperature 1000)
    sharp = torch.softmax(1000.0 * b / torch.max(b), dim=0)
    peak = pts[torch.argmax(sharp)]
    center = torch.ones(3, device=device) / math.sqrt(3.0)
    ang = math.degrees(math.acos(float(torch.clamp(peak @ center, -1, 1))))
    print(f"barycenter mass peak at {[round(float(p), 3) for p in peak]} "
          f"({ang:.1f} deg from the octant center: mass sits between "
          "the three corners, paper Fig. 6e)")
    near = float(torch.sum(torch.where(pts @ center > 0.95, b,
                                       torch.zeros_like(b))) / torch.sum(b))
    print(f"fraction of barycenter mass within 18deg of center: {near:.2f}")
    if not ang < 25.0:
        raise RuntimeError(f"barycenter peak {ang:.1f} deg from the octant "
                           "center; it should concentrate mid-octant")
    print(f"OK: factored-kernel (r=3) barycenter via IBP on {device}")
    return dict(angle=ang, peak=peak, mass_near_center=near, weights=b,
                device=str(device))


if __name__ == "__main__":
    main()
