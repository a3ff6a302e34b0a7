"""The paper's synthetic point clouds (Figures 1, 3, 5), each a pure
function of its seed: a CPU ``torch.Generator`` seeded with it draws the
points, which then go to ``device`` (default: the card). The draws are
not the JAX package's (``jax.random`` and ``torch`` give different numbers
from one seed); the distributions are the same. The LM batch helpers of
``repro.data.synthetic`` wait for the LM surfaces. Counterpart of
``repro.data.synthetic`` (point clouds).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.backend import resolve_device

__all__ = ["gaussian_clouds", "sphere_clouds", "highdim_clouds"]


def _normal(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def gaussian_clouds(seed: int, n: int, d: int = 2, *,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 1: N((1, ..., 1), I) against N(0, 0.1 I) in R^d, (n, d) each."""
    gen = torch.Generator().manual_seed(int(seed))
    x = _normal(gen, n, d) + 1.0
    y = math.sqrt(0.1) * _normal(gen, n, d)
    dev = resolve_device(device)
    return x.to(dev), y.to(dev)


def sphere_clouds(seed: int, n: int, *,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Figs. 2-3: two von-Mises-like caps on the unit sphere in R^3,
    around (1, 0, 0) and (-0.5, 0.8, 0)."""
    gen = torch.Generator().manual_seed(int(seed))

    def cap(center):
        v = 0.35 * _normal(gen, n, 3) + torch.tensor(center)
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    x = cap([1.0, 0.0, 0.0])
    y = cap([-0.5, 0.8, 0.0])
    dev = resolve_device(device)
    return x.to(dev), y.to(dev)


def highdim_clouds(seed: int, n: int, d: int = 28, *,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 5's stand-in for the Higgs data: N(0, (I + A)^T (I + A)) with
    A = 0.5 N(0, 1) / sqrt(d), against N(-0.5, I), in R^d."""
    gen = torch.Generator().manual_seed(int(seed))
    A = 0.5 * _normal(gen, d, d) / math.sqrt(d)
    x = _normal(gen, n, d) @ (torch.eye(d) + A)
    y = _normal(gen, n, d) - 0.5
    dev = resolve_device(device)
    return x.to(dev), y.to(dev)
