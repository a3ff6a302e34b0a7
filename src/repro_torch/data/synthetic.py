"""Deterministic synthetic data: the LM token streams and the paper's
point clouds (Figures 1, 3, 5).

Each is a pure function of its seed (for the token streams, of
``(seed, step, shard)``), so any process can regenerate any batch and a
resume replays the stream: a CPU ``torch.Generator`` seeded from them
draws the values, which then go to ``device`` (default: the card). The
draws are not the JAX package's (``jax.random`` and ``torch`` give
different numbers from one seed); the distributions are the same: the
token streams are the same Markov-copy process (uniform tokens, each
replaced with probability 1/2 by the previous one plus 1). Tokens are
int64, the index type of ``torch.nn.functional.embedding``. Counterpart
of ``repro.data.synthetic``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

import torch

from ..kernels.backend import resolve_device

__all__ = ["token_batch", "lm_batch", "step_generator", "gaussian_clouds",
           "sphere_clouds", "highdim_clouds"]


def step_generator(seed: int, *ints: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, *ints)`` through numpy's
    ``SeedSequence``: distinct tuples give independent streams."""
    state = np.random.SeedSequence([int(seed), *map(int, ints)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                shard: int = 0, *, device=None) -> torch.Tensor:
    """(batch, seq) int64 Markov-copy tokens, correlated so that the
    cross-entropy can fall: uniform tokens, each replaced with probability
    1/2 by its left neighbour (cyclically) plus 1."""
    gen = step_generator(seed, step, shard)
    base = torch.randint(0, vocab, (batch, seq), generator=gen)
    rep = torch.rand((batch, seq), generator=gen) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    toks = torch.where(rep, (shifted + 1) % vocab, base)
    return toks.to(resolve_device(device))


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             shard: int = 0, *, device=None) -> Dict[str, torch.Tensor]:
    """``{"tokens", "labels"}``, each (batch, seq): the labels are the
    tokens shifted left by one."""
    toks = token_batch(seed, step, batch, seq + 1, vocab, shard,
                       device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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
