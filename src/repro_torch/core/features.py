"""Lemma-1 positive random features for the Gaussian kernel.

A positive feature map phi defines k(x, y) = <phi(x), phi(y)> > 0, so the
Gibbs kernel factorizes exactly, K = Xi Zeta^T, and every Sinkhorn matvec
costs O(r (n + m)). For exp(-||x - y||^2 / eps) (Lemma 1):

    log Xi[i, k] = c_k - (1/2) log r - 2/eps ||x_i - u_k||^2,
    c_k = (d/4) log(2q) + ||u_k||^2 / (q eps),   u_k ~ N(0, q eps / 4 I).

Lemma 3's perturbed arc-cosine map, :func:`arccos_features`, gives
k_s(x, y) + kappa through relu-rectified random projections and one shared
sqrt(kappa) coordinate. Counterpart of ``repro.core.features``. Scalar
configuration math is plain Python floats.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.backend import resolve_device
from ..kernels.ref import ieee_fp32

__all__ = [
    "lambert_w0",
    "gaussian_q",
    "GaussianFeatureMap",
    "gaussian_log_features",
    "gaussian_features",
    "ArcCosineFeatureMap",
    "arccos_features",
]


def lambert_w0(z: float, iters: int = 64) -> float:
    """Principal branch W0 of the Lambert function for z >= 0 (Halley)."""
    if z < 0:
        raise ValueError("lambert_w0 defined here for z >= 0 only")
    if z == 0.0:
        return 0.0
    w = math.log1p(z) if z < math.e else math.log(z) - math.log(math.log(z))
    for _ in range(iters):
        ew = math.exp(w)
        f = w * ew - z
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w_next = w - f / denom
        if abs(w_next - w) < 1e-15 * (1.0 + abs(w_next)):
            w = w_next
            break
        w = w_next
    return w


def gaussian_q(R: float, eps: float, d: int) -> float:
    """The paper's q = (R^2/eps) / (2 d W0(R^2 / (eps d))) (Lemma 1)."""
    z = (R * R / eps) / d
    if z == 0.0:
        return 0.5
    return z / (2.0 * lambert_w0(z))


@dataclasses.dataclass(frozen=True)
class GaussianFeatureMap:
    """Static config for Lemma-1 features."""

    r: int                 # number of random anchors
    d: int                 # ambient dimension
    eps: float             # entropic regularization (the kernel temperature)
    R: float               # data radius bound: x in B(0, R)

    @property
    def q(self) -> float:
        return gaussian_q(self.R, self.eps, self.d)

    @property
    def sigma2(self) -> float:
        """Anchor distribution variance q eps / 4."""
        return self.q * self.eps / 4.0

    @property
    def psi(self) -> float:
        """Assumption-1 amplitude bound 2 (2q)^{d/2}."""
        return 2.0 * (2.0 * self.q) ** (self.d / 2.0)

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """Sample anchors U ~ N(0, sigma2 I), shape (r, d), on the
        generator's device."""
        return math.sqrt(self.sigma2) * torch.randn(
            (self.r, self.d), generator=generator, dtype=torch.float32,
            device=generator.device)


def _log_f32(v: float) -> torch.Tensor:
    """log of ``v`` taken in float32 (a 0-d tensor), as the JAX package
    takes the logs of its configuration scalars."""
    return torch.log(torch.tensor(v, dtype=torch.float32))


def _anchor_log_const(anchors: torch.Tensor, q: float,
                      eps: float) -> torch.Tensor:
    """c_k = (d/4) log(2q) + ||u_k||^2 / (q eps), shape (r,)."""
    d = anchors.shape[-1]
    u2 = torch.sum(anchors * anchors, dim=-1)
    return 0.25 * d * _log_f32(2.0 * q) + u2 / (q * eps)


def gaussian_log_features(x: torch.Tensor, anchors: torch.Tensor, *,
                          eps: float, q: float,
                          include_sqrt_r: bool = True) -> torch.Tensor:
    """log Xi, shape (n, r): the plain (unfused) Lemma-1 log-features,
    via the matmul expansion of ||x - u||^2 in full float32."""
    r = anchors.shape[0]
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    u2 = torch.sum(anchors * anchors, dim=-1)[None, :]
    with ieee_fp32():
        xu = x @ anchors.T
    sqdist = x2 + u2 - 2.0 * xu
    logphi = _anchor_log_const(anchors, q, eps)[None, :] - 2.0 / eps * sqdist
    if include_sqrt_r:
        logphi = logphi - 0.5 * _log_f32(r)
    return logphi


def gaussian_features(x: torch.Tensor, anchors: torch.Tensor, *, eps: float,
                      q: float) -> torch.Tensor:
    """Xi = exp(log Xi): strictly positive feature matrix, shape (n, r)."""
    return torch.exp(gaussian_log_features(x, anchors, eps=eps, q=q))


# ---------------------------------------------------------------------------
# Lemma 3: perturbed arc-cosine kernel k_s(x, y) + kappa
# ---------------------------------------------------------------------------
#
#   phi_ac(x, u) = sigma^{d/2} sqrt(2) max(0, u.x)^s exp(-||u||^2/4 (1 - 1/sigma^2))
#   u ~ N(0, sigma^2 I),  plus one constant coordinate sqrt(kappa).


@dataclasses.dataclass(frozen=True)
class ArcCosineFeatureMap:
    """Static config for Lemma-3 features (output width r + 1)."""

    r: int
    d: int
    s: int = 1              # rectification order (0: step, 1: relu, 2: sq-relu)
    sigma: float = 1.5      # importance-sampling widening (> 1)
    kappa: float = 1e-3     # positivity floor

    def init(self, generator: torch.Generator, device=None) -> torch.Tensor:
        """Sample anchors sigma * N(0, I), shape (r, d), from ``generator``
        (a CPU generator), then move them to ``device`` (default: the
        card): one seed gives the same anchors on every device."""
        u = self.sigma * torch.randn((self.r, self.d), generator=generator,
                                     dtype=torch.float32)
        return u.to(resolve_device(device))


def arccos_features(x: torch.Tensor, anchors: torch.Tensor, *, s: int,
                    sigma: float, kappa: float) -> torch.Tensor:
    """Arc-cosine positive features, shape (n, r + 1), the shared
    sqrt(kappa) coordinate last:
    k_theta(x, y) = (1/r) sum_k ac_k(x) ac_k(y) + kappa -> k_s(x, y) + kappa.
    Entries of the r rectified columns may be exactly 0."""
    n = x.shape[0]
    r, d = anchors.shape
    with ieee_fp32():
        proj = x @ anchors.T
    if s > 0:
        rect = torch.clamp(proj, min=0.0) ** s
    else:
        rect = (proj > 0).to(x.dtype)
    u2 = torch.sum(anchors * anchors, dim=-1)[None, :]
    damp = torch.exp(-0.25 * u2 * (1.0 - 1.0 / (sigma * sigma)))
    amp = (torch.tensor(sigma ** (d / 2.0), dtype=torch.float32)
           * torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))
    feats = amp.to(x.device) * rect * damp / torch.sqrt(
        torch.tensor(float(r), dtype=torch.float32, device=x.device))
    const = torch.sqrt(torch.tensor(kappa, dtype=torch.float32,
                                    device=x.device)).expand(n, 1)
    return torch.cat([feats, const.to(feats.dtype)], dim=-1)
