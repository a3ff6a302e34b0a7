"""Plain PyTorch versions of the port's kernels.

Each repeats its kernel's arithmetic in tensor operations: the kernel
wrappers run them for CPU tensors, the tests hold them against the JAX
package's Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. The products of the scaling kernels run in full
float32 (``ieee_fp32``), never TF32. Every log-sum-exp here is the explicit
max-shift form with the shift of an all ``-inf`` slice pinned to 0, so such
a slice gives ``-inf`` and not NaN (``_finite_or_zero`` in the JAX
package). The shift is held constant under autograd, as
``jax.nn.logsumexp`` holds it, so the gradient is the softmax. Factors
stored in bfloat16 are upcast to float32 before any arithmetic: every sum
accumulates in float32.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = [
    "ieee_fp32",
    "lse",
    "gaussian_norm_terms",
    "gaussian_feature_map_ref",
    "feature_contract_ref",
    "sinkhorn_halfstep_ref",
    "feature_matvec_ref",
    "log_feature_contract_ref",
    "log_halfstep_ref",
    "log_matvec_ref",
    "page_mask",
    "paged_contract_ref",
    "paged_halfstep_ref",
    "paged_matvec_ref",
    "relax_scaling",
    "relax_log",
    "sinkhorn_block_ref",
    "log_sinkhorn_block_ref",
]


@contextlib.contextmanager
def ieee_fp32():
    """Scope in which float32 matrix products and convolutions on the card
    run in full float32, not TF32: the Gaussian map multiplies dot-product
    errors by 4/eps, so TF32's three decimal digits would move log-features
    by nats."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def lse(z: torch.Tensor, dim: int) -> torch.Tensor:
    """log-sum-exp of ``z`` over ``dim`` with the exact max shift."""
    m = _finite_or_zero(torch.amax(z.detach(), dim=dim, keepdim=True))
    out = m + torch.log(torch.sum(torch.exp(z - m), dim=dim, keepdim=True))
    return out.squeeze(dim)


def gaussian_norm_terms(x: torch.Tensor, anchors: torch.Tensor,
                        log_const: torch.Tensor, inv_eps: float):
    """The rank-1 terms the feature-map wrapper precomputes:
    ``x2 = ||x_i||^2`` and ``u2c = log_const - 2/eps ||u_k||^2``."""
    x2 = torch.sum(x * x, dim=-1)
    u2c = log_const - (2.0 * inv_eps) * torch.sum(anchors * anchors, dim=-1)
    return x2.contiguous(), u2c.contiguous()


def gaussian_feature_map_ref(x: torch.Tensor, anchors: torch.Tensor,
                             log_const: torch.Tensor, *, inv_eps: float,
                             log_space: bool = False) -> torch.Tensor:
    """log Xi = u2c - 2/eps x2 + 4/eps x.u, shape (n, r); ``exp`` of it
    unless ``log_space``. A ``-inf`` ``log_const`` gives exactly ``-inf``
    (linear: exactly 0)."""
    x2, u2c = gaussian_norm_terms(x, anchors, log_const, inv_eps)
    with ieee_fp32():
        dot = x @ anchors.T
    log_xi = (u2c[None, :] - (2.0 * inv_eps) * x2[:, None]) \
        + (4.0 * inv_eps) * dot
    return log_xi if log_space else torch.exp(log_xi)


def feature_contract_ref(xi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """t = Xi^T u : (n, r), (n, B) -> (r, B)."""
    with ieee_fp32():
        return xi.float().T @ u


def sinkhorn_halfstep_ref(xi: torch.Tensor, t: torch.Tensor,
                          marg: torch.Tensor) -> torch.Tensor:
    """out = marg / (Xi t) : (n, r), (r, B), (n, B) -> (n, B)."""
    return marg / feature_matvec_ref(xi, t)


def feature_matvec_ref(xi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out = Xi t : (n, r), (r, B) -> (n, B)."""
    with ieee_fp32():
        return xi.float() @ t


def log_feature_contract_ref(log_w: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """t[k, c] = LSE_i(log_w[i, k] + s[i, c]) : (n, r), (n, B) -> (r, B)."""
    return lse(log_w.float()[:, :, None] + s[:, None, :], dim=0)


def log_halfstep_ref(log_w: torch.Tensor, t: torch.Tensor,
                     lmarg: torch.Tensor, *, scale: float = 1.0
                     ) -> torch.Tensor:
    """out = scale * (lmarg - LSE_k(log_w[:, k] + t[k, :])), shape (m, B)."""
    return scale * (lmarg - lse(log_w.float()[:, :, None] + t[None, :, :],
                                dim=1))


def log_matvec_ref(log_m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[j] = LSE_k(log_m[j, k] + t[k]) : (m, r), (r,) -> (m,), with the
    exact row max; an all ``-inf`` row gives ``-inf``."""
    return lse(log_m.float() + t[None, :], dim=1)


def page_mask(page_live: torch.Tensor, page_size: int) -> torch.Tensor:
    """Row mask of a paged buffer, (n_pages,) -> (n_pages * page_size,):
    True on the rows of pages with at least one live slot."""
    return torch.repeat_interleave(page_live > 0, page_size)


def paged_contract_ref(xi: torch.Tensor, u: torch.Tensor,
                       page_live: torch.Tensor, *,
                       page_size: int) -> torch.Tensor:
    """t = sum over live pages of Xi_p^T u_p : (C, r), (C, B) -> (r, B).
    The rows of dead pages are replaced by 0 in both operands, not
    multiplied by 0, so whatever they hold (stale features, garbage or
    non-finite values) never reaches ``t``."""
    live = page_mask(page_live, page_size)[:, None]
    return feature_contract_ref(
        torch.where(live, xi.float(), torch.zeros((), device=xi.device)),
        torch.where(live, u, torch.zeros_like(u)))


def paged_halfstep_ref(xi: torch.Tensor, t: torch.Tensor, marg: torch.Tensor,
                       page_live: torch.Tensor, *,
                       page_size: int) -> torch.Tensor:
    """out = marg / (Xi t) on live pages, exactly 0 on dead pages:
    (C, r), (r, B), (C, B) -> (C, B)."""
    live = page_mask(page_live, page_size)[:, None]
    return torch.where(live, sinkhorn_halfstep_ref(xi, t, marg),
                       torch.zeros_like(marg))


def paged_matvec_ref(xi: torch.Tensor, t: torch.Tensor,
                     page_live: torch.Tensor, *,
                     page_size: int) -> torch.Tensor:
    """out = Xi t on live pages, exactly 0 on dead pages:
    (C, r), (r, B) -> (C, B)."""
    out = feature_matvec_ref(xi, t)
    live = page_mask(page_live, page_size)[:, None]
    return torch.where(live, out, torch.zeros_like(out))


def relax_scaling(new: torch.Tensor, old: torch.Tensor,
                  momentum: float) -> torch.Tensor:
    """Geometric over-relaxation ``u <- old^{1-w} * new^w``; zero scalings
    (dead atoms) take ``new`` verbatim, so ``0^{1-w} * 0`` never makes NaN."""
    if momentum == 1.0:
        return new
    mixed = old ** (1.0 - momentum) * new ** momentum
    return torch.where((old > 0) & (new > 0), mixed, new)


def relax_log(new: torch.Tensor, old: torch.Tensor,
              momentum: float) -> torch.Tensor:
    """Log-space over-relaxation ``f <- (1-w) old + w new``; ``-inf``
    potentials (dead atoms) take ``new`` verbatim."""
    if momentum == 1.0:
        return new
    mixed = (1.0 - momentum) * old + momentum * new
    return torch.where(torch.isfinite(old) & torch.isfinite(new), mixed, new)


def sinkhorn_block_ref(xi: torch.Tensor, zeta: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor, u0: torch.Tensor,
                       v0: torch.Tensor, s0: torch.Tensor, *,
                       inner_steps: int, momentum: float = 1.0):
    """``inner_steps`` scaling-space iterations over the carry
    ``(u, v, s = Zeta (Xi^T u))``, then the marginal error
    ``sum |v s - b|`` at the block end. Shapes (n, r), (m, r); (n, B),
    (m, B); (n, B), (m, B), (m, B); any B. Returns ``(u, v, s, err)`` with
    ``err`` 0-d."""
    u, v, s = u0, v0, s0
    for _ in range(inner_steps):
        v = relax_scaling(b / s, v, momentum)
        t = feature_contract_ref(zeta, v)
        u = relax_scaling(a / feature_matvec_ref(xi, t), u, momentum)
        s = feature_matvec_ref(zeta, feature_contract_ref(xi, u))
    return u, v, s, torch.sum(torch.abs(v * s - b))


def log_sinkhorn_block_ref(log_xi: torch.Tensor, log_zeta: torch.Tensor,
                           loga: torch.Tensor, logb: torch.Tensor,
                           b: torch.Tensor, f0: torch.Tensor,
                           g0: torch.Tensor, t0: torch.Tensor, *,
                           inner_steps: int, eps: float,
                           momentum: float = 1.0):
    """``inner_steps`` log-domain iterations over the carry
    ``(f, g, t = LSE_i(log_xi + f/eps))``, then the marginal error
    ``sum |exp(LSE_k(log_zeta + t) + g/eps) - b|`` at the block end.
    Shapes (n, r), (m, r); (n, B), (m, B), (m, B); (n, B), (m, B), (r, B);
    any B. Returns ``(f, g, t, err)`` with ``err`` 0-d."""
    lxi, lzt = log_xi.float(), log_zeta.float()
    f, g, t = f0, g0, t0
    for _ in range(inner_steps):
        g = relax_log(eps * (logb - lse(lzt[:, :, None] + t[None], dim=1)),
                      g, momentum)
        t = lse(lzt[:, :, None] + (g / eps)[:, None, :], dim=0)
        f = relax_log(eps * (loga - lse(lxi[:, :, None] + t[None], dim=1)),
                      f, momentum)
        t = lse(lxi[:, :, None] + (f / eps)[:, None, :], dim=0)
    log_col = lse(lzt[:, :, None] + t[None], dim=1) + g / eps
    return f, g, t, torch.sum(torch.abs(torch.exp(log_col) - b))
