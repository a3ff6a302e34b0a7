"""The paper's technique as an LM training loss.

The final hidden states are an empirical measure over tokens; a learnable
prototype cloud is the second measure. Both are embedded by a linear map
f_gamma into the ball of radius ``OT_RADIUS`` and compared with the
Sinkhorn divergence under a learned positive-feature kernel (Lemma-1
features with learnable anchors), exactly as the paper's GAN objective
(Eq. 18) does:

* the factored kernel gives O(r (n + m)) solver iterations (on the card
  the log plan's ``log_feature_contract`` and ``log_halfstep`` kernels);
* the envelope-theorem VJP of ``core.grad.rot_geometry`` gives the
  gradients, with no backprop through the Sinkhorn loop;
* theta = (anchors, prototypes, f_gamma) is learned.

One constant feature column (the kappa floor) is appended, so the rank is
``n_features + 1``.

Under a mesh context that splits the batch rows over the data axes or
the sequence over ``"model"``, each rank holds its block of the batch
(its rows, its segment): the sample's indices are the GLOBAL ones over
B * S, each rank contributes the sampled tokens of its block, and they
are all-gathered and put back in the global order (the gather's backward
hands each rank its tokens' gradient, summed over the ranks that hold
the loss). With the policy's mesh the solves run sharded over its
``"data"`` axis (``core.sharded``). Counterpart of
``repro.models.ot_loss``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.features import gaussian_log_features, gaussian_q
from ..core.objective import ExecutionPolicy, OTObjective
from ..distributed.sharding import all_gather, current_mesh_context, \
    rows_axis, seq_axis
from .layers import normal, trunc_normal

__all__ = ["init_ot_loss", "ot_prototype_loss", "prototype_log_features",
           "subsample_indices", "subsample_tokens", "OT_RADIUS"]

OT_RADIUS = 2.0     # f_gamma's output is tanh-bounded into B(0, OT_RADIUS)


def init_ot_loss(generator, d_model: int, *, ot_dim: int, n_protos: int,
                 n_features: int, eps: float,
                 device=None) -> Dict[str, torch.Tensor]:
    """``{"proj", "protos", "anchors"}``, float32: the projection f_gamma,
    the prototypes and the Lemma-1 anchors N(0, q eps / 4 I)."""
    q = gaussian_q(OT_RADIUS, eps, ot_dim)
    sigma = (q * eps / 4.0) ** 0.5
    return {
        "proj": trunc_normal((d_model, ot_dim), d_model ** -0.5,
                             generator=generator, device=device),
        "protos": normal((n_protos, ot_dim), OT_RADIUS * 0.5,
                         generator=generator, device=device),
        "anchors": normal((n_features, ot_dim), sigma, generator=generator,
                          device=device),
    }


def subsample_indices(batch: int, seq: int, n_tokens: int) -> np.ndarray:
    """The ``min(n_tokens, batch * seq)`` evenly spaced rows of the
    flattened (batch, seq) grid the loss takes (the JAX package's
    indices)."""
    total = batch * seq
    n = min(int(n_tokens), total)
    return np.round(np.linspace(0, total - 1, n)).astype(np.int64)


def subsample_tokens(hidden: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Exactly ``min(n_tokens, B * S)`` tokens of a (B, S, d) batch."""
    B, S, d = hidden.shape
    idx = torch.as_tensor(subsample_indices(B, S, n_tokens),
                          device=hidden.device)
    return hidden.reshape(B * S, d)[idx]


def _sample(hidden: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The subsampled token states: this rank's alone, or under a mesh
    context that splits the batch rows over the data axes and / or the
    sequence over ``"model"``, the global sample in the reference's
    order: each rank takes the sample's tokens in its block (its rows,
    its segment), the blocks are gathered in rank order (padded to one
    count, then unpadded) and put back in global order."""
    ctx = current_mesh_context()
    dp, tp = rows_axis(ctx), seq_axis(ctx)
    if dp is None and tp is None:
        return subsample_tokens(hidden, n_tokens)
    B, S, d = hidden.shape
    nd = 1 if dp is None else dp.size
    nt = 1 if tp is None else tp.size
    idx = subsample_indices(B * nd, S * nt, n_tokens)
    b, s = idx // (S * nt), idx % (S * nt)
    # the rank holding each sampled token, in the gather's (dp, tp) order
    owner = (b // B) * nt + s // S
    me = (0 if dp is None else dp.rank) * nt + (0 if tp is None else tp.rank)
    counts = np.bincount(owner, minlength=nd * nt)
    mine = owner == me
    local = hidden.reshape(B * S, d)[torch.as_tensor(
        (b[mine] % B) * S + s[mine] % S, device=hidden.device)]
    width = int(counts.max())
    local = torch.nn.functional.pad(local, (0, 0, 0, width - int(counts[me])))
    axis = ctx.world if (dp is not None and tp is not None) else (
        dp if tp is None else tp)
    parts = all_gather(local, axis, dim=0).split(width)
    out = torch.cat([part[:int(c)] for part, c in zip(parts, counts)])
    if tp is None:              # the owners follow the global order
        return out
    # the gathered tokens are in owner order: invert it to the global one
    back = np.argsort(np.argsort(owner, kind="stable"))
    return out[torch.as_tensor(back, device=hidden.device)]


def prototype_log_features(p_ot: Dict[str, torch.Tensor],
                           hidden: torch.Tensor, *, eps: float,
                           n_tokens: int):
    """The loss's log-features ``(log_xi (n, r + 1), log_zeta (m, r + 1))``
    of the subsampled token states and the prototypes: f_gamma, the
    Lemma-1 features under the learned anchors, and the kappa column."""
    sample = _sample(hidden, n_tokens).float()
    z = OT_RADIUS * torch.tanh(sample @ p_ot["proj"])          # f_gamma
    protos = OT_RADIUS * torch.tanh(p_ot["protos"])
    q = gaussian_q(OT_RADIUS, eps, z.shape[-1])
    lxi = gaussian_log_features(z, p_ot["anchors"], eps=eps, q=q)
    lzeta = gaussian_log_features(protos, p_ot["anchors"], eps=eps, q=q)
    # the kappa floor (the paper's Lemma-3 perturbation): one constant
    # feature column keeps k_theta >= kappa > 0 however far the learned
    # anchors drift from the data, so the log-domain solve and its
    # envelope VJP stay finite for any theta
    kappa = 0.5 * torch.log(torch.full((1, 1), 1e-18, dtype=torch.float32,
                                       device=z.device))
    lxi = torch.cat([lxi, kappa.expand(lxi.shape[0], 1)], dim=1)
    lzeta = torch.cat([lzeta, kappa.expand(lzeta.shape[0], 1)], dim=1)
    return lxi, lzeta


def ot_prototype_loss(p_ot: Dict[str, torch.Tensor], hidden: torch.Tensor, *,
                      eps: float, n_tokens: int, n_iter: int,
                      policy: Optional[ExecutionPolicy] = None
                      ) -> torch.Tensor:
    """Sinkhorn divergence between token states (B, S, d) and the learned
    prototypes, a 0-d tensor: three solves of ``n_iter`` iterations at
    tol 0 through :class:`OTObjective` under ``policy`` (default: the
    training policy, bf16 factor storage and the fused plan)."""
    obj = OTObjective(
        eps=eps, tol=0.0, max_iter=n_iter,
        policy=policy if policy is not None else ExecutionPolicy.training())
    geom = obj.factored(*prototype_log_features(p_ot, hidden, eps=eps,
                                                n_tokens=n_tokens))
    a, b = obj.uniform_weights(geom)
    return obj.divergence(geom, a, b)
