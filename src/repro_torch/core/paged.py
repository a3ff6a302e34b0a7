"""Paged factored geometry: the streaming layer's view of a mutable support.

:class:`PagedFactored` is the :class:`~repro_torch.core.geometry.
FactoredPositive` twin whose factors are fixed-capacity paged buffers
(``repro_torch.streaming.PagedFeatureStore``): always ``(capacity, r)``,
mutated by writing pages and flipping weights, never by changing shape.
Dead slots hold stale (strictly positive, in linear space) feature rows;
a solve is right because every solver masks zero-weight atoms exactly, not
because of the page table. The per-page live counts (``page_live_x`` /
``page_live_y``, int32 tensors on the factors' device) go into the
``pallas_ops`` spec, where they let the paged kernels
(``kernels.paged``) skip the pages with no live slot.

The plain operators are ``_FeatureKernelOps``'s: masked, exact and blind
to pages. Counterpart of ``repro.core.paged``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .geometry import Geometry, _FeatureKernelOps, _masked_log

__all__ = ["PagedFactored"]


@dataclasses.dataclass(frozen=True, eq=False)
class PagedFactored(_FeatureKernelOps, Geometry):
    """K = Xi Zeta^T on fixed-capacity paged factor buffers.

    ``xi`` / ``zeta`` (or ``log_xi`` / ``log_zeta``) are full-capacity
    ``(C, r)`` buffers; ``page_live_*`` are ``(C // page_size,)`` int32
    live-slot counts per page. The kernel is pinned to the eps the features
    were drawn at: streaming updates mutate supports, not the
    regularization."""

    supports_features = True

    xi: Optional[torch.Tensor] = None
    zeta: Optional[torch.Tensor] = None
    log_xi: Optional[torch.Tensor] = None
    log_zeta: Optional[torch.Tensor] = None
    page_live_x: Optional[torch.Tensor] = None
    page_live_y: Optional[torch.Tensor] = None
    page_size: int = 64
    eps: float = dataclasses.field(kw_only=True)

    def __post_init__(self):
        have_lin = self.xi is not None and self.zeta is not None
        have_log = self.log_xi is not None and self.log_zeta is not None
        if have_lin == have_log:
            raise ValueError(
                "PagedFactored needs exactly one factor pair: "
                "(xi, zeta) or (log_xi, log_zeta)")
        if self.page_live_x is None or self.page_live_y is None:
            raise ValueError(
                "PagedFactored needs page_live_x and page_live_y "
                "(per-page int32 live-slot counts)")

    @property
    def shape(self) -> Tuple[int, int]:
        if self.xi is not None:
            return self.xi.shape[0], self.zeta.shape[0]
        return self.log_xi.shape[0], self.log_zeta.shape[0]

    @property
    def rank(self) -> int:
        return (self.xi if self.xi is not None else self.log_xi).shape[1]

    def features(self):
        if self.xi is not None:
            return self.xi, self.zeta
        return torch.exp(self.log_xi), torch.exp(self.log_zeta)

    def log_features(self):
        if self.log_xi is not None:
            return self.log_xi, self.log_zeta
        return _masked_log(self.xi), _masked_log(self.zeta)

    def cost_matrix(self):
        return -self.eps * self.log_dense_kernel()

    def pallas_ops(self):
        """The ``paged`` spec: scaling mode runs the page-skipping kernels,
        log mode the log plan on the full-capacity log-factors."""
        spec = {
            "kind": "paged",
            "page_live_x": self.page_live_x,
            "page_live_y": self.page_live_y,
            "page_size": self.page_size,
            "eps": self.eps,
        }
        if self.xi is not None:
            spec.update(xi=self.xi, zeta=self.zeta)
        else:
            spec.update(log_xi=self.log_xi, log_zeta=self.log_zeta)
        return spec
