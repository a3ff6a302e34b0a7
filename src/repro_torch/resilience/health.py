"""Failure classification: one cheap host-side verdict per solve.

``ok``
    converged with finite marginal error and cost.
``maxed_out``
    hit the iteration budget with everything finite: a usable partial
    solve (``converged=False``).
``diverged``
    the iteration blew up: non-finite marginal error or dual value.
``poisoned_warm_start``
    diverged and the warm-start potentials handed to the solve were
    themselves corrupt (NaN or +inf anywhere, or ``-inf`` on an atom that
    carries mass). A cold restart, not another solver domain, fixes it.

Verdicts drive host control flow (the streaming solver's cold retry), so
they read the scalar diagnostics once, as Python numbers. Counterpart of
``repro.resilience.health``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["VERDICTS", "SolveHealth", "classify", "warm_is_poisoned"]

VERDICTS: Tuple[str, ...] = (
    "ok", "maxed_out", "diverged", "poisoned_warm_start",
)


@dataclasses.dataclass(frozen=True)
class SolveHealth:
    """One solve's verdict plus the scalar diagnostics it was read from."""

    verdict: str
    marginal_err: float
    cost: float
    n_iter: int
    converged: bool

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"

    @property
    def finite(self) -> bool:
        """True when the result is safe to hand to a caller (converged or
        a usable finite partial solve)."""
        return self.verdict in ("ok", "maxed_out")

    @property
    def failed(self) -> bool:
        return not self.finite

    def describe(self) -> str:
        return (f"{self.verdict} (err={self.marginal_err:.3g} "
                f"cost={self.cost:.6g} iters={self.n_iter})")


def warm_is_poisoned(f0: Optional[np.ndarray], g0: Optional[np.ndarray],
                     a: Optional[np.ndarray] = None,
                     b: Optional[np.ndarray] = None) -> bool:
    """Were these warm-start potentials corrupt before the solve ran?

    NaN or ``+inf`` anywhere is poison. ``-inf`` is poison only on atoms
    that carry mass: zero-weight atoms legitimately sit at ``f = -inf`` in
    the log domain. Without weights, ``-inf`` counts as poison."""
    for pot, w in ((f0, a), (g0, b)):
        if pot is None:
            continue
        x = np.asarray(pot, np.float64)
        if np.isnan(x).any() or np.isposinf(x).any():
            return True
        neg = np.isneginf(x)
        if not neg.any():
            continue
        if w is None:
            return True
        if neg[np.asarray(w, np.float64) > 0].any():
            return True
    return False


def classify(res, *, f_init: Optional[np.ndarray] = None,
             g_init: Optional[np.ndarray] = None,
             a: Optional[np.ndarray] = None,
             b: Optional[np.ndarray] = None) -> SolveHealth:
    """Verdict for one concrete solver result: anything with scalar
    ``marginal_err`` / ``cost`` / ``n_iter`` / ``converged`` fields (0-d
    tensors on any device, numpy scalars or Python numbers). Pass the
    warm-start potentials the solve was launched with, and the weights, to
    enable the ``poisoned_warm_start`` verdict."""
    err = float(res.marginal_err)
    cost = float(res.cost)
    n_iter = int(res.n_iter)
    converged = bool(res.converged)
    if np.isfinite(err) and np.isfinite(cost):
        verdict = "ok" if converged else "maxed_out"
    elif warm_is_poisoned(f_init, g_init, a, b):
        verdict = "poisoned_warm_start"
    else:
        verdict = "diverged"
    return SolveHealth(verdict=verdict, marginal_err=err, cost=cost,
                       n_iter=n_iter, converged=converged)
