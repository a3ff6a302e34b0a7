"""RecoveryPolicy: the ordered, bounded fallback ladder for failed solves.

The classic entropic-OT fix ladder (Cuturi, arXiv 1306.0895) — switch the
iteration to the log domain, raise eps — extended with the execution
degradations this stack has: bf16 factor storage back to float32, the
megakernel dropped for the per-iteration plan, and a cold restart away
from suspect warm potentials. A :class:`RecoveryPolicy` names which rungs
may run, in what order, and the attempt and deadline budget.

Rungs are cumulative: each executed rung adds its degradation on top of
the previous ones, so the ladder walks a monotone sequence of ever more
conservative configurations. A poisoned warm start pulls ``cold_restart``
to the front (``ordered_rungs``). Its executors are
:func:`~repro_torch.resilience.ladder.solve_with_recovery` (``solve(spec)``
and ``solve_many(specs)``) and the serving ladder of ``OTService``.
Counterpart of ``repro.resilience.policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .health import VERDICTS

__all__ = ["RUNGS", "RecoveryPolicy"]

# canonical order: the log-domain switch first, then precision, then eps
# escalation (annealed back down to the requested eps), then execution-plan
# conservatism, then a bare cold retry
RUNGS: Tuple[str, ...] = (
    "log_domain",       # scaling -> log-domain twin of the method
    "precision_f32",    # bf16 factor storage -> full float32
    "raise_eps",        # EpsSchedule from eps * eps_scale, annealed back down
    "per_iteration",    # drop the megakernel -> the per-iteration plan
    "cold_restart",     # same configuration, warm potentials discarded
)


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounded fallback ladder attached to a ``SolveSpec``.

    ``rungs``         ordered subset of :data:`RUNGS` the executor may climb.
    ``max_attempts``  total solve attempts including the original one
                      (``1`` classifies but never retries).
    ``deadline_s``    optional wall-clock budget for the whole ladder,
                      checked between attempts.
    ``eps_scale``     ``raise_eps`` anneals from ``eps * eps_scale`` back
                      down to the requested eps.
    ``accept``        verdicts treated as terminal success (by default a
                      finite budget-capped ``maxed_out`` solve too).
    """

    rungs: Tuple[str, ...] = RUNGS
    max_attempts: int = 4
    deadline_s: Optional[float] = None
    eps_scale: float = 10.0
    accept: Tuple[str, ...] = ("ok", "maxed_out")

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.eps_scale <= 1.0:
            raise ValueError(
                f"eps_scale must be > 1 (raise eps), got {self.eps_scale}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        unknown = [r for r in self.rungs if r not in RUNGS]
        if unknown:
            raise ValueError(
                f"unknown recovery rungs {unknown}; expected a subset of "
                f"{RUNGS}")
        if len(set(self.rungs)) != len(self.rungs):
            raise ValueError(f"duplicate rungs in {self.rungs}")
        bad = [v for v in self.accept if v not in VERDICTS]
        if bad:
            raise ValueError(
                f"accept names unknown verdicts {bad}; expected a subset "
                f"of {VERDICTS}")
        if not self.accept:
            raise ValueError("accept must name at least one verdict")

    def ordered_rungs(self, first_verdict: str) -> Tuple[str, ...]:
        """The climb order for a failure with ``first_verdict``: a
        poisoned warm start pulls ``cold_restart`` to the front."""
        if (first_verdict == "poisoned_warm_start"
                and "cold_restart" in self.rungs):
            rest = tuple(r for r in self.rungs if r != "cold_restart")
            return ("cold_restart",) + rest
        return self.rungs
