"""Ladder executor for the core ``solve`` surface.

``solve_with_recovery`` runs a :class:`~repro_torch.core.spec.SolveSpec`
whose ``recovery`` field names a :class:`RecoveryPolicy`: the base
configuration solves first; on a failed verdict the executor climbs the
rung ladder, applying each rung's degradation cumulatively (see
:mod:`repro_torch.resilience.policy`) and re-solving cold, until a verdict
in ``policy.accept`` lands or the attempt or deadline budget runs out.

This is the one-shot twin of the serving executor
(``OTService._recover_one`` in :mod:`repro_torch.serving.service`), which
routes its retries through pre-captured batch-1 runners; here each attempt
goes through the ordinary ``solve`` path, whose fused-plan loops replay
their cells' captured runners (``core.runners.RUNNERS``), so a ladder
climbed twice captures nothing the first climb did not.

The ``raise_eps`` rung installs an
:class:`~repro_torch.core.api.EpsSchedule` starting at ``eps * eps_scale``:
the annealed cascade hands each stage's potentials to the next and the
final stage solves at the requested eps, so the caller gets the answer it
asked for along a better-conditioned path.

Exceptions are not absorbed here: a solve that raises (a kernel that does
not build or launch included) ends the climb with that exception.
Counterpart of ``repro.resilience.ladder``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

from .health import SolveHealth, classify
from .policy import RecoveryPolicy

__all__ = ["LOG_TWIN", "LOG_METHODS", "CONFIG_RUNGS", "degrade", "apply_rung",
           "RecoveredSolve", "solve_with_recovery"]

# scaling-domain methods and their log-domain twins; methods absent here
# (already log-domain, or cost-family conversions whose solver domain is
# not a free knob) skip the log_domain rung. "sharded" is kept so the
# ladder's walk is the reference's; its twin raises NotImplementedError
# when solved, as every sharded method of the port does.
LOG_TWIN = {
    "factored": "log_factored",
    "quadratic": "log_quadratic",
    "sharded": "sharded_log",
}
LOG_METHODS = ("log_factored", "log_quadratic", "sharded_log",
               "accelerated")


@dataclasses.dataclass(frozen=True)
class RecoveredSolve:
    """Outcome of a ladder run: the final result plus the climb record."""

    result: object                       # SinkhornResult
    health: SolveHealth
    attempts: int
    rungs: Tuple[str, ...]               # rungs actually executed, in order
    history: Tuple[Tuple[str, SolveHealth], ...]   # ("initial"/rung, verdict)

    @property
    def recovered(self) -> bool:
        return self.health.finite and self.attempts > 1


@dataclasses.dataclass
class _LadderState:
    """The cumulative configuration the ladder has degraded to."""

    method: str
    precision: str
    use_pallas: Optional[bool]
    inner_steps: Optional[int]
    check_every: Optional[int]
    schedule: object = None              # Optional[EpsSchedule]


# the rungs that change only the solver configuration; the executors
# (this module's and the service's) share their transitions in ``degrade``
CONFIG_RUNGS = ("log_domain", "precision_f32", "per_iteration")


def degrade(state: _LadderState, rung: str) -> bool:
    """Mutate ``state`` with one of the ``CONFIG_RUNGS``; False: the state
    already has that degradation, or has no log twin to move to.

    ``per_iteration`` drops the megakernel: one iteration a launch and a
    check every iteration, on the same fused plan. ``use_pallas`` is left
    as it was, so on the card the rung still runs the per-iteration CUDA
    kernels (the JAX package's ``use_pallas=False`` there means its XLA
    operators; the port's plain operators are not a rung)."""
    if rung == "log_domain":
        twin = LOG_TWIN.get(state.method)
        if twin is None or state.method in LOG_METHODS:
            return False
        state.method = twin
        return True
    if rung == "precision_f32":
        if state.precision == "highest":
            return False
        state.precision = "highest"
        return True
    if rung == "per_iteration":
        if state.inner_steps == 1 and state.check_every == 1:
            return False
        state.inner_steps = 1
        state.check_every = 1
        return True
    raise ValueError(f"{rung!r} is not one of {CONFIG_RUNGS}")


def apply_rung(state: _LadderState, rung: str, spec,
               policy: RecoveryPolicy) -> bool:
    """Mutate ``state`` with one rung's degradation; False: the rung does
    not apply to this configuration (skipped, no attempt consumed)."""
    from ..core.api import EpsSchedule

    if rung in CONFIG_RUNGS:
        return degrade(state, rung)
    if rung == "raise_eps":
        if not spec.geometry.anneal_capable:
            return False
        eps_init = float(spec.eps) * policy.eps_scale
        prev = state.schedule
        if prev is not None and prev.eps_init >= eps_init:
            return False
        state.schedule = EpsSchedule(eps_init=eps_init)
        return True
    if rung == "cold_restart":
        # the core surface has no warm-start inputs: every spec solve is
        # already cold, so a bare re-run of the same configuration cannot
        # change the outcome; the rung belongs to the serving and
        # streaming executors, which hold warm state to discard
        return False
    raise ValueError(f"unknown rung {rung!r}")


def solve_with_recovery(spec, *, first_attempt=None) -> RecoveredSolve:
    """Run ``spec`` through its recovery ladder (see the module doc).

    ``first_attempt`` optionally supplies an already computed result of
    the base configuration (a failed lane of a batched ``solve_many``
    bucket), so the ladder does not pay for failing it again.
    """
    from ..core.api import _auto_method, solve

    policy: Optional[RecoveryPolicy] = spec.recovery
    if policy is None:
        policy = RecoveryPolicy()
    base = spec.replace(recovery=None)
    t0 = time.monotonic()

    res = solve(base) if first_attempt is None else first_attempt
    health = classify(res)
    history: List[Tuple[str, SolveHealth]] = [("initial", health)]
    attempts = 1
    rungs_run: List[str] = []
    if health.verdict in policy.accept:
        return RecoveredSolve(res, health, attempts, (), tuple(history))

    method = base.method
    if method == "auto":
        method = _auto_method(base.problem())
    pol = base.policy
    state = _LadderState(
        method=method, precision=pol.precision, use_pallas=pol.use_pallas,
        inner_steps=pol.inner_steps, check_every=pol.check_every,
        schedule=base.schedule,
    )

    for rung in policy.ordered_rungs(health.verdict):
        if attempts >= policy.max_attempts:
            break
        if (policy.deadline_s is not None
                and time.monotonic() - t0 >= policy.deadline_s):
            break
        if not apply_rung(state, rung, base, policy):
            continue
        attempt_spec = base.replace(
            method=state.method,
            schedule=state.schedule,
            policy=dataclasses.replace(
                pol, precision=state.precision,
                use_pallas=state.use_pallas,
                inner_steps=state.inner_steps,
                check_every=state.check_every,
            ),
        )
        res = solve(attempt_spec)
        health = classify(res)
        attempts += 1
        rungs_run.append(rung)
        history.append((rung, health))
        if health.verdict in policy.accept:
            break
    return RecoveredSolve(res, health, attempts, tuple(rungs_run),
                          tuple(history))
