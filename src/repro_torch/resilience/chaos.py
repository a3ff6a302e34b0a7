"""Deterministic fault injection for the resilience test matrix.

One seeded :class:`ChaosInjector` drives every fault class the recovery
stack must absorb:

* **NaN/Inf rows in features or weights** — the corruption lands at
  request-construction time so an exact repeat of a corrupted pair
  carries the SAME fingerprint (that is what lets the service quarantine
  repeat offenders instead of re-paying a full ladder per repeat).
* **Forced runner exceptions** — a hook the service calls right before
  the megabatch dispatch; raising there simulates a runner fault and
  must degrade to per-request recovery, never to an unhandled exception.
  (A real kernel or CUDA runtime fault is not absorbed: the service
  re-raises it, ``kernels.build.device_fault``.)
* **Clock skew** — a bounded deterministic jitter wrapped around the
  injected service clock, stressing the admission queue's max-wait aging
  (a skewed ``now`` must not wedge groups or crash ``pop_due``).
* **Warm-cache poisoning** — raw insertion of non-finite potentials
  (``store(..., validate=False)``), simulating a corrupted snapshot or a
  cache written by a pre-validation build; the get-side validation must
  evict them and the request must cold-solve.

Everything is a pure function of ``ChaosSpec.seed`` and call order, so a
chaos run is replayable and its expected counters can be asserted
exactly (the ``--chaos --strict`` lane of ``launch/ot_service``). Pure
numpy: one ``default_rng(seed)`` and the reference's order of draws, so a
seed gives the same faults, rows, hook draws and skews as the JAX
package's injector. Counterpart of ``repro.resilience.chaos``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

__all__ = ["FAULT_KINDS", "ChaosSpec", "ChaosInjector"]

FAULT_KINDS = ("nan_feature", "inf_feature", "nan_weight")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Knobs for one deterministic fault campaign."""

    seed: int = 0
    nan_feature_frac: float = 0.15   # pool fraction with a NaN feature row
    inf_feature_frac: float = 0.05   # pool fraction with an +inf feature row
    nan_weight_frac: float = 0.10    # pool fraction with a NaN weight entry
    runner_fault_frac: float = 0.05  # dispatches that raise in the runner
    clock_skew_s: float = 0.0        # max |skew| added per clock read

    def __post_init__(self):
        total = (self.nan_feature_frac + self.inf_feature_frac
                 + self.nan_weight_frac)
        if total > 1.0:
            raise ValueError(
                f"fault fractions sum to {total} > 1; they partition the "
                "pool")


class ChaosInjector:
    """Seeded fault source (see module docstring). All randomness flows
    through one ``default_rng(seed)``, so a given spec + call order
    replays identically."""

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.runner_faults = 0
        self.clock_reads = 0

    # -- data corruption ----------------------------------------------------

    def assign_faults(self, n_pool: int) -> Tuple[str, ...]:
        """Deterministic fault class per pool index ("" = healthy):
        fractions of the pool get each corruption, shuffled so fault
        classes interleave across size classes."""
        kinds = []
        for kind, frac in (("nan_feature", self.spec.nan_feature_frac),
                           ("inf_feature", self.spec.inf_feature_frac),
                           ("nan_weight", self.spec.nan_weight_frac)):
            kinds += [kind] * int(round(frac * n_pool))
        kinds += [""] * (n_pool - len(kinds))
        self.rng.shuffle(kinds)
        return tuple(kinds)

    def corrupt_features(self, xi: np.ndarray, kind: str) -> np.ndarray:
        """Overwrite one feature row with NaN or +inf."""
        xi = np.array(xi, np.float32, copy=True)
        row = int(self.rng.integers(xi.shape[0]))
        xi[row] = np.nan if kind == "nan_feature" else np.inf
        self.injected[kind] += 1
        return xi

    def corrupt_weights(self, a: np.ndarray) -> np.ndarray:
        a = np.array(a, np.float32, copy=True)
        a[int(self.rng.integers(a.shape[0]))] = np.nan
        self.injected["nan_weight"] += 1
        return a

    # -- runtime faults -----------------------------------------------------

    def fault_hook(self) -> Callable:
        """A hook for ``OTService(chaos_hook=...)``: raises on a
        ``runner_fault_frac`` Bernoulli draw per dispatch."""

        def hook(shape, batch):
            if self.rng.random() < self.spec.runner_fault_frac:
                self.runner_faults += 1
                raise RuntimeError(
                    f"chaos: injected runner fault (cell {shape} B={batch})")

        return hook

    def skewed(self, clock: Callable[[], float]) -> Callable[[], float]:
        """Wrap a clock with bounded uniform jitter per read (can run
        backwards between reads — exactly the skew admission aging must
        survive)."""
        skew = self.spec.clock_skew_s
        if skew <= 0:
            return clock

        def read() -> float:
            self.clock_reads += 1
            return clock() + float(self.rng.uniform(-skew, skew))

        return read

    # -- cache poisoning ----------------------------------------------------

    def poison_warm_cache(self, cache, support_key: bytes, full_key: bytes,
                          n: int, m: int) -> None:
        """Insert NaN potentials under a real request's fingerprint,
        bypassing the put-side validation (a corrupted snapshot)."""
        f = np.full((n,), np.nan, np.float32)
        g = np.full((m,), np.nan, np.float32)
        cache.store(support_key, full_key, f, g, validate=False)

    def stats(self) -> Dict[str, int]:
        return dict(self.injected, runner_faults=self.runner_faults,
                    clock_reads=self.clock_reads)
