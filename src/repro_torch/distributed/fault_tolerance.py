"""Fault tolerance: checkpoint / restart, failure handling, stragglers.

* **Checkpoint / restart.** ``CheckpointManager`` commits atomically; the
  data pipeline is a pure function of the step, so a restart is restore
  (params, optimizer state) plus skip-ahead. ``suggest_save_every`` gives
  the Young / Daly interval.
* **Node failure -> re-mesh.** ``remesh_plan`` names the largest
  production mesh on the surviving slice (the multi-card slice applies it).
* **Stragglers.** The supervisor keeps each step's time and flags a run
  whose worst step exceeds ``straggler_tolerance`` times the median.

A kernel or CUDA runtime fault (``kernels.build.device_fault``: a
``KernelError``, torch's accelerator or out-of-memory error) is never
absorbed: :meth:`TrainingSupervisor.run` re-raises it instead of
restoring, and :meth:`TrainingSupervisor.admit_step` reads metrics on the
card, so a fault there raises too. Counterpart of
``repro.distributed.fault_tolerance``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..kernels.build import device_fault

__all__ = ["FaultToleranceConfig", "TrainingSupervisor", "remesh_plan",
           "suggest_save_every"]


@dataclasses.dataclass
class FaultToleranceConfig:
    save_every: int = 50
    keep: int = 3
    max_restarts: int = 10
    straggler_tolerance: float = 2.0      # x median step time
    straggler_windows: int = 3
    # bound on CONSECUTIVE steps skipped for non-finite OT metrics
    # (admit_step): past it the run aborts instead of silently making no
    # progress on a persistently-diverging objective
    max_consecutive_skips: int = 8


def suggest_save_every(step_time_s: float, ckpt_time_s: float,
                       node_mtbf_h: float, n_nodes: int) -> int:
    """Young/Daly optimal checkpoint interval, in steps."""
    mtbf_cluster_s = node_mtbf_h * 3600.0 / max(n_nodes, 1)
    interval_s = math.sqrt(2.0 * ckpt_time_s * mtbf_cluster_s)
    return max(1, int(interval_s / max(step_time_s, 1e-9)))


def remesh_plan(alive_pods: int, alive_per_pod: int) -> Dict:
    """Largest legal production mesh on the surviving slice."""
    if alive_pods >= 2 and alive_per_pod >= 256:
        return {"shape": (2, 16, 16), "axes": ("pod", "data", "model")}
    if alive_per_pod >= 256:
        return {"shape": (16, 16), "axes": ("data", "model")}
    # degraded: shrink data-parallelism, keep model sharding intact
    data = max(1, alive_per_pod // 16)
    return {"shape": (data, 16), "axes": ("data", "model")}


class TrainingSupervisor:
    """Wraps a step function with checkpointing + restart-on-failure.

    ``step_fn(state, step) -> state`` may raise (a simulated node
    failure); the supervisor restores the last committed checkpoint and
    continues. Deterministic data (a pure function of the step) makes the
    replay exact. A device fault is re-raised, never restored from.
    """

    def __init__(self, ckpt: CheckpointManager, cfg: FaultToleranceConfig):
        self.ckpt = ckpt
        self.cfg = cfg
        self.restarts = 0
        self.step_times: List[float] = []
        self.skipped_steps = 0          # total steps refused by admit_step
        self.consecutive_skips = 0      # current refusal streak

    def admit_step(self, metrics: Dict) -> bool:
        """Training-step guard for the OT objective layer: admit the step
        only when every numeric metric (OT loss, grad norm, ...) is
        finite.

        A diverged routing/GAN solve surfaces here as a NaN loss or grad
        norm — applying that update poisons the parameters permanently,
        so the caller keeps the OLD state on refusal (skip the step, keep
        training on the next batch). Refusals are counted; a streak
        longer than ``max_consecutive_skips`` aborts with ``RuntimeError``
        — at that point the objective is persistently diverging and
        skipping forever would burn the job silently.
        """
        bad = []
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().double().cpu().numpy()
            try:
                arr = np.asarray(v, dtype=np.float64)
            except (TypeError, ValueError):
                continue        # non-numeric metric (tags, names): ignore
            if not np.all(np.isfinite(arr)):
                bad.append(k)
        if not bad:
            self.consecutive_skips = 0
            return True
        self.skipped_steps += 1
        self.consecutive_skips += 1
        if self.consecutive_skips > self.cfg.max_consecutive_skips:
            raise RuntimeError(
                f"aborting: {self.consecutive_skips} consecutive steps "
                f"skipped on non-finite metrics {bad} (bound "
                f"max_consecutive_skips={self.cfg.max_consecutive_skips})")
        return False

    def run(self, state, start_step: int, n_steps: int,
            step_fn: Callable, *, on_restore: Optional[Callable] = None):
        step = start_step
        while step < start_step + n_steps:
            t0 = time.perf_counter()
            try:
                state = step_fn(state, step)
            except Exception as exc:
                if device_fault(exc):
                    raise
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state, _ = self.ckpt.restore(latest, state)
                if on_restore is not None:
                    state = on_restore(state)
                step = latest + 1
                continue
            self.step_times.append(time.perf_counter() - t0)
            if (step + 1) % self.cfg.save_every == 0:
                self.ckpt.save(step, state)
            step += 1
        self.ckpt.save(step - 1, state)
        self.ckpt.wait()
        return state, step

    def straggler_report(self) -> Dict:
        if len(self.step_times) < 4:
            return {"flagged": False}
        ts = sorted(self.step_times)
        median = ts[len(ts) // 2]
        worst = ts[-1]
        return {
            "flagged": worst > self.cfg.straggler_tolerance * median,
            "median_s": median,
            "worst_s": worst,
        }
