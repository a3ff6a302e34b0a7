"""End-to-end driver: train a ~100M-parameter LM with the paper's
Sinkhorn-divergence loss in the objective.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
        [--batch 8] [--seq 256] [--lr 6e-4] [--tiny] [--ckpt-dir DIR]
        [--arch smollm-135m] [--no-ot] [--strict] [--device cuda|cpu]

The production stack end to end: the config system (smollm-135m, cut to
8 layers, 20 OT iterations and 256 OT tokens unless ``--tiny``), the
deterministic data pipeline, AdamW with warmup-cosine, async checkpoints
under the fault-tolerant supervisor (which skips a step with non-finite
metrics and bounds the streak), and the OT prototype loss (learned
positive features) in every step.

``--strict`` is the CI contract: the OT loss runs the fused plan
(``ot_use_pallas=True``) and the warm-up step must select it at the
policy's precision (``kernels.ops.observe_plan_selection``); every logged
loss is finite, no step is skipped, and no solve loop is captured after
the warm-up (``core.runners.RUNNERS``: the warm-up step captures the one
runner every later solve replays). A kernel fault is never absorbed.
Counterpart of ``examples/train_lm.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..core.objective import ExecutionPolicy
from ..core.runners import RUNNERS
from ..data import DataConfig, DataPipeline
from ..distributed.fault_tolerance import (
    FaultToleranceConfig,
    TrainingSupervisor,
)
from ..kernels.backend import resolve_device
from ..kernels.ops import observe_plan_selection
from ..launch.steps import loss_and_grads
from ..models import init_params, param_count
from ..optim import (
    AdamWConfig,
    adamw_update,
    init_adamw,
    linear_warmup_cosine,
)


def _require(ok: bool, msg: str) -> None:
    """A --strict check; unlike ``assert`` it also runs under ``-O``."""
    if not ok:
        raise AssertionError(msg)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--no-ot", action="store_true",
                    help="ablation: drop the Sinkhorn loss")
    ap.add_argument("--strict", action="store_true",
                    help="CI mode: force the fused plan, assert its "
                    "selection, finite losses, no skipped step and zero "
                    "post-warmup captures")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the driver; returns ``{"hist", "end", "captures", "skipped",
    "plan_events", "policy"}`` for callers that drive it as a library."""
    t_start = time.time()
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    else:
        # the ~100M-class config: a shorter depth
        cfg = dataclasses.replace(cfg, n_layers=8, ot_iters=20,
                                  ot_tokens=256)
    if args.no_ot:
        cfg = dataclasses.replace(cfg, ot_loss_weight=0.0)
    if args.strict:
        cfg = dataclasses.replace(cfg, ot_use_pallas=True)

    # the run-wide OT execution policy, built once from the config
    policy = ExecutionPolicy.from_config(cfg)
    params = init_params(cfg, seed=0, device=device)
    print(f"[train_lm] arch={cfg.name}({'tiny' if args.tiny else '8L'}) "
          f"device={device} params={param_count(params) / 1e6:.1f}M "
          f"ot_loss={'off' if args.no_ot else cfg.ot_loss_weight}")
    print(f"[train_lm] ot-policy {policy.describe()}")

    ocfg = AdamWConfig(lr=args.lr)
    opt_state = init_adamw(params, ocfg)
    sched = linear_warmup_cosine(args.lr, warmup=20, total_steps=args.steps)
    data = DataPipeline(DataConfig(
        seed=0, global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
        input_kind=cfg.input_kind, d_model=cfg.d_model), device=device)

    def step_fn(params, opt_state, batch):
        grads, metrics = loss_and_grads(params, cfg, batch, policy)
        params, opt_state, om = adamw_update(params, grads, opt_state, ocfg,
                                             lr_schedule=sched)
        metrics.update(om)
        return params, opt_state, metrics

    plan_events = []
    if args.strict:
        # warm up under the observability hook (the step is functional:
        # its result is dropped, the run starts from the same state)
        with observe_plan_selection() as plan_events:
            step_fn(params, opt_state, data.batch_at(0))
        if cfg.ot_loss_weight > 0:
            sel = [e for e in plan_events
                   if e["geometry"] == "FactoredPositive"]
            _require(bool(sel), f"no fused plan for the OT loss: "
                     f"{plan_events}")
            _require(all(e["precision"] == cfg.ot_precision for e in sel),
                     f"plan selections {sel}")
            print(f"[train_lm] strict: fused plan active "
                  f"({sel[0]['kind']}/{sel[0]['mode']}, "
                  f"precision={sel[0]['precision']}, {len(sel)} solves)")

    ckpt = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    sup = TrainingSupervisor(ckpt, FaultToleranceConfig(save_every=100))
    t0 = time.time()
    hist = []

    def one_step(state, step):
        params, opt_state = state
        new_params, new_opt, m = step_fn(params, opt_state,
                                         data.batch_at(step))
        mm = {k: float(v) for k, v in m.items()}       # waits for the card
        if not sup.admit_step(mm):
            # a non-finite OT loss or grad norm would poison the
            # parameters: keep the OLD state and train on the next batch
            print(f"[train_lm] step {step:4d} SKIPPED on non-finite "
                  f"metrics (streak {sup.consecutive_skips})")
            return params, opt_state
        if step % 20 == 0:
            hist.append(mm)
            print(f"[train_lm] step {step:4d} loss {mm['loss']:.4f} "
                  f"ce {mm['ce']:.4f} ot {mm.get('ot', 0):.4f} "
                  f"lr {mm['lr']:.2e} ({time.time() - t0:.0f}s)")
        return new_params, new_opt

    captures0 = RUNNERS.stats()["captures"]
    (params, opt_state), end = sup.run((params, opt_state), 0, args.steps,
                                       one_step)
    captures = RUNNERS.stats()["captures"] - captures0
    first, last = hist[0]["ce"], hist[-1]["ce"]
    print(f"[train_lm] CE {first:.4f} -> {last:.4f} over {end} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'}); "
          f"checkpoints in {args.ckpt_dir}; {time.time() - t_start:.1f} s, "
          f"of which set-up {t0 - t_start:.1f} s")
    if args.strict:
        _require(all(math.isfinite(m[k]) for m in hist for k in m),
                 f"non-finite metrics: {hist}")
        _require(captures == 0, f"{captures} post-warmup captures")
        _require(sup.skipped_steps == 0,
                 f"{sup.skipped_steps} steps skipped on non-finite metrics "
                 "in a clean run")
        print(f"[train_lm] strict: all losses finite, 0 skipped steps, "
              f"0 post-warmup captures ({RUNNERS.stats()['captures']} "
              "in all)")
    return dict(hist=hist, end=end, captures=captures,
                skipped=sup.skipped_steps, plan_events=plan_events,
                policy=policy.describe())


if __name__ == "__main__":
    main()
