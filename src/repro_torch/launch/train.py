"""Training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 256 [--tiny] [--ckpt-dir DIR] \\
        [--save-every 50] [--resume] [--log-every 10] [--device cuda|cpu]

Runs the production loop on one card: the step of ``launch.steps``
(forward, cross-entropy, the OT prototype loss, AdamW), deterministic
data, and with ``--ckpt-dir`` atomic checkpoints every ``--save-every``
steps under the fault-tolerant supervisor (``--resume`` restores the
latest committed step and runs ``--steps`` more). Parameters and compute
are float32, as in the JAX driver; the weights are drawn from a
generator seeded 0 on the device (on the card a full-width model's
billion draws take a fraction of a second; on the CPU they are
``init_params(cfg, seed=0)``'s). ``--tiny`` takes the reduced config;
``--device cpu`` runs on the host (the kernels' plain versions).
Counterpart of ``repro.launch.train``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.shapes import ShapeSpec
from ..core.objective import ExecutionPolicy
from ..data import DataConfig, DataPipeline
from ..distributed.fault_tolerance import (
    FaultToleranceConfig,
    TrainingSupervisor,
)
from ..kernels.backend import resolve_device
from ..models import init_params
from ..optim import AdamWConfig, init_adamw
from .steps import make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the driver; returns ``{"start", "end", "losses", "state"}``
    (``losses`` the logged steps' metrics, ``state`` the final parameters
    and optimizer state) for callers that drive it as a library."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=args.lr)
    print(f"[train] arch={cfg.name} device={device} "
          f"ot_loss={cfg.ot_loss_weight} "
          f"ot-policy {ExecutionPolicy.from_config(cfg).describe()}")
    step_fn, _ = make_train_step(cfg, None, shape, opt,
                                 total_steps=args.steps)
    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    opt_state = init_adamw(params, step_fn.opt)
    data = DataPipeline(DataConfig(
        seed=0, global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
        input_kind=cfg.input_kind, d_model=cfg.d_model), device=device)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and ckpt.latest_step() is not None:
            (params, opt_state), man = ckpt.restore(
                None, (params, opt_state))
            start = man["step"] + 1
            print(f"[train] resumed from step {man['step']}")

    t0 = time.time()
    losses = []

    def one_step(state, step):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.batch_at(step))
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(dict(m, step=step))
            print(f"[train] step {step} loss {m.get('loss', 0):.4f} "
                  f"ce {m.get('ce', 0):.4f} ot {m.get('ot', 0):.4f} "
                  f"gnorm {m.get('grad_norm', 0):.3f} "
                  f"({time.time() - t0:.1f}s)")
        return params, opt_state

    state = (params, opt_state)
    if ckpt is not None:
        sup = TrainingSupervisor(
            ckpt, FaultToleranceConfig(save_every=args.save_every))
        state, end = sup.run(state, start, args.steps, one_step)
        print(f"[train] done at step {end - 1}; "
              f"straggler report: {sup.straggler_report()}")
    else:
        for step in range(start, args.steps):
            state = one_step(state, step)
        end = args.steps
        print("[train] done")
    return dict(start=start, end=end, losses=losses, state=state)


if __name__ == "__main__":
    main()
