"""Training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 256 [--tiny] [--ckpt-dir DIR] \\
        [--save-every 50] [--resume] [--log-every 10] [--device cuda|cpu]

Runs the production loop: the step of ``launch.steps``
(forward, cross-entropy, the OT prototype loss, AdamW), deterministic
data, and with ``--ckpt-dir`` atomic checkpoints every ``--save-every``
steps under the fault-tolerant supervisor (``--resume`` restores the
latest committed step and runs ``--steps`` more). Parameters and compute
are float32, as in the JAX driver; the weights are drawn from a
generator seeded 0 on the device (on the card a full-width model's
billion draws take a fraction of a second; on the CPU they are
``init_params(cfg, seed=0)``'s). ``--tiny`` takes the reduced config;
``--device cpu`` runs on the host (the kernels' plain versions).

``--mesh DxM`` (default 1x1) runs the step on a data x model mesh, as
the JAX driver always does: on 1x1 too, so the MoE layers run expert
parallel with their capacities and drops, as the reference's do. The
world of D * M processes is the one ``torchrun`` starts (it sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), the default process group where the caller has
initialised one, or, for 1x1 without either, a world of this one process
that the driver starts and ends itself:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-135m --tiny --device cpu --mesh 2x1 --steps 4

The backend is NCCL on the card and gloo on the host; each rank takes
card ``LOCAL_RANK`` modulo the cards it sees. Every rank draws the same
weights and cuts its shards from them; the data pipeline gives every
rank the global batch, of which the step takes the rank's block
(``step.block``: its rows, its segment of the sequence); checkpoints
hold one ``shard_<rank>.npz`` a rank
and resume onto the same mesh; rank 0 prints. Counterpart of
``repro.launch.train``.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

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
from .mesh import make_local_mesh
from .specs import shard_tree
from .steps import make_train_step

WORLD_TIMEOUT_S = 60            # a collective's wait before the group fails


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
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 1x1 or 2x1 (a world of D * M "
                    "ranks)")
    return ap


def _world(args, device: torch.device):
    """(the mesh, this rank's device, whether this call started the
    world): the default process group, initialised from ``torchrun``'s
    environment if nobody has, or as a world of one process for a 1x1
    mesh outside ``torchrun``."""
    data, model = (int(x) for x in args.mesh.split("x"))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if device.type == "cuda" else "gloo"
        timeout = datetime.timedelta(seconds=WORLD_TIMEOUT_S)
        if "WORLD_SIZE" in os.environ or data * model > 1:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
    return make_local_mesh(data, model, device=device), device, started


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the driver; returns ``{"start", "end", "losses", "state"}``
    (``losses`` the logged steps' metrics, ``state`` the final parameters
    and optimizer state) for callers that drive it as a library."""
    args = _parser().parse_args(argv)
    mesh, device, started = _world(args, resolve_device(args.device))
    try:
        return _run(args, mesh, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, mesh, device) -> Dict:
    lead = dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=args.lr)
    if lead:
        print(f"[train] arch={cfg.name} device={device} mesh={args.mesh} "
              f"ot_loss={cfg.ot_loss_weight} "
              f"ot-policy {ExecutionPolicy.from_config(cfg).describe()}")
    step_fn, _ = make_train_step(cfg, mesh, shape, opt,
                                 total_steps=args.steps)
    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    params = shard_tree(params, step_fn.shardings[0], step_fn.context)
    opt_state = init_adamw(params, step_fn.opt)
    data = DataPipeline(DataConfig(
        seed=0, global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
        input_kind=cfg.input_kind, d_model=cfg.d_model), device=device)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3,
                                 group=dist.group.WORLD)
        if args.resume and ckpt.latest_step() is not None:
            (params, opt_state), man = ckpt.restore(
                None, (params, opt_state))
            start = man["step"] + 1
            if lead:
                print(f"[train] resumed from step {man['step']}")

    t0 = time.time()
    losses = []

    def one_step(state, step):
        params, opt_state = state
        params, opt_state, metrics = step_fn(
            params, opt_state, step_fn.block(data.batch_at(step)))
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(dict(m, step=step))
        if step % args.log_every == 0 and lead:
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
        if lead:
            print(f"[train] done at step {end - 1}; "
                  f"straggler report: {sup.straggler_report()}")
    else:
        for step in range(start, args.steps):
            state = one_step(state, step)
        end = args.steps
        if lead:
            print("[train] done")
    return dict(start=start, end=end, losses=losses, state=state)


if __name__ == "__main__":
    main()
