"""Dry run: one rank's step of every (arch x shape x mesh) cell, traced on
fake tensors in a fake world of 256 or 512 ranks.

For each cell:

  1. start a fake world (``torch.distributed``'s ``fake`` backend, this
     process as rank 0 of 256 or 512) and build the production mesh, 16 x
     16 single-pod or 2 x 16 x 16 multi-pod;
  2. build the port's own ``make_train_step`` / ``make_serve_step``;
  3. under a ``FakeTensorMode`` with a ``ShapeEnv``, make rank 0's
     parameter and moment shards (``abstract_state``, ``shard_tree``), its
     block of ``input_specs``' batch and, for decode, the rank's caches:
     shapes and dtypes with no data, nothing allocated;
  4. run one step under ``launch.analysis.StepCounter``: dot FLOPs, HBM
     bytes, collectives and their wire bytes, the peak of live bytes;
  5. write the roofline terms on the H100's numbers and the memory fields
     to ``artifacts/dryrun_torch/{arch}_{shape}_{mesh}.json``.

Rank 0 stands for every rank: each takes its block of the batch (its
rows, its segment of the sequence) and does the same work, and a batch
that does not divide over the data axes is replicated. The fake tensors take the CPU path (the
kernels' plain versions: a hand-written kernel needs real pointers), and
every solve runs its check blocks up to ``max_iter`` with no host read
(``core.sinkhorn.is_dry``). A size that depends on the data (the expert
parallel MoE's kept rows) is an unbacked symbol, counted at its upper
bound. The dry run computes nothing and needs no card; ``chip_smoke.py``
phase 17 holds its counts against a real step on the card.

The memory fields keep the reference's names: ``argument_size_in_bytes``
(the rank's parameters, moments, inputs and caches),
``output_size_in_bytes``, ``temp_size_in_bytes`` (the peak of live bytes
less the arguments), ``alias_size_in_bytes`` (outputs in the arguments'
storage: decode's caches, written in place), and ``peak_bytes`` with
``fits``, the peak against the card's HBM.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-done]

Counterpart of ``repro.launch.dryrun``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.symbolic_shapes import ShapeEnv

from ..configs import SHAPES, ArchConfig, ShapeSpec, cell_applicable, \
    get_config, get_shape, list_archs
from ..models import shard_caches
from ..optim import init_adamw
from ..tree import tree_map
from . import specs as S
from .analysis import HW, StepCounter, report
from .mesh import make_production_mesh
from .steps import make_serve_step, make_train_step

__all__ = ["ARTIFACT_DIR", "fake_world", "fake_arguments", "dry_step",
           "run_cell", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake world of ``world_size`` ranks with this process as rank 0:
    collectives return at once and move nothing. Refuses to start over an
    existing default process group; ends the world on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: a dry run "
                           "starts a fake world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def fake_arguments(cfg: ArchConfig, shape: ShapeSpec, step, specs):
    """The step's arguments as fake tensors on the CPU: the rank's
    shards (the whole tree without a mesh), the rank's block of the batch
    (``step.block``) and, for decode, the rank's caches. Call under the
    ``FakeTensorMode``."""
    ctx = getattr(step, "context", None)
    params = tree_map(_empty, specs[0])
    if ctx is not None:
        params = S.shard_tree(params, step.shardings[0], ctx)
    batch = step.block(tree_map(
        _empty, specs[2] if shape.mode == "train" else specs[1]))
    if shape.mode == "train":
        return params, init_adamw(params, step.opt), batch
    if shape.mode == "prefill":
        return params, batch
    caches = shard_caches(cfg, tree_map(_empty, specs[2]), ctx)
    return params, batch, caches


def dry_step(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
             **train_kw) -> Tuple[StepCounter, Dict[str, int]]:
    """Trace one step of the cell on this rank's fake tensors (the world
    and ``mesh`` already made; ``mesh=None`` for one card) under a
    :class:`StepCounter`. Returns the counter and the memory fields."""
    if shape.mode == "train":
        step, specs = make_train_step(cfg, mesh, shape, **train_kw)
    else:
        step, specs = make_serve_step(cfg, mesh, shape)
    counter = StepCounter()
    with FakeTensorMode(shape_env=ShapeEnv()):
        args = fake_arguments(cfg, shape, step, specs)
        counter.track(args)
        with counter:
            out = step(*args)
        memory = {
            "argument_size_in_bytes": counter.tracked_bytes,
            "output_size_in_bytes": counter.storage_bytes(out),
            "temp_size_in_bytes": counter.peak_bytes - counter.tracked_bytes,
            "alias_size_in_bytes": (counter.storage_bytes(out)
                                    - counter.storage_bytes(out, args)),
            "peak_bytes": counter.peak_bytes,
        }
    return counter, memory


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             artifact_dir: str = ARTIFACT_DIR) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = cell_applicable(cfg, shape)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "applicable": ok, "reason": reason,
    }
    if not ok:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: {reason}")
        return result

    n_dev = 512 if multi_pod else 256
    t0 = time.time()
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        counter, mem = dry_step(cfg, shape, mesh)
    t_trace = time.time() - t0
    hw = HW()
    mem["fits"] = mem["peak_bytes"] <= hw.hbm_bytes
    got = report(counter, hw)
    terms = got["roofline"]
    print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: "
          f"trace {t_trace:.1f}s ({counter.ops} ops)")
    print(f"  memory: {mem}")
    print(f"  collectives: {got['collective_counts']} "
          f"wire_bytes/dev={got['wire_bytes_per_device']:.3e}")
    print(f"  dot flops/dev={got['flops_per_device']:.3e} "
          f"(raw {got['flops_per_device_raw']:.3e}); "
          f"hbm={got['hbm_bytes_per_device']:.3e}")
    print(f"  roofline (H100): compute={terms['compute_s']:.3e}s "
          f"memory={terms['memory_s']:.3e}s "
          f"collective={terms['collective_s']:.3e}s "
          f"-> {terms['dominant']}-bound")

    result.update({"n_devices": n_dev, "trace_s": t_trace, "memory": mem})
    result.update(got)
    os.makedirs(artifact_dir, exist_ok=True)
    out = os.path.join(artifact_dir, f"{arch}_{shape_name}_{mesh_tag}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args()

    cells = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    failures = []
    t0 = time.time()
    for a, s, mp in cells:
        tag = "pod2x16x16" if mp else "pod16x16"
        if args.skip_done:
            p = os.path.join(ARTIFACT_DIR, f"{a}_{s}_{tag}.json")
            if os.path.exists(p):
                print(f"[dryrun] skip (done): {a} x {s} x {tag}")
                continue
        try:
            run_cell(a, s, multi_pod=mp)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failures.append((a, s, tag, repr(e)))
    print(f"\n[dryrun] {len(cells)} cells in {time.time() - t0:.1f}s")
    if failures:
        print(f"\n[dryrun] FAILURES ({len(failures)}):")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\n[dryrun] all requested cells traced OK")


if __name__ == "__main__":
    main()
