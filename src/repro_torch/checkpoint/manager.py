"""Atomic, resumable checkpoints of trees of tensors.

Layout:  ``<dir>/step_<N>/shard_<host>.npz`` + ``manifest.json`` +
``COMMIT``. A save writes ``step_<N>.tmp`` and renames it only after every
array and the manifest are flushed, so a killed save never corrupts the
latest checkpoint; restore takes the newest COMMITted step, and steps
without a COMMIT are ignored. The keys are the parameter names
(``tree.named_leaves``: ``0/groups/0/attn/wq/w`` for the first leaf of a
``(params, opt_state)`` pair). bfloat16 does not survive ``np.savez``: it
is widened to float32, exactly, and cast back to the template's dtype on
restore. An async save snapshots the tensors to host memory before its
thread writes them.

On a mesh every rank saves its own shards (``group``: the process group
of the mesh's ranks, and ``host_id`` defaults to the rank in it): rank 0
makes ``step_<N>.tmp``, every rank writes ``shard_<rank>.npz`` into it,
and after a barrier rank 0 writes the manifest (with ``n_hosts``) and
``COMMIT`` and renames the directory; a last barrier keeps every rank
from reading before the rename. A restore reads the rank's own shard
file, so it re-shards onto the mesh the checkpoint was saved from (a
manifest of another host count is refused). Counterpart of
``repro.checkpoint.manager``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..tree import named_leaves, tree_unflatten

__all__ = ["CheckpointManager"]


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory (never a view of a CPU tensor,
    which a later in-place update would change under an async save)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name: _host(leaf) for name, leaf in named_leaves(tree)}


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_id: Optional[int] = None, async_save: bool = False,
                 group=None):
        self.dir = directory
        self.keep = keep
        self.group = group
        self.n_hosts = 1 if group is None else dist.get_world_size(group)
        if host_id is None:
            host_id = 0 if group is None else dist.get_rank(group)
        self.host_id = host_id
        if async_save and self.n_hosts > 1:
            raise ValueError("an async save of a mesh's shards would call "
                             "its barriers from a thread: save in line")
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _barrier(self) -> None:
        if self.n_hosts > 1:
            dist.barrier(group=self.group)

    # ---------- save ----------

    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None):
        if self.async_save:
            self.wait()
            flat = _flatten(tree)       # the host snapshot, before the thread
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        else:
            self._write(step, _flatten(tree), extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        lead = self.host_id == 0
        if lead:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
        self._barrier()
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **flat)
        self._barrier()
        if lead:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "extra": extra,
                           "n_arrays": len(flat),
                           "n_hosts": self.n_hosts}, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        self._barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------- restore ----------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], template: Any
                ) -> Tuple[Any, Dict]:
        """Restore into the structure, dtypes and devices of ``template``;
        ``step=None`` takes the latest committed step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("n_hosts", 1) != self.n_hosts:
            raise ValueError(
                f"step {step} holds the shards of {manifest['n_hosts']} "
                f"hosts; this mesh has {self.n_hosts}")
        leaves = []
        with np.load(os.path.join(path, f"shard_{self.host_id}.npz")) as data:
            for name, leaf in named_leaves(template):
                arr = data[name]
                if isinstance(leaf, torch.Tensor):
                    leaves.append(torch.as_tensor(arr).to(
                        device=leaf.device, dtype=leaf.dtype))
                else:
                    leaves.append(arr)
        return tree_unflatten(template, leaves), manifest
