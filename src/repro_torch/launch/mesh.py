"""Mesh builders: functions, not module constants, so importing this
module touches no process group.

A port mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing on a machine tells a program of its cluster). The axis
names are the JAX package's: ``("data", "model")``, with ``"pod"`` first
on the multi-pod mesh; a sharded solve runs over ``"data"``. The device
type defaults to the card (``"cuda"``, which raises without one); pass
``device="cpu"`` for gloo worlds on the host. Counterpart of
``repro.launch.mesh``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.backend import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh"]


def _mesh(shape: Tuple[int, ...], axes: Sequence[str],
          device: DeviceLike) -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks."""
    device_type = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first")
    n = math.prod(shape)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}: start a world "
                           f"of {n} ranks (one a card)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(2, 16, 16) pod x data x model multi-pod, or (16, 16) data x model
    single-pod, over the first 512 or 256 ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: DeviceLike = None) -> DeviceMesh:
    """A small (data, model) mesh over the first data * model ranks."""
    return _mesh((data, model), ("data", "model"), device)
