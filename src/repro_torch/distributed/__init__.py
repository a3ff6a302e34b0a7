"""Collectives of the sharded solves over ``torch.distributed``.

:mod:`.sharding` holds the mesh axis a sharded solve runs over
(:class:`~.sharding.MeshAxis`: its process group, size and this rank's
index), the distributed log-sum-exp :func:`~.sharding.psum_logsumexp` and
the differentiable boundaries :func:`~.sharding.shard_rows` /
:func:`~.sharding.replicate`. ``MeshContext``, ``logical_spec`` and
``shard`` of the JAX package shard its LM models over many cards and wait
for the multi-card slice (ROADMAP.md §A item 8d). :mod:`.fault_tolerance`
holds the training supervisor. Counterpart of ``repro.distributed``.
"""
from .fault_tolerance import (
    FaultToleranceConfig,
    TrainingSupervisor,
    remesh_plan,
    suggest_save_every,
)
from .sharding import MeshAxis, psum_logsumexp, replicate, shard_rows

__all__ = ["FaultToleranceConfig", "MeshAxis", "TrainingSupervisor",
           "psum_logsumexp", "remesh_plan", "replicate", "shard_rows",
           "suggest_save_every"]
