"""Collectives of the sharded solves over ``torch.distributed``.

:mod:`.sharding` holds the mesh axis a sharded solve runs over
(:class:`~.sharding.MeshAxis`: its process group, size and this rank's
index), the distributed log-sum-exp :func:`~.sharding.psum_logsumexp` and
the differentiable boundaries :func:`~.sharding.shard_rows` /
:func:`~.sharding.replicate`. ``MeshContext``, ``logical_spec`` and
``shard`` of the JAX package serve its LM models and wait for their port.
Counterpart of ``repro.distributed``.
"""
from .sharding import MeshAxis, psum_logsumexp, replicate, shard_rows

__all__ = ["MeshAxis", "psum_logsumexp", "replicate", "shard_rows"]
