"""Collectives and logical axes of the port over ``torch.distributed``.

:mod:`.sharding` holds the mesh axis a sharded computation runs over
(:class:`~.sharding.MeshAxis`: its process group, size and this rank's
index), the distributed log-sum-exp :func:`~.sharding.psum_logsumexp`,
the differentiable boundaries :func:`~.sharding.shard_rows` /
:func:`~.sharding.replicate` and collectives (:func:`~.sharding.
all_gather`, :func:`~.sharding.all_to_all`, :func:`~.sharding.psum`,
:func:`~.sharding.pmean`, the halo :func:`~.sharding.from_previous`,
a leaf's differentiable gather :func:`~.sharding.gather_spec`), and the
LM models' logical axes and activation layout
(:class:`~.sharding.MeshContext`, :func:`~.sharding.mesh_context`,
:func:`~.sharding.use_mesh_context`,
:func:`~.sharding.seq_axis`, :func:`~.sharding.rows_axis`,
:func:`~.sharding.logical_spec`, :func:`~.sharding.shard`).
:mod:`.fault_tolerance` holds the training supervisor. Counterpart of
``repro.distributed``.
"""
from .fault_tolerance import (
    FaultToleranceConfig,
    TrainingSupervisor,
    remesh_plan,
    suggest_save_every,
)
from .sharding import (
    MeshAxis,
    MeshContext,
    PartitionSpec,
    all_gather,
    all_to_all,
    current_mesh_context,
    from_previous,
    gather_spec,
    logical_spec,
    mesh_context,
    pmean,
    psum,
    psum_logsumexp,
    replicate,
    rows_axis,
    seq_axis,
    shard,
    shard_rows,
    use_mesh_context,
)

__all__ = ["FaultToleranceConfig", "MeshAxis", "MeshContext",
           "PartitionSpec", "TrainingSupervisor", "all_gather", "all_to_all",
           "current_mesh_context", "from_previous", "gather_spec",
           "logical_spec", "mesh_context", "pmean", "psum",
           "psum_logsumexp", "remesh_plan", "replicate", "rows_axis",
           "seq_axis", "shard", "shard_rows", "suggest_save_every",
           "use_mesh_context"]
