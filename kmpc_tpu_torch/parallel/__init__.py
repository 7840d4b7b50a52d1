"""Parallelism layer on torch.distributed: the device mesh, placements, the
sharded programs (port of kmpc_tpu/parallel)."""

from kmpc_tpu_torch.parallel.distributed import (
    host_local_to_global,
    initialize_distributed,
    make_global_mesh,
    process_local_batch_size,
    scaling_report,
)
from kmpc_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    mesh_from_config,
    param_specs,
    replicate,
    shard_batch,
    shard_params,
    sharded_mpc_solver,
)

__all__ = [
    "host_local_to_global",
    "initialize_distributed",
    "make_global_mesh",
    "process_local_batch_size",
    "scaling_report",
    "make_mesh",
    "make_sharded_train_step",
    "mesh_from_config",
    "param_specs",
    "replicate",
    "shard_batch",
    "shard_params",
    "sharded_mpc_solver",
]
