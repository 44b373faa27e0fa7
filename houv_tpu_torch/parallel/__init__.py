"""Multi-GPU over torch.distributed: meshes of ranks, exact collectives,
the pair- and restart-sharded HOUV solves and the data-parallel gradient
(``mesh.py``); process groups and the launch of ranks
(``distributed.py``)."""

from houv_tpu_torch.parallel.mesh import (
    data_parallel_grads,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    sharded_houv_solve,
    sharded_houv_solve_2d,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "sharded_houv_solve",
    "sharded_houv_solve_2d",
    "replicate",
    "data_parallel_grads",
]
