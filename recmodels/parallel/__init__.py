from recmodels.parallel.mesh import make_mesh, DATA_AXIS
from recmodels.parallel.sharded_embedding import ShardedTables
from recmodels.parallel.train_step import (
    build_parallel_accum,
    build_parallel_engine,
    build_parallel_scan,
    build_parallel_steps,
    shard_state,
    state_specs,
)

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "ShardedTables",
    "build_parallel_accum",
    "build_parallel_engine",
    "build_parallel_scan",
    "build_parallel_steps",
    "shard_state",
    "state_specs",
]
