from .composite import make_sharded_render
from .mesh import make_band_mesh
from .shard import (
    ShardSpec,
    migration_rounds_for_speed,
    ShardedState,
    band_of_positions,
    make_shard_spec,
    shard_state,
    state_sharding,
    unshard_state,
)
from .sharded_step import check_diags, make_sharded_step

__all__ = [
    "ShardSpec",
    "check_diags",
    "migration_rounds_for_speed",
    "ShardedState",
    "band_of_positions",
    "make_band_mesh",
    "make_shard_spec",
    "make_sharded_render",
    "make_sharded_step",
    "shard_state",
    "state_sharding",
    "unshard_state",
]
