from .sharding import (
    ShardedState,
    SlabState,
    make_mesh,
    shard_state,
    sharded_step_fn,
    state_sharding,
    unshard_state,
)
from .halo import gathered_ops, halo_exchange_z, jacobi_3d_sharded
