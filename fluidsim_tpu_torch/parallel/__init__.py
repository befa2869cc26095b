from .sharding import (
    make_mesh,
    shard_state,
    sharded_step_fn,
    state_sharding,
)
from .halo import halo_exchange_z, jacobi_3d_sharded
