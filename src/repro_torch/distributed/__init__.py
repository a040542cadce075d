from repro_torch.distributed.sharding import (
    AbstractMesh,
    NamedSharding,
    batch_sharding,
    cache_sharding,
    param_sharding,
    shard_params,
    sharded_step,
)

__all__ = ["param_sharding", "batch_sharding", "cache_sharding", "shard_params",
           "AbstractMesh", "NamedSharding", "sharded_step"]
