from .sharding import (ShardingRules, batch_sharding, current_mesh,
                       param_spec, params_shardings, replicated, shard,
                       use_mesh)

__all__ = ["ShardingRules", "batch_sharding", "current_mesh", "param_spec",
           "params_shardings", "replicated", "shard", "use_mesh"]
