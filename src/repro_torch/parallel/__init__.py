"""Distribution substrate: sharding rules, collectives, pipeline parallelism
on `torch.distributed` (counterpart of `repro.parallel`)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    constrain,
    current_mesh,
    logical_spec,
    param_spec_tree,
    shardctx,
    zero1_spec,
)
from repro_torch.parallel.collectives import combine_partial_softmax  # noqa: F401
