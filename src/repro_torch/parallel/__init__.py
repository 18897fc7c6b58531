"""The sharding plan on ``torch.distributed`` (the JAX package's
``repro.parallel``): the spec rules, the plan, the Sharder."""
from repro_torch.parallel.sharding import (
    P,
    ShardingPlan,
    batch_spec,
    batch_specs,
    cache_specs_tree,
    make_plan,
    opt_state_specs,
    param_specs,
    placements,
)

__all__ = [
    "P",
    "ShardingPlan",
    "make_plan",
    "param_specs",
    "opt_state_specs",
    "batch_spec",
    "batch_specs",
    "cache_specs_tree",
    "placements",
]
