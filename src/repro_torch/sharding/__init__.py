"""Sharding: logical activation axes + parameter-spec rules engine."""
from repro_torch.sharding.logical import axis_rules, decode_rules, shard, train_rules  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    RuleReport,
    ShardingPolicy,
    bytes_per_device,
    choose_policy,
    distribute_params,
    param_shardings,
    param_specs,
)
from repro_torch.sharding.spec import PartitionSpec, spec_placements  # noqa: F401
