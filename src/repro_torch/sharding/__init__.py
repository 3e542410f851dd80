"""Sharding rules and the ambient sharding context (the port's
``repro.sharding``)."""
from repro_torch.sharding.ctx import current_rules, set_rules, shard_hint  # noqa: F401
from repro_torch.sharding.rules import ShardingRules, make_rules, param_shardings, input_shardings  # noqa: F401
