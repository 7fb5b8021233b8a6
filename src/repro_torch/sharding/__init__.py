"""LM sharding: the rules, the per-rank sharders and parameter placement
— the port of ``repro/sharding``."""
from .explicit import ExplicitSharder  # noqa: F401
from .specs import (MEGATRON_ITEM, SERVING_ITEM, ShardingRules,  # noqa: F401
                    Sharder, gather_params, make_sharder, place_params)
