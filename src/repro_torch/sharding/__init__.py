"""LM sharding: the rules, the per-rank sharders, parameter and cache
placement — the port of ``repro/sharding``."""
from .explicit import ExplicitSharder  # noqa: F401
from .specs import (MEGATRON_ITEM, ShardingRules, Sharder,  # noqa: F401
                    cache_shardings, gather_caches, gather_params,
                    make_sharder, place_caches, place_params)
