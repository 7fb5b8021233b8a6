"""LM sharding: the rules, the per-rank sharders, parameter and cache
placement — the port of ``repro/sharding``."""
from .explicit import ExplicitSharder  # noqa: F401
from .specs import (ShardingRules, Sharder, cache_shardings,  # noqa: F401
                    gather_caches, gather_params, make_sharder,
                    place_caches, place_params)
