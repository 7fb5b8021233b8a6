"""The LM's sharding rules against the JAX package's, no processes (the
parameter names, shapes and specs of deepseek-v2-lite-16b, gemma2-9b,
granite-moe-1b-a400m); the tests of
``tests/torch_lm_shard_specs_cases.py``."""
import torch_lm_shard_specs_cases as h
from torch_lm_shard_specs_cases import one_torch_thread  # noqa: F401
from torch_lm_shard_specs_cases import reference_trees  # noqa: F401
from torch_split import take_tests

ARCHS = ('deepseek-v2-lite-16b', 'gemma2-9b', 'granite-moe-1b-a400m')
globals().update(take_tests(h, arch=ARCHS))
