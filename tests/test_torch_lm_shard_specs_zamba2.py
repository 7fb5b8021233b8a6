"""The LM's sharding rules against the JAX package's, no processes (the
parameter names, shapes and specs of zamba2-2.7b; every activation
kind's spec; the refusals and sharded serving on a one-rank mesh); the
tests of ``tests/torch_lm_shard_specs_cases.py``."""
import torch_lm_shard_specs_cases as h
from torch_lm_shard_specs_cases import one_torch_thread  # noqa: F401
from torch_lm_shard_specs_cases import reference_trees  # noqa: F401
from torch_split import take_tests

ARCHS = ('zamba2-2.7b',)
globals().update(take_tests(h, arch=ARCHS))
globals().update(take_tests(
    h,
    'test_act_specs_and_fit_equal_reference',
    'test_unported_strategy_and_serving_raise'))
