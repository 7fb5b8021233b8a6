"""The LM's sharding rules against the JAX package's, no processes (the
parameter names, shapes and specs of minitron-8b, musicgen-large,
qwen1.5-4b); the tests of ``tests/torch_lm_shard_specs_cases.py``."""
import torch_lm_shard_specs_cases as h
from torch_lm_shard_specs_cases import one_torch_thread  # noqa: F401
from torch_lm_shard_specs_cases import reference_trees  # noqa: F401
from torch_split import take_tests

ARCHS = ('minitron-8b', 'musicgen-large', 'qwen1.5-4b')
globals().update(take_tests(h, arch=ARCHS))
