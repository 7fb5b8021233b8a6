"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (Zamba2 reduced and the MoE config on (data 2, model 2)); the
cases of ``tests/torch_lm_serve_shard_cases.py``, one spawn of four
ranks beside one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('2x2/zamba/model', '2x2/moe/False')
globals().update(take_tests(h, name=NAMES))
