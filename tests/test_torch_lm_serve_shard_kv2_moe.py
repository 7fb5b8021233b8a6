"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (two kv heads, and the MoE config's expert-parallel prefill, on
(data 1, model 4)); the cases of
``tests/torch_lm_serve_shard_cases.py``, one spawn of four ranks beside
one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/kv2/False', '1x4/moe/False')
globals().update(take_tests(h, name=NAMES))
