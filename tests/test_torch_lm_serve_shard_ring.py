"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (six heads on four ranks: ring attention in prefill, in two
cache layouts); the cases of ``tests/torch_lm_serve_shard_cases.py``,
one spawn of four ranks beside one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/ring/model', '1x4/ring/False')
globals().update(take_tests(h, name=NAMES))
