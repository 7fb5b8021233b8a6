"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (the plain Sharder on the MoE and the ring configs); the cases
of ``tests/torch_lm_serve_shard_cases.py``, one spawn of four ranks
beside one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/plain-moe/model', '1x4/plain-ring/False')
globals().update(take_tests(h, name=NAMES))
