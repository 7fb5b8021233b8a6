"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (the gemma2-like config's ring cache at long_context on (data 1,
model 4)); the cases of ``tests/torch_lm_serve_shard_cases.py``, one
spawn of four ranks beside one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/gemma/False', '1x4/gemma/model')
globals().update(take_tests(h, name=NAMES))
