"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (the cache's sequence over the data axes at batch 1, on (data 2,
model 2) and on (pod 2, data 1, model 2)); the cases of
``tests/torch_lm_serve_shard_cases.py``, one spawn of four ranks beside
one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('2x2/gqa/True', 'pod/gqa/True')
globals().update(take_tests(h, name=NAMES))
