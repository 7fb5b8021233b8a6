"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (the gemma2-like and the MLA configs with the cache's sequence
over the data axes, and the audit of a decode step); the cases of
``tests/torch_lm_serve_shard_cases.py``, one spawn of four ranks beside
one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('2x2/gemma/True', '2x2/mla/True')
globals().update(take_tests(h, name=NAMES))
