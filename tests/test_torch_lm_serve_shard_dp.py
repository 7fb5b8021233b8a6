"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving (the dp strategy: the latent cache's dp and "model" quirk, and a
batch of one on a data axis of two); the cases of
``tests/torch_lm_serve_shard_cases.py``, one spawn of four ranks beside
one JAX child."""
import torch_lm_serve_shard_cases as h
from torch_lm_serve_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/dp-mla/model', '2x2/dp-gqa/True')
globals().update(take_tests(h, name=NAMES))
