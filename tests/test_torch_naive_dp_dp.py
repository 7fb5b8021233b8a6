"""Naive TP and the DP halo-exchange baseline against the JAX package (the
DP baseline's train steps at one gloo rank on the three backends and at
two spawned ranks, and its refusals); the tests of
``tests/torch_naive_dp_cases.py``."""
import torch_naive_dp_cases as h
from torch_naive_dp_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_dp_one_rank_train_steps_match_jax',
    'test_dp_two_ranks_match_reference',
    'test_dp_rejects_unported_options'))
