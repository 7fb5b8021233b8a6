"""Naive TP and the DP halo-exchange baseline against the JAX package
(naive TP's train steps at one gloo rank on the three backends, and at
two spawned ranks); the tests of ``tests/torch_naive_dp_cases.py``."""
import torch_naive_dp_cases as h
from torch_naive_dp_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_naive_one_rank_train_steps_match_jax',
    'test_naive_two_ranks_match_single_device_reference'))
