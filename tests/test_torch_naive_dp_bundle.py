"""Naive TP and the DP halo-exchange baseline against the JAX package (the
DP bundle's arrays on the three backends and both balances); the tests
of ``tests/torch_naive_dp_cases.py``."""
import torch_naive_dp_cases as h
from torch_split import take_tests

globals().update(take_tests(h, 'test_dp_bundle_arrays_equal'))
