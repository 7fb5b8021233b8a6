"""The constraint engine backend against the JAX package's (at four spawned
gloo ranks on three meshes: loss, grads, ledgers, transitions and the
streamed epoch); the tests of ``tests/torch_constraint_cases.py``."""
import torch_constraint_cases as h
from torch_constraint_cases import four_ranks  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_four_ranks_match_reference_and_explicit',
    'test_four_ranks_transitions_record_implied_collectives',
    'test_four_ranks_streamed_epoch_matches_in_memory'))
