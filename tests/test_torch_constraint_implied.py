"""The constraint engine backend against the JAX package's
(implied_collectives of every transition, and transition records apart
from the counters); the tests of ``tests/torch_constraint_cases.py``."""
import torch_constraint_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_implied_collectives_match_reference',
    'test_transition_records_are_kept_apart_from_counters'))
