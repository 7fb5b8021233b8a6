"""The port's collective ledger against the JAX package's (the ring wire
factors of psum, all_gather and all_to_all; as_dict, its crossing
between the packages and recording only while collecting); the tests of
``tests/torch_comm_ledger_cases.py``."""
import torch_comm_ledger_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_ring_wire_factor_matches_reference',
    op=("psum", "all_gather", "all_to_all")))
globals().update(take_tests(
    h,
    'test_as_dict_round_trip_and_queries',
    'test_ledger_dicts_cross_between_packages',
    'test_record_only_while_collecting'))
