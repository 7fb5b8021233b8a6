"""The port's collective ledger against the JAX package's (one step's
ledger at one gloo rank in every mode and depth; a backward on another
thread); the tests of ``tests/torch_comm_ledger_cases.py``."""
import torch_comm_ledger_cases as h
from torch_comm_ledger_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_one_rank_ledger_matches_reference',
    'test_backward_on_another_thread_records_into_forward_ledgers'))
