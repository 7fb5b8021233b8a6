"""The port's collective ledger against the JAX package's (the ring wire
factors of ppermute and psum_scatter; one step's ledger at two spawned
gloo ranks); the tests of ``tests/torch_comm_ledger_cases.py``."""
import torch_comm_ledger_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_ring_wire_factor_matches_reference',
    op=("ppermute", "psum_scatter")))
globals().update(take_tests(h, 'test_two_ranks_ledger_matches_reference'))
