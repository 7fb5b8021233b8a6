"""The SpMM's plain versions against the Pallas kernel in interpret mode
(the compressed-row SpMM at d = 41); the tests of
``tests/torch_spmm_cases.py``."""
import torch_spmm_cases as h
from torch_spmm_cases import cases  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h, 'test_spmm_csr_ref_matches_tiles_and_pallas', d=(41,)))
