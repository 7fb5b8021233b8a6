"""The SpMM's plain versions against the Pallas kernel in interpret mode
(the tile SpMM and aggregate_plan's forward and VJP, the empty plan, the
wrapper's refusal of CPU tensors and the plan's range check); the tests
of ``tests/torch_spmm_cases.py``."""
import torch_spmm_cases as h
from torch_spmm_cases import cases  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_spmm_ref_matches_pallas_interpret',
    'test_aggregate_plan_forward_and_vjp',
    'test_empty_plan_gives_zeros',
    'test_kernel_wrapper_refuses_cpu_tensors',
    'test_plan_dev_rejects_out_of_range_tiles'))
