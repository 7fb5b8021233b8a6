"""Flash attention's plain version against the Pallas kernel in interpret
mode (asymmetric head dims, the JAX oracle head-major, the kernel
wrapper's device and dtype routing); the tests of
``tests/torch_flash_cases.py``."""
import torch_flash_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_asymmetric_head_dims',
    'test_plain_version_matches_jax_oracle_head_major',
    'test_kernel_wrapper_takes_cuda_tensors_only',
    'test_kernel_wrapper_routes_by_dtype'))
