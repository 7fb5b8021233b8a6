"""Mamba2's SSD plain versions against the Pallas kernel and the JAX
package (the mamba2 block forward, prefill then decode, and the three-
pass TF32 split); the tests of ``tests/torch_ssd_cases.py``."""
import torch_ssd_cases as h
from torch_ssd_cases import mamba  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_mamba2_forward',
    'test_mamba2_prefill_then_decode',
    'test_tf32_three_pass_split_keeps_the_kernel_hold',
    'test_tf32_three_pass_split_keeps_nan'))
