"""Flash attention's plain version against the Pallas kernel in interpret
mode (shape sweep, GQA groups, dtypes, window and softcap, non-causal);
the tests of ``tests/torch_flash_cases.py``."""
import torch_flash_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_shape_sweep',
    'test_gqa_groups',
    'test_dtypes',
    'test_window_and_softcap',
    'test_non_causal'))
