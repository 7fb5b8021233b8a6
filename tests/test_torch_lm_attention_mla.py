"""Blockwise attention, the ring cache, MLA and flash's plain version
against the JAX package (MLA's leaves, prefill, absorbed decode and
cache, and flash's plain version at new shapes); the tests of
``tests/torch_lm_attention_cases.py``."""
import torch_lm_attention_cases as h
from torch_lm_attention_cases import one_torch_thread  # noqa: F401
from torch_lm_attention_cases import mla  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_mla_leaves',
    'test_mla_prefill_matches_reference',
    'test_mla_absorbed_decode',
    'test_mla_cache_init_matches_reference',
    'test_flash_plain_version_at_new_shapes'))
