"""Blockwise attention, the ring cache, MLA and flash's plain version
against the JAX package (attention_blockwise, the GQA blockwise impl,
the window cache and a windowed decode past the window); the tests of
``tests/torch_lm_attention_cases.py``."""
import torch_lm_attention_cases as h
from torch_lm_attention_cases import one_torch_thread  # noqa: F401
from torch_lm_attention_cases import gemma_attn  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_attention_blockwise_matches_reference',
    'test_blockwise_equals_naive_attention',
    'test_gqa_attention_blockwise_impl',
    'test_fill_window_cache',
    'test_windowed_decode_past_the_window'))
