"""Modality prefixes and the ten configs against the JAX package (the
fields of mamba2-1.3b, minitron-8b, musicgen-large, qwen1.5-4b,
zamba2-2.7b, full and reduced; the init tree with mm_proj); the tests of
``tests/torch_lm_prefix_cases.py``."""
import torch_lm_prefix_cases as h
from torch_lm_prefix_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

NAMES = ('mamba2-1.3b', 'mamba2-1.3b-reduced', 'minitron-8b', 'minitron-8b-reduced', 'musicgen-large', 'musicgen-large-reduced', 'qwen1.5-4b', 'qwen1.5-4b-reduced', 'zamba2-2.7b', 'zamba2-2.7b-reduced')
globals().update(take_tests(
    h, 'test_config_fields_equal_reference', name=NAMES))
globals().update(take_tests(h, 'test_init_tree_with_mm_proj'))
