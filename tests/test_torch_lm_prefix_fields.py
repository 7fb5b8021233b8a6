"""Modality prefixes and the ten configs against the JAX package (the
fields of deepseek-v2-lite-16b, gemma2-9b, granite-moe-1b-a400m,
internlm2-1.8b, internvl2-1b, full and reduced; the registry and
INPUT_SHAPES); the tests of ``tests/torch_lm_prefix_cases.py``."""
import torch_lm_prefix_cases as h
from torch_lm_prefix_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

NAMES = ('deepseek-v2-lite-16b', 'deepseek-v2-lite-16b-reduced', 'gemma2-9b', 'gemma2-9b-reduced', 'granite-moe-1b-a400m', 'granite-moe-1b-a400m-reduced', 'internlm2-1.8b', 'internlm2-1.8b-reduced', 'internvl2-1b', 'internvl2-1b-reduced')
globals().update(take_tests(
    h, 'test_config_fields_equal_reference', name=NAMES))
globals().update(take_tests(
    h, 'test_registry_equals_reference', 'test_input_shapes_equal_reference'))
