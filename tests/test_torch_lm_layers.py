"""Zamba2-2.7B serving and scoring against the JAX package (the config's
fields and layer groups, the full-depth init tree, SyntheticLM, the
caches, GQA attention with bias, window and softcap, and the layer
primitives); the tests of ``tests/torch_lm_zamba_cases.py``."""
import torch_lm_zamba_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_config_fields_equal_reference',
    'test_layer_groups',
    'test_init_tree_matches_reference_at_full_depth',
    'test_synthetic_lm_byte_equal',
    'test_init_caches_match_reference',
    'test_gqa_attention_with_bias_window_softcap',
    'test_layer_primitives'))
