"""The LM configs this port added, at reduced(), against the JAX package
(Qwen1.5-4B: the weight bridge, forward, loss, prefill and greedy
generation; the seven configs' bf16 init trees; the registry); the tests
of ``tests/torch_lm_configs_cases.py``."""
import torch_lm_configs_cases as h
from torch_lm_configs_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

ARCHS = ('qwen1.5-4b',)
ref = h.ref_fixture(ARCHS)
globals().update(take_tests(
    h,
    'test_weight_bridge_round_trip',
    'test_forward_aux_and_loss',
    'test_prefill_logits_and_caches',
    'test_generate_greedy'))
globals().update(take_tests(
    h,
    'test_init_dtype_tree_bf16_matches_reference',
    'test_registry_and_unported_configs'))
