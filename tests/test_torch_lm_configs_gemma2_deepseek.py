"""The LM configs this port added, at reduced(), against the JAX package
(Gemma2-9B and DeepSeek-V2-Lite: the weight bridge, forward, loss,
prefill and greedy generation); the tests of
``tests/torch_lm_configs_cases.py``."""
import torch_lm_configs_cases as h
from torch_lm_configs_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

ARCHS = ('gemma2-9b', 'deepseek-v2-lite-16b')
ref = h.ref_fixture(ARCHS)
globals().update(take_tests(
    h,
    'test_weight_bridge_round_trip',
    'test_forward_aux_and_loss',
    'test_prefill_logits_and_caches',
    'test_generate_greedy'))
