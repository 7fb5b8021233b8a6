"""Zamba2-2.7B serving and scoring against the JAX package (reduced:
forward and loss, prefill, greedy generation and a decode step on both
impls, the weight bridge, the compute casts, unembed, and the options
that run under a sharder); the tests of
``tests/torch_lm_zamba_cases.py``."""
import torch_lm_zamba_cases as h
from torch_lm_zamba_cases import model  # noqa: F401
from torch_lm_zamba_cases import ref_cfg  # noqa: F401
from torch_lm_zamba_cases import ref_prefill  # noqa: F401
from torch_lm_zamba_cases import ref_generate  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_forward_and_lm_loss',
    'test_prefill_logits_and_caches',
    'test_generate_greedy',
    'test_decode_step_logits',
    'test_weight_bridge_round_trip',
    'test_cast_compute_matches_reference',
    'test_unembed_pad_vocab_and_softcap',
    'test_unported_options_raise'))
