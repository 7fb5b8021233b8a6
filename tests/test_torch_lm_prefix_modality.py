"""Modality prefixes and the ten configs against the JAX package
(InternVL2-1B and MusicGen-large reduced behind their prefixes:
assemble_inputs, forward, loss, prefill and greedy generation); the
tests of ``tests/torch_lm_prefix_cases.py``."""
import torch_lm_prefix_cases as h
from torch_lm_prefix_cases import one_torch_thread  # noqa: F401
from torch_lm_prefix_cases import ref  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_assemble_inputs',
    'test_missing_prefix_raises',
    'test_forward_and_loss',
    'test_prefill_logits_and_caches',
    'test_generate_greedy'))
