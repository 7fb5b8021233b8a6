"""Modality prefixes and the ten configs against the JAX package (the
parameter counts of deepseek-v2-lite-16b, gemma2-9b, granite-
moe-1b-a400m, internlm2-1.8b, internvl2-1b, full and reduced;
SyntheticLM batches with a prefix; the serving example on the CPU); the
tests of ``tests/torch_lm_prefix_cases.py``."""
import torch_lm_prefix_cases as h
from torch_lm_prefix_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

NAMES = ('deepseek-v2-lite-16b', 'deepseek-v2-lite-16b-reduced', 'gemma2-9b', 'gemma2-9b-reduced', 'granite-moe-1b-a400m', 'granite-moe-1b-a400m-reduced', 'internlm2-1.8b', 'internlm2-1.8b-reduced', 'internvl2-1b', 'internvl2-1b-reduced')
globals().update(take_tests(
    h, 'test_param_counts_equal_reference', name=NAMES))
globals().update(take_tests(
    h, 'test_synthetic_batches_with_prefix', 'test_serve_example_runs_on_cpu'))
