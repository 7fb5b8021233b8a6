"""The megatron strategy's training at four gloo ranks against the JAX
package's megatron (the config with 3 heads and the tiny MoE on the
three meshes, and the row-parallel sums' formula at Zamba2-2.7B's full
size); the cases of ``tests/torch_lm_megatron_cases.py``, one spawn of
four ranks beside one JAX child."""
import torch_lm_megatron_cases as h
from torch_lm_megatron_cases import results  # noqa: F401
from torch_split import take_tests

CFGS = ("h3", "moe")
globals().update(take_tests(h, cfg_name=CFGS))
globals().update(take_tests(h, 'test_tp_psums_formula_at_full_size'))
