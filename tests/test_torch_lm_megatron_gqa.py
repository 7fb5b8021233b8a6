"""The megatron strategy's training at four gloo ranks against the JAX
package's megatron (the tiny GQA configs with 8 heads and with 2 kv
heads on the three meshes, the explicit sharder's refusal and two
sharded_setup AdamW steps of Granite-MoE reduced); the cases of
``tests/torch_lm_megatron_cases.py``, one spawn of four ranks beside one
JAX child."""
import torch_lm_megatron_cases as h
from torch_lm_megatron_cases import results  # noqa: F401
from torch_split import take_tests

CFGS = ("gqa", "kv2")
WITH_STEP = True
globals().update(take_tests(h, cfg_name=CFGS))
globals().update(take_tests(
    h,
    'test_explicit_sharder_declines_under_megatron',
    'test_two_sharded_adamw_steps_match_reference'))
