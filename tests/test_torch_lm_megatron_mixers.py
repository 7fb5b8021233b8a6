"""The megatron strategy's training at four gloo ranks against the JAX
package's megatron (Zamba2 and DeepSeek-V2-Lite reduced on the three
meshes); the cases of ``tests/torch_lm_megatron_cases.py``, one spawn of
four ranks beside one JAX child."""
import torch_lm_megatron_cases as h
from torch_lm_megatron_cases import results  # noqa: F401
from torch_split import take_tests

CFGS = ("zamba", "mla")
globals().update(take_tests(h, cfg_name=CFGS))
