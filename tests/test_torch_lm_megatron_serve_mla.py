"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (DeepSeek-V2-Lite reduced, its latent caches'
heads on the model axis at model 4 and their sequence over the data
axes, with the audit of a decode step); the cases of
``tests/torch_lm_megatron_serve_cases.py``, one spawn of four ranks
beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/mla/False', '2x2/mla/True')
globals().update(take_tests(h, name=NAMES))
