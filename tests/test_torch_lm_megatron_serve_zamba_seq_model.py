"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (Zamba2-2.7B reduced with the caches'
sequence over the model axis, at model 4 and model 2, with the audit of
a decode step); the cases of ``tests/torch_lm_megatron_serve_cases.py``,
one spawn of four ranks beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/zamba/model', '2x2/zamba/model')
globals().update(take_tests(h, name=NAMES))
