"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (the tiny GQA config on (data 1, model 4),
its caches' heads and then their sequence over the model axis); the
cases of ``tests/torch_lm_megatron_serve_cases.py``, one spawn of four
ranks beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/gqa/False', '1x4/gqa/model')
globals().update(take_tests(h, name=NAMES))
