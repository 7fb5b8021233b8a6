"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (the tiny GQA config with the caches'
sequence over the data axes, on (data 2, model 2) and (pod 2, data 1,
model 2)); the cases of ``tests/torch_lm_megatron_serve_cases.py``, one
spawn of four ranks beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('2x2/gqa/True', 'pod/gqa/True')
globals().update(take_tests(h, name=NAMES))
