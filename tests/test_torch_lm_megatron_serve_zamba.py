"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (Zamba2-2.7B reduced, heads on the model axis
at model 4 and the sequence over the data axes on the pod mesh); the
cases of ``tests/torch_lm_megatron_serve_cases.py``, one spawn of four
ranks beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/zamba/False', 'pod/zamba/True')
globals().update(take_tests(h, name=NAMES))
