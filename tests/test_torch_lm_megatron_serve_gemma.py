"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving (the gemma2-like config's ring caches at
long_context, heads on the model axis at model 4 and the sequence over
the data axes); the cases of ``tests/torch_lm_megatron_serve_cases.py``,
one spawn of four ranks beside one JAX child."""
import torch_lm_megatron_serve_cases as h
from torch_lm_megatron_serve_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('1x4/gemma/False', '2x2/gemma/True')
globals().update(take_tests(h, name=NAMES))
