"""The port's MoE against the JAX package's (the activations, the capacity,
the first dense layers' grouping and the MoE block's aux and output);
the tests of ``tests/torch_moe_cases.py``."""
import torch_moe_cases as h
from torch_moe_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_moe_activation',
    'test_capacity',
    'test_first_dense_layers_grouping',
    'test_moe_block_aux_and_output'))
