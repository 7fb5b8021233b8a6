"""The port's MoE against the JAX package's (moe_apply and its aux across
capacity factors, dropless, wider routing and shared experts); the tests
of ``tests/torch_moe_cases.py``."""
import torch_moe_cases as h
from torch_moe_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_moe_apply_across_capacity',
    'test_moe_dropless',
    'test_moe_dropless_is_per_token',
    'test_moe_wider_routing',
    'test_shared_experts_are_added'))
