"""The LM configs this port added, at reduced(), against the JAX package
(the seven configs' fields, full and reduced); the tests of
``tests/torch_lm_configs_cases.py``."""
import torch_lm_configs_cases as h
from torch_lm_configs_cases import one_torch_thread  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(h, 'test_config_fields_equal_reference'))
