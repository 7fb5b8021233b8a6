"""The single-device trainer and the TP loss function against the JAX
package (the coupled forwards and gradients, the forward dispatch,
cross_entropy and accuracy, SGD); the tests of
``tests/torch_train_cases.py``."""
import torch_train_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_coupled_forward_and_grads_match_reference',
    'test_forward_dispatch_matches_reference',
    'test_gat_forward_matches_reference',
    'test_coupled_rgcn_needs_edge_types',
    'test_cross_entropy_and_accuracy_match_reference',
    'test_sgd_trajectory_matches_jax'))
