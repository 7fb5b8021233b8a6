"""The single-device trainer and the TP loss function against the JAX
package (train_full_graph's epoch logs, and make_tp_loss_fn at one gloo
rank and at two spawned ranks); the tests of
``tests/torch_train_cases.py``."""
import torch_train_cases as h
from torch_train_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_train_full_graph_matches_reference',
    'test_tp_loss_fn_one_rank_matches',
    'test_tp_loss_fn_two_ranks_matches'))
