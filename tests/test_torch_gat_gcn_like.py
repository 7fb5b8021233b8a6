"""GAT, SAGE, GIN and R-GCN under TP against the JAX package (SAGE, GIN and
R-GCN train steps at one gloo rank, the refusals, and GAT at two spawned
gloo ranks); the tests of ``tests/torch_gat_cases.py``."""
import torch_gat_cases as h
from torch_gat_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_gcn_like_one_rank_train_steps_match_jax',
    'test_unsupported_paths_raise',
    'test_gat_two_ranks_match_reference'))
