"""GAT, SAGE, GIN and R-GCN under TP against the JAX package (GAT's train
steps and ledger at one gloo rank in every mode, the segment softmax,
every model's parameters and NN phase); the tests of
``tests/torch_gat_cases.py``."""
import torch_gat_cases as h
from torch_gat_cases import one_rank  # noqa: F401
from torch_gat_cases import one_device_ledgers  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_gat_one_rank_train_steps_match_jax',
    'test_gat_one_rank_ledger_matches_reference',
    'test_segment_softmax_matches_reference',
    'test_params_and_mlp_phase_match_reference'))
