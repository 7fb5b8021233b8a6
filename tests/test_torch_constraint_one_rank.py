"""The constraint engine backend against the JAX package's (at one gloo
rank: GCN in three modes and DP against the reference's constraint
backend and the port's explicit one, the streamed epoch, the gates,
constrain's refusals and the train functions); the tests of
``tests/torch_constraint_cases.py``."""
import torch_constraint_cases as h
from torch_constraint_cases import one_rank  # noqa: F401
from torch_constraint_cases import references  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_one_rank_matches_reference_and_explicit',
    'test_streamed_epoch_matches_in_memory',
    'test_streamed_gates_keep_reference_messages',
    'test_constrain_moves_only_what_is_free',
    'test_unknown_backend_and_bad_specs',
    'test_constraint_train_fns_train'))
