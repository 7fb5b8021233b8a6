"""Hybrid DP×TP against the JAX package (resolve_mesh_shape on 1 to 8
devices, the replica block's refusal, and four spawned gloo ranks on
(data 2, model 2) and (pod 2, data 1, model 2)); the tests of
``tests/torch_hybrid_cases.py``."""
import torch_hybrid_cases as h
from torch_hybrid_cases import four_ranks  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h, 'test_resolve_mesh_shape_matches_reference', n_devices=range(1, 9)))
globals().update(take_tests(
    h,
    'test_replica_block_refuses_to_floor',
    'test_four_ranks_hybrid_matches_reference'))
