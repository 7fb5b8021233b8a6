"""Hybrid DP×TP against the JAX package (resolve_mesh_shape on 9 to 16
devices); the tests of ``tests/torch_hybrid_cases.py``."""
import torch_hybrid_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h, 'test_resolve_mesh_shape_matches_reference', n_devices=range(9, 17)))
