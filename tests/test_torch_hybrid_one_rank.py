"""Hybrid DP×TP against the JAX package (at hybrid_mesh(1, 1) in process:
GCN in three modes and two backends, GAT and DP, the bundle degrees and
the stream gate); the tests of ``tests/torch_hybrid_cases.py``."""
import torch_hybrid_cases as h
from torch_hybrid_cases import one_rank  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_one_rank_hybrid_matches_reference',
    'test_bundle_degrees_must_match_mesh',
    'test_hybrid_mesh_is_not_streamable'))
