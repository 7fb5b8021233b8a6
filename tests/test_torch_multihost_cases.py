"""Multihost launch and per-rank placement against the JAX package (four
processes from the env contract alone: GCN under the constraint backend,
GAT decoupled-pipelined and hybrid GCN on (data 2, model 2) against the
reference); the tests of ``tests/torch_multihost_cases.py``."""
import torch_multihost_cases as h
from torch_multihost_cases import four_ranks  # noqa: F401
from torch_split import take_tests

NAMES = ('gcn-decoupled-constraint', 'gat-decoupled_pipelined', 'hybrid-gcn-decoupled')
globals().update(take_tests(h, name=NAMES))
