"""Multihost launch and per-rank placement against the JAX package (four
processes from the env contract alone: each rank's placed TP, DP and
stream bundles, and GCN decoupled and naive and DP at model 4 against
the reference); the tests of ``tests/torch_multihost_cases.py``."""
import torch_multihost_cases as h
from torch_multihost_cases import four_ranks  # noqa: F401
from torch_split import take_tests

NAMES = ('gcn-decoupled', 'gcn-naive', 'dp')
globals().update(take_tests(
    h,
    'test_env_contract_alone_places_every_rank',
    'test_placed_tp_bundle_holds_one_block',
    'test_placed_dp_bundle_holds_one_partition',
    'test_placed_stream_bundle_holds_its_labels_and_masks'))
globals().update(take_tests(h, name=NAMES))
