"""The explicit sharder's collectives against the JAX package's at four
gloo ranks on (data 1, model 4) and (data 2, model 2), and the linter on
the port; the tests of ``tests/torch_lm_shard_ledger_cases.py``, one
spawn of four ranks beside one JAX child."""
import torch_lm_shard_ledger_cases as h
from torch_lm_shard_ledger_cases import ledgers  # noqa: F401
from torch_split import take_tests

NAMES = h.EXPLICIT
globals().update(take_tests(
    h,
    'test_explicit_ledger_matches_reference',
    'test_linter_clean_on_the_port'))
