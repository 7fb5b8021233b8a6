"""The sharded step's audit under remat at four gloo ranks on (data 1,
model 4) and (data 2, model 2): ring attention and the expert-parallel
MoE; the tests of ``tests/torch_lm_shard_ledger_cases.py``, one spawn of
four ranks."""
import torch_lm_shard_ledger_cases as h
from torch_lm_shard_ledger_cases import ledgers  # noqa: F401
from torch_split import take_tests

NAMES = h.AUDITED
AUDIT = True
globals().update(take_tests(h, 'test_sharded_step_audit_clean'))
