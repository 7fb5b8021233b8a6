"""The sharded LM forward and gradients at four gloo ranks against the JAX
package's unsharded oracle, on (data 1, model 4) and (data 2, model 2)
(GQA mixing: kv heads by all-to-all and by gather, blockwise attention,
a windowed ring); the cases of ``tests/torch_lm_shard_cases.py``, one
spawn of four ranks."""
import torch_lm_shard_cases as h
from torch_lm_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('gqa-kv-a2a', 'gqa-kv-gather', 'gqa-blockwise', 'ring-gqa-window')
globals().update(take_tests(h, "test_sharded_loss_and_grads_match_reference",
                            case=NAMES, mesh_name=tuple(h.MESHES)))
