"""The sharded LM forward and gradients at four gloo ranks against the JAX
package's unsharded oracle on (pod 2, data 1, model 2), the production
mesh's shape: GQA's all-to-all mixing, the expert-parallel MoE, Zamba2
reduced with its conv halo and the scoring forward, DeepSeek-V2-Lite
reduced, the dp strategy and the plain sharder's ring config; the cases
of ``tests/torch_lm_shard_cases.py``, one spawn of four ranks."""
import torch_lm_shard_cases as h
from torch_lm_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('gqa-kv-a2a', 'moe-ep', 'mamba-halo', 'mla', 'dp', 'plain-ring')
MESH_NAMES = ("pod",)
globals().update(take_tests(h, "test_sharded_loss_and_grads_match_reference",
                            case=NAMES, mesh_name=MESH_NAMES))
globals().update(take_tests(
    h, 'test_conv_halo_and_scoring_forward', mesh_name=MESH_NAMES))
