"""The sharded LM forward and gradients at four gloo ranks against the JAX
package's unsharded oracle, on (data 1, model 4) and (data 2, model 2)
(Zamba2 reduced with its conv halo and the scoring forward,
DeepSeek-V2-Lite reduced, InternVL2-1B reduced behind its prefix); the
cases of ``tests/torch_lm_shard_cases.py``, one spawn of four ranks."""
import torch_lm_shard_cases as h
from torch_lm_shard_cases import results  # noqa: F401
from torch_split import take_tests

NAMES = ('mamba-halo', 'mla', 'vlm-prefix')
globals().update(take_tests(h, "test_sharded_loss_and_grads_match_reference",
                            case=NAMES, mesh_name=tuple(h.MESHES)))
globals().update(take_tests(h, "test_conv_halo_and_scoring_forward",
                            mesh_name=tuple(h.MESHES)))
