"""Mamba2's SSD plain versions against the Pallas kernel and the JAX
package (the intra-chunk plain version, the fused and chunked paths, the
wrapper's refusal of CPU tensors); the tests of
``tests/torch_ssd_cases.py``."""
import torch_ssd_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_intra_chunk_plain_version_matches_pallas',
    'test_fused_matches_pallas_and_dense_oracle',
    'test_plain_chunked_matches_jnp',
    'test_kernel_wrapper_takes_cuda_tensors_only'))
