"""The port's out-of-core streaming against the JAX package's, on the CPU
(the host feature stores, pad_features, the footprint contract and the
prefetch ordering); the tests of ``tests/torch_stream_cases.py``."""
import torch_stream_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_host_feature_store_matches_reference',
    'test_pad_features_matches_reference',
    'test_footprint_contract',
    'test_prefetched_is_double_buffered'))
