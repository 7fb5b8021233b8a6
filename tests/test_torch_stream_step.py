"""The port's out-of-core streaming against the JAX package's, on the CPU
(the streamed step at one gloo rank against the reference and the in-
memory step, its ledger, SAGE and GIN, the gates and the primitives);
the tests of ``tests/torch_stream_cases.py``."""
import torch_stream_cases as h
from torch_stream_cases import one_rank  # noqa: F401
from torch_stream_cases import reference  # noqa: F401
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_streamed_step_matches_reference_and_in_memory',
    'test_streamed_gcn_like_models_match_reference',
    'test_one_step_ledger',
    'test_stripes_padding_apart_from_chunks_matches_in_memory',
    'test_streamability_gates',
    'test_primitives_without_a_card',
    'test_backward_scope_records_backward_calls'))
