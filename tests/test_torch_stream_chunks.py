"""The port's out-of-core streaming against the JAX package's, on the CPU
(the chunk inputs and half plans, stage's bytes and refusal, and two
spawned gloo ranks); the tests of ``tests/torch_stream_cases.py``."""
import torch_stream_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_host_chunk_inputs_match_reference',
    'test_blocksparse_half_plans_are_the_derived_arrays',
    'test_stage_records_h2d_bytes_and_copies',
    'test_stage_refuses_a_pageable_source_for_a_card',
    'test_two_ranks_match_in_memory'))
