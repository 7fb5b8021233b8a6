"""Multihost launch and per-rank placement against the JAX package (the env
contract's validation, the launcher in two processes and through the
launch script, and the timeouts); the tests of
``tests/torch_multihost_cases.py``."""
import torch_multihost_cases as h
from torch_split import take_tests

globals().update(take_tests(
    h,
    'test_initialize_rejects_bad_topology',
    'test_env_topology_parsing',
    'test_validation_texts_match_reference',
    'test_single_process_context_without_init',
    'test_topology_query_before_initialize_raises',
    'test_initialize_is_idempotent_and_owns_the_group',
    'test_cuda_ranks_share_the_host_threads',
    'test_host_threads_left_alone',
    'test_put_global_blocks_on_one_rank',
    'test_resolve_mesh_shape_note_names_process_topology',
    'test_ledger_roundtrip_and_merge',
    'test_launcher_prints_once_and_ranks_agree',
    'test_launch_script_runs_two_processes',
    'test_dead_coordinator_and_short_job_fail_within_timeout'))
