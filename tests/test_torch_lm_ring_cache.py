"""gemma2's sliding-window ring cache (``long_context=True``) through the
whole model, reduced to 4 layers — (local, global) × 2 repeats, window 64 —
against the JAX package on the reference's weights, fp32 on the CPU:
greedy ``generate`` past the window (naive and the flash kernel's plain
version), the ring caches stacked over repeats with ``window`` shared, the
caches and each teacher-forced decode step's logits equal to the
reference's, the ring equal to the dense cache inside the window, and
``init_caches(long_context=True)``.  Tolerances as in
``test_torch_lm_configs_*.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as JT
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.nn import attention as TA
from repro_torch.params import from_numpy_tree
from repro_torch.serve import generate
from torch_lm_configs_cases import (KERNEL_IMPLS, _flat_caches, _held,
                                   _held_caches, _np_values,
                                   one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def gemma4():
    """gemma2 reduced at 4 layers: (local, global) × 2 repeats, so each
    unit position's cache is stacked over the repeats."""
    jcfg = dataclasses.replace(j_get_config("gemma2-9b").reduced(),
                               num_layers=4)
    tcfg = dataclasses.replace(get_config("gemma2-9b-reduced"),
                               num_layers=4)
    params = _np_values(jax.jit(lambda k: JT.init_transformer(k, jcfg))(
        jax.random.PRNGKey(1)))
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 80)).astype(np.int32)
    return jcfg, tcfg, params, prompt


def test_ring_cache_generate_past_the_window(gemma4):
    """80 prompt tokens and 12 greedy steps with ``long_context=True``
    (window 64): tokens and prefill logits as the reference's."""
    jcfg, tcfg, params, prompt = gemma4
    want = j_engine.generate(params, jcfg, prompt, 12, long_context=True)
    for cfg in (tcfg, dataclasses.replace(tcfg, **KERNEL_IMPLS)):
        got = generate(from_numpy_tree(params, "cpu"), cfg, prompt, 12,
                       long_context=True, device="cpu")
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        _held(got.prefill_logits, want.prefill_logits)


def test_ring_cache_stacked_over_repeats(gemma4):
    """Prefill at ``long_context``: the local layers' ring caches stacked
    over 2 repeats (``window`` shared, not stacked), the global layers'
    dense; equal to the reference's caches after prefill and after 20
    teacher-forced decode steps, the logits of each step held."""
    jcfg, tcfg, params, prompt = gemma4
    tp = from_numpy_tree(params, "cpu")
    tokens = prompt[:, :60]
    logits_j, caches_j = JT.prefill(params, jcfg, tokens, max_len=100,
                                    long_context=True)
    with torch.no_grad():
        logits_t, caches_t = TT.prefill(tp, tcfg, torch.from_numpy(tokens),
                                        max_len=100, long_context=True)
    local, glob = caches_t[0]
    assert isinstance(local, TA.WindowKVCache) and local.window == 64
    assert tuple(local.k.shape) == (2, 2, 64, jcfg.num_kv_heads,
                                    jcfg.head_dim)
    assert isinstance(glob, TA.KVCache) and glob.k.shape[:3] == (2, 2, 100)
    _held(logits_t, logits_j)
    _held_caches(caches_t, caches_j)
    step_j = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    ring = local.k
    with torch.no_grad():
        for i in range(20):
            tok = prompt[:, 60 + i:61 + i]
            lj, caches_j = step_j(params, tok, caches_j)
            lt, caches_t = TT.decode_step(tp, tcfg, torch.from_numpy(tok),
                                          caches_t)
            _held(lt, lj)
    assert caches_t[0][0].k is ring and caches_t[0][0].length == 80
    _held_caches(caches_t, caches_j)


def test_ring_equals_dense_cache_inside_the_window(gemma4):
    """Inside the window the ring cache and the dense cache decode alike
    (past it they differ, in the reference too: its dense-cache decode of
    a local layer has no window)."""
    _, tcfg, params, prompt = gemma4
    tp = from_numpy_tree(params, "cpu")
    with torch.no_grad():
        out = []
        for long_context in (False, True):
            logits, caches = TT.prefill(tp, tcfg, torch.from_numpy(
                prompt[:, :40]), max_len=64, long_context=long_context)
            steps = [logits]
            for i in range(40, 64):
                lt, caches = TT.decode_step(
                    tp, tcfg, torch.from_numpy(prompt[:, i:i + 1]), caches)
                steps.append(lt)
            out.append(steps)
    for a, b in zip(*out):
        _held(a, b.numpy())


def test_init_caches_long_context_match_reference(gemma4):
    jcfg, tcfg, _, _ = gemma4
    want = JT.init_caches(jcfg, 2, 100, dtype=jnp.bfloat16,
                          long_context=True)
    got = TT.init_caches(tcfg, 2, 100, dtype=torch.bfloat16, device="cpu",
                         long_context=True)
    flat_t, flat_j = _flat_caches(got), jax.tree.leaves(want)
    assert len(flat_t) == len(flat_j) == 6
    for t, j in zip(flat_t, flat_j):
        if isinstance(t, int):
            assert t == 0 and not np.asarray(j).any()
        else:
            assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
    assert got[0][0].window == 64
