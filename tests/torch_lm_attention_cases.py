"""The port's attention beyond plain GQA against the JAX package, fp32 on
the CPU, on the same numpy inputs and weights: ``attention_blockwise``
(ragged Sq/Skv, GQA, window, softcap, ``q_offset``, hd_v ≠ hd), the
sliding-window ring cache (its fill and windowed decode steps past the
window, also against a full windowed recompute), MLA (prefill logits and
its compressed cache, the absorbed-matmul decode, also against the port's
own full-sequence MLA), and the flash kernel's plain version at MLA's
hd=192/hd_v=128 and at hd=256 with a window and a softcap against the
Pallas kernel in interpret mode.  Held to |Δ| ≤ 1e-5·(1 + max|ref|)
(sums in another order), the flash cases to the 2e-5 of
``test_torch_flash_*.py``.

The tests are spread over ``tests/test_torch_lm_attention_*.py``
(``tests/torch_split.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.nn import attention as JA
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.nn import attention as TA
from repro_torch.params import from_numpy_tree
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

TOL = 1e-5


def _held(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


def _np_values(tree):
    return jax.tree.map(lambda l: np.asarray(l.value), tree,
                        is_leaf=lambda x: hasattr(x, "names"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# attention_blockwise
# ---------------------------------------------------------------------------

BLOCKWISE = [
    # b, sq, skv, hq, hkv, hd, hdv, causal, window, softcap, q_offset, bq, bkv
    (2, 40, 40, 4, 2, 16, 16, True, None, None, 0, 16, 16),
    (1, 33, 65, 4, 4, 16, 16, True, None, None, 32, 16, 32),
    (2, 48, 48, 8, 2, 32, 32, True, 12, None, 0, 16, 16),
    (1, 37, 37, 4, 1, 16, 16, True, 10, 5.0, 0, 8, 16),
    (2, 20, 50, 4, 2, 16, 16, False, None, 3.0, 0, 16, 16),
    (1, 24, 56, 4, 4, 24, 16, True, 40, None, 32, 16, 16),
]


@pytest.mark.parametrize(
    "case", BLOCKWISE,
    ids=lambda c: f"sq{c[1]}-skv{c[2]}-g{c[3] // c[4]}-hd{c[5]}.{c[6]}"
                  f"{'' if c[7] else '-full'}-w{c[8]}-cap{c[9]}-off{c[10]}")
def test_attention_blockwise_matches_reference(case):
    b, sq, skv, hq, hkv, hd, hdv, causal, window, cap, off, bq, bkv = case
    rng = np.random.default_rng(sum(case[:7]))
    q = rng.standard_normal((b, sq, hq, hd), np.float32)
    k = rng.standard_normal((b, skv, hkv, hd), np.float32)
    v = rng.standard_normal((b, skv, hkv, hdv), np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off,
              block_q=bq, block_kv=bkv)
    want = JA.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = TA.attention_blockwise(_t(q), _t(k), _t(v), **kw)
    _held(got, want)


def test_blockwise_equals_naive_attention():
    """The port's blockwise scan against its own dense attention_core."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.standard_normal((2, 45, h, 16), np.float32))
               for h in (4, 2, 2))
    mask = TA._window_mask(45, 45, 0, 9)[None]
    want = TA.attention_core(q, k, v, mask, softcap=4.0)
    got = TA.attention_blockwise(q, k, v, window=9, softcap=4.0,
                                 block_q=16, block_kv=8)
    _held(got, want.numpy())


def test_gqa_attention_blockwise_impl():
    """``attn_impl="blockwise"`` through ``gqa_attention`` (biases, window,
    softcap) against the reference on the same impl and block sizes."""
    kw = dict(qkv_bias=True, attn_softcap=5.0, attn_impl="blockwise",
              attn_block_q=16, attn_block_kv=32)
    jcfg = dataclasses.replace(j_get_config("gemma2-9b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("gemma2-9b-reduced"), **kw)
    p = _np_values(JA.init_attention(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(8)
    p = {n: a + 0.1 * rng.standard_normal(a.shape, np.float32)
         for n, a in p.items()}
    x = rng.standard_normal((2, 50, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(50)[None], (2, 50))
    want = JA.gqa_attention(p, jcfg, x, pos, window=20)
    got = TA.gqa_attention(from_numpy_tree(p, "cpu"), tcfg, _t(x),
                           _t(pos), window=20)
    _held(got, want)


# ---------------------------------------------------------------------------
# Sliding-window ring cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma_attn():
    jcfg = j_get_config("gemma2-9b").reduced()        # window 64, cap 50
    tcfg = get_config("gemma2-9b-reduced")
    p = _np_values(JA.init_attention(jax.random.PRNGKey(5), jcfg))
    return jcfg, tcfg, p


@pytest.mark.parametrize("s", [40, 64, 100, 150])
def test_fill_window_cache(gemma_attn, s):
    jcfg, _, _ = gemma_attn
    w = jcfg.sliding_window
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, s, 2, 64), np.float32)
    v = rng.standard_normal((2, s, 2, 64), np.float32)
    want = JA._fill_window_cache(jcfg, jnp.asarray(k), jnp.asarray(v), w)
    got = TA._fill_window_cache(_t(k), _t(v), w)
    assert got.window == want.window == w and got.length == s
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_windowed_decode_past_the_window(gemma_attn):
    """Prefill 70 tokens into the 64-slot ring, then 70 decode steps (the
    ring wraps twice more): each step's output against the reference's
    ``gqa_decode_windowed`` and against a full windowed recompute; the
    ring's tensors are written in place."""
    jcfg, tcfg, p = gemma_attn
    w, s0, n = jcfg.sliding_window, 70, 70
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, s0 + n, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(s0 + n)[None], (2, s0 + n))
    tp = from_numpy_tree(p, "cpu")
    y_j, c_j = JA.gqa_prefill(p, jcfg, x[:, :s0], pos[:, :s0], s0 + n,
                              window=w, long_context=True)
    y_t, c_t = TA.gqa_prefill(tp, tcfg, _t(x[:, :s0]), _t(pos[:, :s0]),
                              s0 + n, window=w, long_context=True)
    assert isinstance(c_t, TA.WindowKVCache) and c_t.window == w
    _held(y_t, y_j)
    _held(c_t.k, c_j.k)
    full = TA.gqa_attention(tp, tcfg, _t(x), _t(pos), window=w)
    step_j = jax.jit(lambda p, x, c: JA.gqa_decode_windowed(p, jcfg, x, c))
    ring = c_t.k
    for i in range(s0, s0 + n):
        y_j, c_j = step_j(p, x[:, i:i + 1], c_j)
        y_t, c_t = TA.gqa_decode_windowed(tp, tcfg, _t(x[:, i:i + 1]), c_t)
        _held(y_t, y_j)
        _held(y_t, full[:, i:i + 1].numpy())
    assert c_t.length == s0 + n and c_t.k is ring
    _held(c_t.k, c_j.k)
    _held(c_t.v, c_j.v)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg = j_get_config("deepseek-v2-lite-16b").reduced()
    tcfg = get_config("deepseek-v2-lite-16b-reduced")
    p = _np_values(JA.init_attention(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(9)
    p["kv_norm"] = p["kv_norm"] + 0.1 * rng.standard_normal(
        p["kv_norm"].shape, np.float32)
    x = rng.standard_normal((2, 30, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(30)[None], (2, 30))
    return jcfg, tcfg, p, x, pos


def test_mla_leaves(mla):
    jcfg, tcfg, p, _, _ = mla
    got = TA.init_attention(torch.Generator().manual_seed(0), tcfg)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: a.shape for n, a in p.items()}
    assert sorted(got) == ["kv_norm", "wk_b", "wkv_a", "wo", "wq", "wv_b"]


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flash"])
def test_mla_prefill_matches_reference(mla, impl):
    """Prefill output and the compressed cache; the full-sequence attention
    runs at the hd + rope_hd scale on every impl (flash: the kernel's plain
    version with hd=96 ≠ hd_v=64 here)."""
    jcfg, tcfg, p, x, pos = mla
    kw = dict(attn_impl=impl, attn_block_q=16, attn_block_kv=16)
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    y_j, c_j = JA.mla_prefill(p, jcfg, x[:, :20], pos[:, :20], 30)
    y_t, c_t = TA.mla_prefill(from_numpy_tree(p, "cpu"), tcfg,
                              _t(x[:, :20]), _t(pos[:, :20]), 30)
    _held(y_t, y_j)
    _held(c_t.c_kv, c_j.c_kv)
    _held(c_t.k_rope, c_j.k_rope)
    assert c_t.length == 20 == int(c_j.length)
    _held(TA.mla_attention(from_numpy_tree(p, "cpu"), tcfg, _t(x[:, :20]),
                           _t(pos[:, :20])), y_j)


def test_mla_absorbed_decode(mla):
    """Ten absorbed decode steps on the compressed cache: against the
    reference's ``mla_decode`` and against the port's own full-sequence
    MLA recomputed over every token so far (its last row)."""
    jcfg, tcfg, p, x, pos = mla
    tp = from_numpy_tree(p, "cpu")
    _, c_j = JA.mla_prefill(p, jcfg, x[:, :20], pos[:, :20], 30)
    _, c_t = TA.mla_prefill(tp, tcfg, _t(x[:, :20]), _t(pos[:, :20]), 30)
    full = TA.mla_attention(tp, tcfg, _t(x), _t(pos))
    step_j = jax.jit(lambda p, x, c: JA.mla_decode(p, jcfg, x, c))
    latents = c_t.c_kv
    for i in range(20, 30):
        y_j, c_j = step_j(p, x[:, i:i + 1], c_j)
        y_t, c_t = TA.mla_decode(tp, tcfg, _t(x[:, i:i + 1]), c_t)
        _held(y_t, y_j)
        _held(y_t, full[:, i:i + 1].numpy())
    assert c_t.length == 30 and c_t.c_kv is latents
    _held(c_t.c_kv, c_j.c_kv)
    _held(c_t.k_rope, c_j.k_rope)


def test_mla_cache_init_matches_reference(mla):
    jcfg, tcfg, _, _, _ = mla
    want = JA.init_mla_cache(jcfg, 2, 40, jnp.bfloat16)
    got = TA.init_mla_cache(tcfg, 2, 40, torch.bfloat16, "cpu")
    for name in ("c_kv", "k_rope"):
        t, j = getattr(got, name), getattr(want, name)
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert not t.any()
    assert got.length == 0


# ---------------------------------------------------------------------------
# The flash kernel's plain version at this slice's new shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,s,hd,hdv,window,cap", [
    (4, 4, 40, 192, 128, None, None),      # MLA: (128 + 64 rope) / 128
    (4, 2, 48, 256, 256, 16, 50.0),        # gemma2 local: window, softcap
], ids=["mla-192-128", "gemma2-256-window-softcap"])
def test_flash_plain_version_at_new_shapes(hq, hkv, s, hd, hdv, window, cap):
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((1, s, hq, hd), np.float32)
    k = rng.standard_normal((1, s, hkv, hd), np.float32)
    v = rng.standard_normal((1, s, hkv, hdv), np.float32)
    scale = hd ** -0.5 if window else (hd ** -0.5) * 1.5
    kw = dict(causal=True, window=window, softcap=cap, scale=scale)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   interpret=True, block_q=16, block_kv=16, **kw)
    got = flash_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
