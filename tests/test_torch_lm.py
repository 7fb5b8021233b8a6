"""The port's Zamba2 LM path against the JAX package on ``zamba2-2.7b``
reduced (6 layers = (mamba, mamba, shared_attn) × 2, d=256, GQA 4 over 2
heads, 16 SSD heads, chunk 16), fp32, with ``attn_impl="flash",
ssm_impl="fused"`` (the plain versions on the port's CPU side) and with
naive + jnp: config fields, layer groups, the weight bridge, forward
logits and ``lm_loss`` against the JAX package on the same impl (Pallas in
interpret mode), prefill logits and caches, greedy ``generate`` (identical
tokens; logits within 1e-4·(1 + max|ref|)) and decode logits against one
JAX run on naive + jnp (its flash + fused path agrees with that to ~1e-6),
and ``SyntheticLM`` batches byte for byte."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.models import blocks as JB
from repro.models import transformer as JT
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.params import from_numpy_tree, to_numpy_tree, tree_leaves
from repro_torch.serve import generate
from repro_torch.serve.engine import make_serve_fns
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import (ExplicitSharder, Sharder, ShardingRules,
                                  place_params)
from repro_torch.train import make_train_step

IMPLS = [("flash", "fused"), ("naive", "jnp")]
RTOL = 1e-4
PROMPT, STEPS = 24, 8


def _held(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * (1 + np.abs(want).max()), err


def _np_values(jparams):
    return jax.tree.map(lambda l: np.asarray(l.value), jparams,
                        is_leaf=lambda x: hasattr(x, "names"))


@pytest.fixture(scope="module")
def model():
    cfg = j_get_config("zamba2-2.7b").reduced()
    params = _np_values(jax.jit(lambda k: JT.init_transformer(k, cfg))(
        jax.random.PRNGKey(0)))
    data = JSyntheticLM(cfg.vocab_size, seed=0)
    batch = next(data.batches(2, 32))
    return cfg, params, batch


def _cfgs(cfg, impl):
    attn, ssm = impl
    return (dataclasses.replace(cfg, attn_impl=attn, ssm_impl=ssm),
            dataclasses.replace(get_config("zamba2-2.7b-reduced"),
                                attn_impl=attn, ssm_impl=ssm))


@pytest.mark.parametrize("name", ["zamba2-2.7b", "zamba2-2.7b-reduced"])
def test_config_fields_equal_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        j_get_config(name))


def test_unported_options_raise(model, tmp_path):
    cfg = get_config("zamba2-2.7b")
    assert dataclasses.replace(cfg, attn_impl="blockwise").attn_impl == \
        "blockwise"
    with pytest.raises(ValueError, match="attn_impl='ring'"):
        dataclasses.replace(cfg, attn_impl="ring")
    # a sharded step is made (the sharded LM, ROADMAP item 25a, is
    # ported), under the megatron strategy too
    mesh = types.SimpleNamespace(shape={"model": 4, "data": 2})
    sharder = Sharder(mesh, ShardingRules())
    assert callable(make_train_step(get_config("internvl2-1b"), adamw(1e-3),
                                    sharder=sharder))
    megatron = Sharder(mesh, ShardingRules("megatron"))
    assert megatron.megatron and not sharder.megatron
    assert callable(make_train_step(get_config("internvl2-1b"), adamw(1e-3),
                                    sharder=megatron))
    # sharded serving runs: Zamba2 reduced under the explicit
    # sharder on a one-rank mesh gives the unsharded prefill and decode
    # logits
    cfg, params, batch = model
    tcfg, tp = get_config("zamba2-2.7b-reduced"), from_numpy_tree(params,
                                                                  "cpu")
    tokens = torch.as_tensor(batch["tokens"][:, :PROMPT])
    with torch.no_grad():
        prefill_fn, decode_fn = make_serve_fns(tcfg)
        want, caches = prefill_fn(tp, tokens, max_len=PROMPT + 1)
        want_step = decode_fn(tp, tokens[:, :1], caches)[0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        sharder = ExplicitSharder(make_host_mesh(model=1, data=1),
                                  ShardingRules())
        shards = place_params(tp, tcfg, sharder)
        with torch.no_grad():
            prefill_fn, decode_fn = make_serve_fns(tcfg, sharder)
            got, caches = prefill_fn(shards, tokens, max_len=PROMPT + 1)
            _held(got, want.numpy(), 1e-6)
            _held(decode_fn(shards, tokens[:, :1], caches)[0],
                  want_step.numpy(), 1e-6)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["zamba2-2.7b", "zamba2-2.7b-reduced"])
def test_layer_groups(name):
    got = [(g.unit, g.repeats) for g in TB.layer_groups(get_config(name))]
    want = [(g.unit, g.repeats)
            for g in JB.layer_groups(j_get_config(name))]
    assert got == want


def test_weight_bridge_round_trip(model):
    _, params, _ = model
    tp = from_numpy_tree(params, "cpu")
    back = to_numpy_tree(tp)
    jl, treedef = jax.tree.flatten(params)
    assert len(jl) == len(tree_leaves(tp)) == 30
    assert jax.tree.structure(back) == treedef
    for a, b in zip(jl, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_tree_matches_reference_at_full_depth():
    """The port's own init gives the reference's tree — key paths, shapes,
    dtypes, 57 leaves — at zamba2's full depth (narrow widths)."""
    narrow = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                  d_ff=64, vocab_size=96, ssm_state_dim=16, ssm_head_dim=32)
    jcfg = dataclasses.replace(j_get_config("zamba2-2.7b"), **narrow)
    want = jax.eval_shape(lambda: JT.init_transformer(
        jax.random.PRNGKey(0), jcfg))
    want = jax.tree.map(lambda l: (l.value.shape, str(l.value.dtype)), want,
                        is_leaf=lambda x: hasattr(x, "names"))
    tp = TT.init_transformer(
        dataclasses.replace(get_config("zamba2-2.7b"), **narrow), seed=0,
        device="cpu")
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)), to_numpy_tree(tp))
    assert len(jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, tuple))) == 57
    assert got == want


def test_cast_compute_matches_reference(model):
    cfg, params, _ = model
    want = JT._cast_compute(params, jnp.bfloat16)
    got = TT._cast_compute(from_numpy_tree(params, "cpu"), torch.bfloat16)
    assert jax.tree.map(lambda a: str(jnp.asarray(a).dtype), want) == \
        jax.tree.map(lambda a: str(a.dtype).removeprefix("torch."),
                     got)


@pytest.fixture(scope="module")
def ref_cfg(model):
    """The JAX reference on naive + jnp: one run serves both of the port's
    impls (the reference's flash + fused path agrees with it to ~1e-6)."""
    cfg, _, _ = model
    return _cfgs(cfg, IMPLS[1])[0]


@pytest.fixture(scope="module")
def ref_prefill(model, ref_cfg):
    _, params, batch = model
    return jax.jit(lambda p, t: JT.prefill(
        p, ref_cfg, t, max_len=PROMPT + STEPS))(params,
                                                batch["tokens"][:, :PROMPT])


@pytest.mark.parametrize("impl", IMPLS, ids=["flash-fused", "naive-jnp"])
def test_forward_and_lm_loss(model, impl):
    """Scoring, the path that runs both kernels, against the reference on
    the same impl."""
    cfg, params, batch = model
    jcfg, tcfg = _cfgs(cfg, impl)

    def j_loss(p, tokens, targets):
        logits, _ = JT.forward(p, jcfg, tokens)
        return logits, JT.lm_loss(logits, targets)
    logits_j, loss_j = jax.jit(j_loss)(params, batch["tokens"],
                                       batch["targets"])
    with torch.no_grad():
        logits_t, aux = TT.forward(from_numpy_tree(params, "cpu"), tcfg,
                                   torch.from_numpy(batch["tokens"]))
        loss_t = TT.lm_loss(logits_t, torch.from_numpy(batch["targets"]))
    assert aux.item() == 0.0
    _held(logits_t, logits_j)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))


@pytest.mark.parametrize("impl", IMPLS, ids=["flash-fused", "naive-jnp"])
def test_prefill_logits_and_caches(model, impl, ref_prefill):
    cfg, params, batch = model
    _, tcfg = _cfgs(cfg, impl)
    logits_j, caches_j = ref_prefill
    with torch.no_grad():
        logits_t, caches_t = TT.prefill(
            from_numpy_tree(params, "cpu"), tcfg,
            torch.from_numpy(batch["tokens"][:, :PROMPT]),
            max_len=PROMPT + STEPS)
    _held(logits_t, logits_j)
    flat_j = jax.tree.leaves(caches_j)
    flat_t = []
    for unit in caches_t:
        for c in unit:
            flat_t += [getattr(c, f.name) for f in dataclasses.fields(c)]
    assert len(flat_t) == len(flat_j) == 3 * 3   # 2 SSM + 1 KV cache
    for t, j in zip(flat_t, flat_j):
        if isinstance(t, int):
            assert np.all(np.asarray(j) == t)
        else:
            _held(t, j)


@pytest.fixture(scope="module")
def ref_generate(model, ref_cfg):
    _, params, batch = model
    return j_engine.generate(params, ref_cfg, batch["tokens"][:, :PROMPT],
                             STEPS)


@pytest.mark.parametrize("impl", IMPLS, ids=["flash-fused", "naive-jnp"])
def test_generate_greedy(model, impl, ref_generate):
    cfg, params, batch = model
    _, tcfg = _cfgs(cfg, impl)
    prompt = batch["tokens"][:, :PROMPT]
    got = generate(from_numpy_tree(params, "cpu"), tcfg, prompt, STEPS,
                   device="cpu")
    assert got.tokens.shape == (2, PROMPT + STEPS)
    np.testing.assert_array_equal(got.tokens,
                                  np.asarray(ref_generate.tokens))
    _held(got.prefill_logits, ref_generate.prefill_logits)


def test_decode_step_logits(model, ref_cfg, ref_prefill):
    """Teacher-forced decode steps: logits of every step within tolerance."""
    cfg, params, batch = model
    _, tcfg = _cfgs(cfg, IMPLS[0])
    tokens = batch["tokens"]
    _, caches_j = ref_prefill
    step_j = jax.jit(lambda p, t, c: JT.decode_step(p, ref_cfg, t, c))
    tp = from_numpy_tree(params, "cpu")
    with torch.no_grad():
        _, caches_t = TT.prefill(tp, tcfg, torch.from_numpy(
            tokens[:, :PROMPT]), max_len=PROMPT + STEPS)
        for i in range(PROMPT, PROMPT + STEPS):
            tok = tokens[:, i:i + 1]
            logits_j, caches_j = step_j(params, tok, caches_j)
            logits_t, caches_t = TT.decode_step(tp, tcfg,
                                                torch.from_numpy(tok),
                                                caches_t)
            _held(logits_t, logits_j)
    assert caches_t[0][0].length == PROMPT + STEPS


def test_synthetic_lm_byte_equal():
    for seed, vocab in ((0, 32000), (3, 1024)):
        j, t = JSyntheticLM(vocab, seed=seed), SyntheticLM(vocab, seed=seed)
        for _ in range(2):
            bj, bt = next(j.batches(2, 64)), next(t.batches(2, 64))
            assert bj.keys() == bt.keys()
            for k in bj:
                assert bj[k].dtype == bt[k].dtype
                assert bj[k].tobytes() == bt[k].tobytes()


def test_init_caches_match_reference():
    cfg = j_get_config("zamba2-2.7b").reduced()
    want = JT.init_caches(cfg, 2, 40, dtype=jnp.bfloat16)
    got = TT.init_caches(get_config("zamba2-2.7b-reduced"), 2, 40,
                         dtype=torch.bfloat16, device="cpu")
    flat_t = [getattr(c, f.name) for unit in got for c in unit
              for f in dataclasses.fields(c)]
    flat_j = jax.tree.leaves(want)
    assert len(flat_t) == len(flat_j) == 9
    for t, j in zip(flat_t, flat_j):
        if isinstance(t, int):
            assert t == 0 and not np.asarray(j).any()
        else:
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            assert not t.any()


def test_unembed_pad_vocab_and_softcap(model):
    cfg, params, _ = model
    jcfg = dataclasses.replace(cfg, pad_vocab_to=1000, logit_softcap=3.0)
    tcfg = dataclasses.replace(get_config("zamba2-2.7b-reduced"),
                               pad_vocab_to=1000, logit_softcap=3.0)
    assert jcfg.padded_vocab == tcfg.padded_vocab == 2000
    rng = np.random.default_rng(7)
    p = {"head": rng.standard_normal((cfg.d_model, 2000), np.float32)}
    x = rng.standard_normal((2, 3, cfg.d_model), np.float32)
    want = JT.unembed(p, jcfg, jnp.asarray(x))
    got = TT.unembed(from_numpy_tree(p, "cpu"), tcfg, torch.from_numpy(x))
    _held(got[..., :1024], np.asarray(want)[..., :1024])
    assert (got[..., 1024:] == -1e30).all()
    assert (np.asarray(want)[..., 1024:] == -1e30).all()


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_gqa_attention_with_bias_window_softcap(impl):
    from repro.nn import attention as JA
    from repro_torch.nn import attention as TA
    jcfg = dataclasses.replace(j_get_config("zamba2-2.7b").reduced(),
                               qkv_bias=True, attn_softcap=5.0,
                               attn_impl=impl, attn_block_q=16,
                               attn_block_kv=16)
    tcfg = dataclasses.replace(get_config("zamba2-2.7b-reduced"),
                               qkv_bias=True, attn_softcap=5.0,
                               attn_impl=impl)
    p = _np_values(JA.init_attention(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(8)
    p = {k: v + 0.1 * rng.standard_normal(v.shape, np.float32)
         for k, v in p.items()}                    # nonzero biases
    x = rng.standard_normal((2, 40, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40))
    want = jax.jit(lambda p, x: JA.gqa_attention(p, jcfg, x, pos,
                                                 window=12))(p, x)
    got = TA.gqa_attention(from_numpy_tree(p, "cpu"), tcfg,
                           torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           window=12)
    _held(got, want)


def test_layer_primitives():
    from repro.nn import layers as JL
    from repro_torch.nn import layers as TL
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 16), np.float32)
    w = rng.standard_normal(16, np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    tx = torch.from_numpy(x)
    for plus_one in (False, True):
        _held(TL.rms_norm(tx, torch.from_numpy(w), 1e-6, plus_one),
              JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one))
    _held(TL.softcap(tx, 2.0), JL.softcap(jnp.asarray(x), 2.0))
    _held(TL.apply_rope(tx, torch.from_numpy(pos), 500.0),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))
    mp = {k: {"w": rng.standard_normal(s, np.float32) / 4}
          for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                       ("down", (24, 16)))}
    for act in ("silu", "gelu", "relu"):
        _held(TL.mlp(from_numpy_tree(mp, "cpu"), tx, act),
              JL.mlp(mp, jnp.asarray(x), act))
