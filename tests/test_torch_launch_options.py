"""The serving and sharding options the dry-run passes, against the JAX
package's, no processes.

* ``serve_step_spec`` for every config, at decode_32k and, where the
  dry-run runs it, long_500k: the token's and every cache leaf's shape and
  dtype equal to the reference's ``jax.eval_shape`` ones.
* ``prefill(last_only=True)``: the logits of the final position alone,
  equal to the last position of the full prefill and to the reference's
  ``last_only`` prefill (Zamba2 reduced, gemma2 reduced with its
  softcaps), and the same caches.
* ``forward(return_final_hidden=True)``: the final norm's output, equal
  to the reference's, and unembedded it gives ``forward``'s logits.
* ``ShardingRules(fsdp=False)``: every leaf's spec equal to the
  reference's under the three strategies on stand-in meshes (the embed
  dims stay whole over the data axes)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.nn.param import split_params
from repro.serve import engine as jengine
from repro.sharding import specs as jspecs
from repro_torch import configs
from repro_torch.launch.dryrun import LONG_CONTEXT_ARCHS
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.nn import param as tparam
from repro_torch.params import to_numpy_tree
from repro_torch.serve import serve_step_spec
from repro_torch.sharding import specs as tspecs
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

TOL = 1e-5
PROMPT = 24


def _held(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _cache_fields(caches):
    return [getattr(c, f.name) for unit in caches for c in unit
            for f in dataclasses.fields(c) if f.name != "window"]


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_serve_step_spec_matches_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shapes = ["decode_32k"] + (["long_500k"] if arch in LONG_CONTEXT_ARCHS
                               else [])
    for name in shapes:
        lc = name == "long_500k"
        token, caches = serve_step_spec(cfg, configs.get_shape(name),
                                        long_context=lc)
        jtoken, jcaches = jengine.serve_step_spec(
            jcfg, jconfigs.INPUT_SHAPES[name], long_context=lc)
        assert token.shape == jtoken.shape
        assert str(token.dtype).removeprefix("torch.") == str(jtoken.dtype)
        got, want = _cache_fields(caches), jax.tree.leaves(jcaches)
        assert len(got) == len(want), name
        reps = [g.repeats for g, unit in zip(TB.layer_groups(cfg), caches)
                for c in unit for f in dataclasses.fields(c)
                if f.name != "window"]
        for g, w, r in zip(got, want, reps):
            if isinstance(g, int):
                # a length: shared by a group's repeats, where the
                # reference's scan stacks one a repeat
                assert w.shape == (() if r == 1 else (r,)), (name, w)
                assert str(w.dtype) == "int32"
                continue
            assert g.device.type == "meta"
            assert (tuple(g.shape), str(g.dtype).removeprefix("torch.")) \
                == (w.shape, str(w.dtype)), name


def _reference_model(arch):
    """The port's weights of ``arch`` reduced (fp32), the reference's
    config, and a prompt."""
    cfg = dataclasses.replace(configs.get_config(arch + "-reduced"),
                              dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               dtype="float32")
    params = TT.init_transformer(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return cfg, jcfg, params, tokens


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma2-9b"])
def test_prefill_last_only_matches_reference(arch):
    cfg, jcfg, params, tokens = _reference_model(arch)
    max_len = PROMPT + 4
    with torch.no_grad():
        full, caches = TT.prefill(params, cfg, torch.from_numpy(tokens),
                                  max_len=max_len)
        last, caches_last = TT.prefill(params, cfg, torch.from_numpy(tokens),
                                       max_len=max_len, last_only=True)
    assert last.shape == (2, 1, cfg.padded_vocab)
    _held(last, full[:, -1:].numpy())
    for a, b in zip(_cache_fields(caches_last), _cache_fields(caches)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    want, _ = jax.jit(lambda p, t: JT.prefill(
        p, jcfg, t, max_len=max_len, last_only=True))(
            to_numpy_tree(params), jnp.asarray(tokens))
    _held(last, want)


def test_forward_return_final_hidden_matches_reference():
    cfg, jcfg, params, tokens = _reference_model("deepseek-v2-lite-16b")
    with torch.no_grad():
        hidden, aux = TT.forward(params, cfg, torch.from_numpy(tokens),
                                 return_final_hidden=True)
        logits, aux2 = TT.forward(params, cfg, torch.from_numpy(tokens))
    assert hidden.shape == (2, PROMPT, cfg.d_model)
    assert hidden.dtype == torch.float32
    assert torch.equal(aux, aux2)
    assert torch.equal(TT.unembed(params, cfg, hidden), logits)
    want, jaux = jax.jit(lambda p, t: JT.forward(
        p, jcfg, t, return_final_hidden=True))(to_numpy_tree(params),
                                               jnp.asarray(tokens))
    _held(hidden, want)
    assert abs(aux.item() - float(jaux)) <= TOL * max(1.0, abs(float(jaux)))


def test_sharding_rules_without_fsdp_match_reference():
    meshes = {"16x16": ({"data": 16, "model": 16}, ("data",)),
              "pod": ({"pod": 2, "data": 2, "model": 4}, ("pod", "data"))}
    for arch in jconfigs.list_archs():
        cfg = jconfigs.get_config(arch)
        vals, names = split_params(jax.eval_shape(
            lambda k, c=cfg: JT.init_transformer(k, c),
            jax.random.PRNGKey(0)))
        shapes = jax.tree.map(lambda v: tuple(v.shape), vals)
        assert tparam.param_names(configs.get_config(arch)) == names
        for shape, data_axes in meshes.values():
            mesh = types.SimpleNamespace(shape=shape)
            for strategy in ("neutron_tp", "megatron", "dp"):
                ref = jspecs.ShardingRules(strategy, data_axes=data_axes,
                                           fsdp=False)
                port = tspecs.ShardingRules(strategy, data_axes=data_axes,
                                            fsdp=False)
                want = jax.tree.map(
                    lambda n, s: tuple(tuple(e) if isinstance(e, list)
                                       else e
                                       for e in ref.param_spec(n, s, mesh)),
                    names, shapes, is_leaf=lambda x: isinstance(x, tuple))
                got = port.param_shardings(names, shapes, mesh)
                assert got == want, (arch, strategy)
                flat = [e for sp in jax.tree.leaves(
                    got, is_leaf=lambda x: isinstance(x, tuple))
                    for e in sp]
                assert not any(a in data_axes for e in flat if e
                               for a in (e if isinstance(e, tuple)
                                         else (e,))), (arch, strategy)
