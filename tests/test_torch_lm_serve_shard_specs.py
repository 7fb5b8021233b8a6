"""The decode caches' sharding rules against the JAX package's, no
processes: ``act_spec`` of the two cache kinds (and its ``_fit_spec``) and
``cache_shardings`` of every config's caches — the reference's
``init_caches`` under ``jax.eval_shape``, stacked over a group's repeats
where the group repeats, at ``long_context`` too (gemma2's ring caches)
— under the three strategies and the three ``seq_shard_cache`` values, on
the meshes of ``tests/torch_lm_shard_specs_cases.py``: the port's on
stand-in meshes, the reference's on ``AbstractMesh`` (its
``NamedSharding`` needs a mesh, no devices).  The ``dp`` + ``"model"``
quirk of the latent cache (``act_spec`` lays its sequence over the model
axis, ``cache_shardings`` does not) is held as the reference has it."""
import dataclasses
import types

import jax
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.sharding import specs as jspecs
from repro_torch import configs
from repro_torch.models import transformer as TT
from repro_torch.sharding import specs as tspecs

ARCHS = jconfigs.list_archs()
MESHES = {"16x16": {"data": 16, "model": 16}, "2x4": {"data": 2, "model": 4},
          "pod": {"pod": 2, "data": 2, "model": 4}}
STRATEGIES = ("neutron_tp", "megatron", "dp")
SEQ_MODES = (False, True, "model")
# (batch, max_len): a batch the data axes divide and one they do not
SHAPES = ((16, 4096), (1, 1000))
KINDS = ("cache_seq", "cache_seq_latent")


def _rules(mod, strategy, mesh_name, seq_mode):
    data_axes = ("pod", "data") if mesh_name == "pod" else ("data",)
    return mod.ShardingRules(strategy=strategy, data_axes=data_axes,
                             seq_shard_cache=seq_mode)


def _tuple(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _port_leaves(tree):
    """The spec tree's leaves in the reference's pytree order (a ring's
    ``window`` is not a leaf)."""
    return [getattr(c, f.name) for unit in tree for c in unit
            for f in dataclasses.fields(c) if f.name != "window"]


@pytest.mark.parametrize("seq_mode", SEQ_MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_cache_act_specs_equal_reference(mesh_name, strategy, seq_mode):
    mesh = types.SimpleNamespace(shape=dict(MESHES[mesh_name]))
    ref = _rules(jspecs, strategy, mesh_name, seq_mode)
    port = _rules(tspecs, strategy, mesh_name, seq_mode)
    shapes = [(2, 32, 8, 16), (1, 1000, 12, 8), (32, 4096, 3, 5),
              (16, 64, 512)]
    for kind in KINDS:
        want = ref.act_spec(kind, 4)
        got = port.act_spec(kind, 4)
        assert got == _tuple(want), kind
        for shape in shapes:
            assert tspecs._fit_spec(got, shape, mesh) == _tuple(
                jspecs._fit_spec(want, shape, mesh)), (kind, shape)
    if strategy == "dp" and seq_mode == "model":
        # the quirk: act_spec keeps the literal model axis on the latent's
        # sequence, cache_shardings' spec does not name it
        assert port.act_spec("cache_seq_latent", 3)[1] == "model"
        assert tspecs._cache_leaf_specs(port)["c_kv"][1] is None


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_reference(arch, mesh_name):
    """Every leaf's spec of every config's caches, stacked included, under
    three strategies × three ``seq_shard_cache`` values × two (batch,
    max_len), with and without ``long_context``."""
    shape = MESHES[mesh_name]
    stand_in = types.SimpleNamespace(shape=dict(shape))
    abstract = AbstractMesh(tuple(shape.values()), tuple(shape))
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for batch, max_len in SHAPES:
        for lc in ((False, True) if cfg.sliding_window else (False,)):
            want_shapes = jax.eval_shape(
                lambda: JT.init_caches(jcfg, batch, max_len,
                                       long_context=lc))
            got_shapes = TT.init_caches(cfg, batch, max_len, device="meta",
                                        long_context=lc)
            for strategy in STRATEGIES:
                for seq_mode in SEQ_MODES:
                    ref = _rules(jspecs, strategy, mesh_name, seq_mode)
                    port = _rules(tspecs, strategy, mesh_name, seq_mode)
                    want = [_tuple(s.spec) for s in jax.tree.leaves(
                        jspecs.cache_shardings(ref, abstract, want_shapes))]
                    got = _port_leaves(tspecs.cache_shardings(
                        port, stand_in, got_shapes))
                    assert len(got) == len(want)
                    for g, w, leaf in zip(got, want, _port_leaves(
                            got_shapes)):
                        if torch_is_length(leaf):
                            # the port's length is one host int, the
                            # reference's an array stacked over repeats
                            assert g == () and set(w) <= {None}
                        else:
                            assert g == w, (strategy, seq_mode, batch,
                                            lc, g, w)


def torch_is_length(leaf) -> bool:
    return isinstance(leaf, int)


def test_cache_shardings_keep_the_tree():
    """The spec tree is the cache tree: the same dataclasses, a ring's
    window kept, stacked leaves' specs right-aligned (a leading None a
    repeats dim)."""
    cfg = configs.get_config("gemma2-9b")
    caches = TT.init_caches(cfg, 2, 64, device="meta", long_context=True)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    specs = tspecs.cache_shardings(
        tspecs.ShardingRules(seq_shard_cache="model"), mesh, caches)
    local, glob = specs[0]
    assert type(local) is type(caches[0][0]) and local.window == 4096
    assert local.k == (None, "data", "model", None, None)
    assert glob.k == (None, "data", "model", None, None)
    assert local.length == ()
