"""The LM's sharding rules against the JAX package's, no processes: the
logical-axis names tree of every config's parameters (``split_params``'s
names, from the reference's abstract init), every leaf's ``param_spec``
and every activation kind's ``act_spec`` (and its ``_fit_spec``) under the
three strategies, on stand-in meshes of (data, model) = (16, 16) and
(2, 4) and a (pod, data, model) one; the shapes tree against
``init_transformer``'s; the cache kinds' specs and ``cache_shardings``;
the refusals (an unknown strategy, a mesh without the rules' axes) and
sharded serving running on a one-rank mesh under neutron_tp and
megatron."""
import dataclasses
import inspect
import types

import jax
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.nn.param import split_params
from repro.sharding import specs as jspecs
from repro_torch import configs, optim
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.nn import param as tparam
from repro_torch.params import tree_map
from repro_torch.serve import engine
from repro_torch.sharding import specs as tspecs
from repro_torch.train import make_train_step, sharded_setup
from test_torch_lm_configs import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
MESHES = {"16x16": {"data": 16, "model": 16}, "2x4": {"data": 2, "model": 4},
          "pod": {"pod": 2, "data": 2, "model": 4}}
STRATEGIES = ("neutron_tp", "megatron", "dp")
KINDS = ("act_tokens", "act_heads", "act_kv_heads", "act_ssm_heads",
         "act_vocab", "expert_buf")


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _rules(mod, strategy, mesh_name):
    data_axes = ("pod", "data") if mesh_name == "pod" else ("data",)
    return mod.ShardingRules(strategy=strategy, data_axes=data_axes)


def _tuple(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


@pytest.fixture(scope="module")
def reference_trees():
    """Each config's (shapes, names) trees from the reference's abstract
    init (traced, not drawn)."""
    out = {}
    for arch in ARCHS:
        cfg = jconfigs.get_config(arch)
        abstract = jax.eval_shape(lambda k, c=cfg: JT.init_transformer(k, c),
                                  jax.random.PRNGKey(0))
        vals, names = split_params(abstract)
        out[arch] = (jax.tree.map(lambda v: tuple(v.shape), vals), names)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_names_and_shapes_equal_reference(arch, reference_trees):
    shapes, names = reference_trees[arch]
    cfg = configs.get_config(arch)
    assert tparam.param_names(cfg) == names
    assert tparam.param_shapes(cfg) == shapes
    reduced = configs.get_config(arch + "-reduced")
    params = TT.init_transformer(reduced, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), params) == \
        tparam.param_shapes(reduced)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name, reference_trees):
    shapes, names = reference_trees[arch]
    mesh = _mesh(mesh_name)
    for strategy in STRATEGIES:
        ref = _rules(jspecs, strategy, mesh_name)
        port = _rules(tspecs, strategy, mesh_name)
        want = jax.tree.map(
            lambda n, s: _tuple(ref.param_spec(n, s, mesh)), names, shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        got = port.param_shardings(names, shapes, mesh)
        assert got == want, (arch, strategy)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_act_specs_and_fit_equal_reference(strategy, mesh_name):
    mesh = _mesh(mesh_name)
    ref = _rules(jspecs, strategy, mesh_name)
    port = _rules(tspecs, strategy, mesh_name)
    shapes = [(2, 32, 8, 16), (32, 6, 12, 8), (64, 64, 3, 5), (16, 4, 64)]
    for kind in KINDS + ("no_such_kind",):
        want = ref.act_spec(kind, 4)
        got = port.act_spec(kind, 4)
        assert got == (None if want is None else _tuple(want)), kind
        if want is None:
            continue
        for shape in shapes:
            assert tspecs._fit_spec(got, shape, mesh) == _tuple(
                jspecs._fit_spec(want, shape, mesh)), (kind, shape)
    for kind in ("cache_seq", "cache_seq_latent"):
        assert port.act_spec(kind, 4) == _tuple(ref.act_spec(kind, 4))
    caches = TT.init_caches(configs.get_config("internlm2-1.8b"), 16, 64,
                            device="meta")
    ((spec,),) = tspecs.cache_shardings(port, mesh, caches)
    assert spec.k == _tuple(jspecs._fit_spec(
        jspecs.P(None, *ref.act_spec("cache_seq", 4)),
        caches[0][0].k.shape, mesh))


def test_unported_strategy_and_serving_raise(tmp_path):
    """megatron makes a sharder (and so a ``sharded_setup``) whose blocks
    keep their model shards at use; an unknown strategy and a mesh
    without the rules' axes raise.  Sharded serving runs: ``prefill``,
    ``decode_step`` and ``make_serve_fns``' closures under a sharder on a
    one-rank mesh give the unsharded logits (a decode step needs the
    caches' ``max_len``, which the sharder carries), under neutron_tp and
    megatron, and ``generate``, single-device as the reference's, takes no
    sharder."""
    mesh = _mesh("2x4")
    rules = tspecs.ShardingRules("megatron")
    megatron = tspecs.Sharder(mesh, rules)
    cfg = configs.get_config("internlm2-1.8b-reduced")
    specs = megatron.param_specs(cfg)["groups"][0][0]["attn"]["wq"]
    assert specs.spec[-3:] == ("data", "model", None)
    assert specs.use[-3:] == (None, "model", None)
    shape = dataclasses.replace(configs.get_shape("train_4k"),
                                global_batch=2, seq_len=16)
    setup = sharded_setup(cfg, shape, mesh, rules)
    assert setup["sharder"].megatron and callable(setup["train_step"])
    with pytest.raises(ValueError, match="strategy"):
        tspecs.Sharder(mesh, tspecs.ShardingRules("fsdp_only"))
    with pytest.raises(ValueError, match="hybrid_mesh"):
        tspecs.Sharder(types.SimpleNamespace(shape={"model": 4}),
                       tspecs.ShardingRules())
    with pytest.raises(ValueError, match="pass its sharder"):
        make_train_step(cfg, optim.adamw(1e-3), in_shardings=({}, {}))
    params = TT.init_transformer(cfg, device="cpu")
    tokens = torch.arange(4)[None] % cfg.vocab_size
    assert "sharder" not in inspect.signature(engine.generate).parameters
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        for strategy in ("neutron_tp", "megatron"):
            sharder = tspecs.Sharder(make_host_mesh(model=1, data=1),
                                     tspecs.ShardingRules(strategy))
            shards = tspecs.place_params(params, cfg, sharder)
            with torch.no_grad():
                want, caches = TT.prefill(params, cfg, tokens, max_len=8)
                want_step = TT.decode_step(params, cfg, tokens[:, :1],
                                           caches)[0]
                got, caches = TT.prefill(shards, cfg, tokens, max_len=8,
                                         shard=sharder)
                torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
                with pytest.raises(ValueError, match="max_len"):
                    TT.decode_step(shards, cfg, tokens[:, :1], caches,
                                   shard=sharder)
                got_step = TT.decode_step(shards, cfg, tokens[:, :1],
                                          caches,
                                          shard=sharder.serving(8))[0]
                torch.testing.assert_close(got_step, want_step, rtol=0,
                                           atol=1e-6)
                prefill_fn, decode_fn = engine.make_serve_fns(cfg, sharder)
                caches = prefill_fn(shards, tokens, max_len=8)[1]
                torch.testing.assert_close(decode_fn(
                    shards, tokens[:, :1], caches)[0], want_step, rtol=0,
                    atol=1e-6)
    finally:
        dist.destroy_process_group()
