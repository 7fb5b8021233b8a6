"""Sharded LM training against the JAX package: two AdamW steps of
``sharded_setup``'s step at four gloo ranks on (data=2, model=2) against
the reference's single-device jitted step, both steps' loss, aux and total
at rtol 1e-5 (reduced configs, fp32, 2 × 16 tokens from ``SyntheticLM`` a
step): Granite-MoE under the plain ``Sharder`` (the MoE dispatched
globally), InternVL2 behind its prefix and Zamba2 under the
``ExplicitSharder``.  The state holds shards (parameters and AdamW
moments of each leaf's ``param_spec``), ``sharded_setup`` returns the
reference's keys, and its batch specs and shardings equal the
reference's.  One spawn of four ranks for the file."""
import datetime
import json
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch.mesh import make_host_mesh as jmesh
from repro.sharding.specs import ShardingRules as JRules
from repro.train import loop as jloop
from repro.train.state import init_train_state as j_init_train_state
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.params import tree_leaves
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.explicit import ExplicitSharder
from repro_torch.train import init_sharded_state, sharded_setup
from test_torch_lm_train_step import RTOL, SEQ, _ref_model

ARCHS = {"granite-moe-1b-a400m": "plain", "internvl2-1b": "explicit",
         "zamba2-2.7b": "explicit"}
MESH = dict(model=2, data=2)
LR = 1e-3
TIMEOUT = datetime.timedelta(seconds=120)


def _shape(cfg):
    shape = configs.get_shape("train_4k")
    return type(shape)(**{**shape.__dict__, "global_batch": 2,
                          "seq_len": SEQ})


def _rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        mesh = make_host_mesh(**MESH)
        rules = tspecs.ShardingRules()
        res = {}
        for arch, kind in ARCHS.items():
            cfg = configs.get_config(arch + "-reduced")
            sharder = ExplicitSharder(mesh, rules) if kind == "explicit" \
                else None
            setup = sharded_setup(cfg, _shape(cfg), mesh, rules, lr=LR,
                                  sharder=sharder)
            _, params, batches = _ref_model(arch, 2)
            whole = TT.init_transformer(cfg, seed=0, device="cpu")
            state = init_sharded_state(whole, cfg, setup["optimizer"],
                                       setup["sharder"])
            local = [list(t.shape) for t in tree_leaves(state.params)]
            metrics = []
            for batch in batches:
                state, m = setup["train_step"](state, batch)
                metrics.append({k: v.item() for k, v in m.items()})
            res[arch] = {
                "metrics": metrics, "step": state.step,
                "count": state.opt_state.count, "local": local,
                "mu": [list(t.shape) for t in
                       tree_leaves(state.opt_state.mu)],
                "keys": sorted(setup),
                "batch_specs": {k: [list(v.shape), str(v.dtype)]
                                for k, v in setup["batch_specs"].items()},
                "batch_shardings": {k: list(v) for k, v in
                                    setup["batch_shardings"].items()}}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    world, tmp = 4, tmp_path_factory.mktemp("train")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank,
                         args=(r, world, tmp / "rendezvous", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_sharded_adamw_steps_match_reference(ranks, arch):
    cfg, params, batches = _ref_model(arch, 2)
    jstep = jloop.make_train_step(cfg, joptim.adamw(LR), donate=False)
    jstate = j_init_train_state(params, joptim.adamw(LR))
    want = []
    for batch in batches:
        jstate, m = jstep(jstate, batch)
        want.append({k: float(v) for k, v in m.items()})
    tcfg = configs.get_config(arch + "-reduced")
    full = [list(a.shape) for a in jax.tree.leaves(params)]
    specs = tree_leaves(tspecs.Sharder(
        type("M", (), {"shape": {"model": 2, "data": 2}})(),
        tspecs.ShardingRules()).param_specs(tcfg))
    for rank in ranks:
        got = rank[arch]
        for g, w in zip(got["metrics"], want):
            for key in w:
                assert abs(g[key] - w[key]) <= RTOL * max(abs(w[key]),
                                                          1e-3), key
        assert got["step"] == got["count"] == 2
        # shards, the moments laid out as the parameters
        assert got["mu"] == got["local"]
        for shape, local, sp in zip(full, got["local"], specs):
            div = [2 if e is not None else 1 for e in sp.spec]
            assert local == [s // d for s, d in zip(shape, div)]


def test_setup_keys_and_batch_layout_match_reference(ranks):
    """``sharded_setup``'s keys, batch specs and batch shardings are the
    reference's (its mesh of one CPU device)."""
    cfg = jconfigs.get_config("internvl2-1b").reduced()
    mesh = jmesh(model=1, data=1)
    setup = jloop.sharded_setup(cfg, _shape(cfg), mesh, JRules())
    specs = {k: [list(v.shape), str(v.dtype).replace("int32", "torch.int32")
                 .replace("float32", "torch.float32")]
             for k, v in setup["batch_specs"].items()}
    sh = {k: [e for e in v.spec] + [None] * (
        len(setup["batch_specs"][k].shape) - len(v.spec))
        for k, v in setup["batch_shardings"].items()}
    for rank in ranks:
        got = rank["internvl2-1b"]
        assert got["keys"] == sorted(setup)
        assert got["batch_specs"] == specs
        assert got["batch_shardings"] == sh
