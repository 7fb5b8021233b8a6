"""The port's TP engine against the JAX package's, on the CPU over gloo.

* One rank: ``make_tp_train_fns`` for both decoupled modes × both
  aggregation backends × L ∈ {1, 2, 3} (the fused split+gather round, the
  split and gather rounds, and a middle round), 3 AdamW steps of loss and
  params against ``repro``'s ``make_tp_train_fns`` on ``tp_mesh(1)``.
* Two ranks, spawned: each rank's loss and grads against ``repro``'s
  single-device ``decoupled_forward`` plus the masked loss on the same
  padded problem — the check that the replicated parameters' gradients
  are summed across ranks.

atol 1e-5 throughout (fp32; sums in a different order).
"""
import datetime
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as joptim
from repro.core import decouple as jD
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import tp_mesh
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
BS = 32
TIMEOUT = datetime.timedelta(seconds=60)


def _init_params(cfg_kw, seed):
    cfg = jM.GNNConfig(**cfg_kw)
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    jdata, tdata = jsynth.sbm_power_law(**GRAPH), tsynth.sbm_power_law(**GRAPH)
    jb = jD.prepare_bundle(jdata, n_workers=1, n_chunks=3,
                           agg="blocksparse", agg_block_size=BS)
    tb = tD.prepare_bundle(tdata, n_workers=1, n_chunks=3,
                           agg="blocksparse", agg_block_size=BS,
                           device="cpu")
    yield jdata, tdata, jb, tb
    dist.destroy_process_group()


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("agg", ["segment", "blocksparse"])
@pytest.mark.parametrize("mode", ["decoupled", "decoupled_pipelined"])
def test_one_rank_train_steps_match_jax(one_rank, mode, agg, layers):
    jdata, tdata, jb, tb = one_rank
    jcfg = jD.padded_gnn_config(jdata, jb, hidden_dim=8, num_layers=layers,
                                gamma=0.8)
    tcfg = tD.padded_gnn_config(tdata, tb, hidden_dim=8, num_layers=layers,
                                gamma=0.8)
    params = _init_params(jcfg.__dict__, seed=layers)
    kw = dict(weight_decay=5e-4)
    jopt, topt = joptim.adamw(1e-2, **kw), toptim.adamw(1e-2, **kw)
    jstep, jeval = jD.make_tp_train_fns(jcfg, jb, tp_mesh(1), jopt,
                                        mode=mode, agg=agg)
    tstep, teval = tD.make_tp_train_fns(tcfg, tb, TPMesh(), topt,
                                        mode=mode, agg=agg)
    jp, tp = jax.tree.map(jnp.asarray, params), P.from_numpy_tree(params,
                                                                  "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js, jloss = jstep(jp, js)
        tp, ts, tloss = tstep(tp, ts)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
        for a, b in zip(P.tree_leaves(P.to_numpy_tree(tp)),
                        jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)
    (jl, ja), (tl, ta) = jeval(jp, "test"), teval(tp, "test")
    np.testing.assert_allclose([tl.item(), ta.item()],
                               [float(jl), float(ja)], atol=ATOL)


def _two_rank_worker(rank, world, init, params, out_dir):
    """One rank of the 2-process check: loss and grads for both modes ×
    both backends, saved for the parent to compare."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        data = tsynth.sbm_power_law(**GRAPH)
        bundle = tD.prepare_bundle(data, n_workers=world, n_chunks=3,
                                   agg="blocksparse", agg_block_size=BS,
                                   device="cpu")
        cfg = tD.padded_gnn_config(data, bundle, hidden_dim=8, num_layers=2,
                                   gamma=0.8)
        p = P.from_numpy_tree(params, "cpu")
        out = {}
        for mode in ("decoupled", "decoupled_pipelined"):
            for agg in ("segment", "blocksparse"):
                vg = tD.make_tp_value_and_grad(cfg, bundle, TPMesh(),
                                               mode=mode, agg=agg)
                loss, grads = vg(p, bundle.train_mask)
                key = f"{mode}-{agg}"
                out[f"{key}-loss"] = loss.numpy()
                for i, g in enumerate(P.tree_leaves(grads)):
                    out[f"{key}-g{i}"] = g.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_two_ranks_match_single_device_reference(tmp_path):
    world = 2
    jdata = jsynth.sbm_power_law(**GRAPH)
    jb = jD.prepare_bundle(jdata, n_workers=world, n_chunks=3)
    jcfg = jD.padded_gnn_config(jdata, jb, hidden_dim=8, num_layers=2,
                                gamma=0.8)
    params = _init_params(jcfg.__dict__, seed=5)

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, world, tmp_path / "rendezvous", params,
                               tmp_path)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world

    def ref_loss(p):
        logits = jM.decoupled_forward(p, jcfg, jb.graph.edges, jb.features)
        ls, _, cnt = jM.masked_loss_and_acc(logits, jb.labels, jb.train_mask,
                                            jdata.num_classes)
        return ls / jnp.maximum(cnt, 1.0)

    want_loss, want_grads = jax.value_and_grad(ref_loss)(
        jax.tree.map(jnp.asarray, params))
    want_grads = [np.asarray(g) for g in jax.tree.leaves(want_grads)]
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        for mode in ("decoupled", "decoupled_pipelined"):
            for agg in ("segment", "blocksparse"):
                key = f"{mode}-{agg}"
                np.testing.assert_allclose(got[f"{key}-loss"],
                                           float(want_loss), atol=ATOL)
                for i, g in enumerate(want_grads):
                    np.testing.assert_allclose(got[f"{key}-g{i}"], g,
                                               atol=ATOL, err_msg=key)
