"""The port's naive TP mode and DP halo-exchange baseline against the JAX
package's, on the CPU over gloo, on every aggregation backend.

* Naive, one rank: ``make_tp_train_fns(mode="naive")`` for L ∈ {1, 2, 3},
  3 AdamW steps of loss and params against ``repro``'s on ``tp_mesh(1)``.
* Naive, two spawned ranks: each rank's loss and grads against ``repro``'s
  single-device ``coupled_forward`` plus the masked loss on the same
  padded problem.
* DP, one rank (k=1): ``make_dp_train_fns`` for L ∈ {1, 2, 3}, 3 AdamW
  steps against ``repro.gnn.dp_baseline``; the bundle's host arrays equal.
* DP, two spawned ranks (k=2): loss and grads against
  ``repro.gnn.dp_baseline`` at k=2, taken in one child process with two
  forced host devices.

atol 1e-5 throughout (fp32; sums in a different order).
"""
import datetime
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as joptim
from repro.core import decouple as jD
from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import tp_mesh
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, BS, HIDDEN = 3, 32, 8
BACKENDS = ("segment", "blocksparse", "dense")
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _init_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(seed), cfg))


def _dp_cfgs(layers):
    kw = dict(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
              num_classes=GRAPH["num_classes"], num_layers=layers)
    return jM.GNNConfig(**kw, decoupled=False), tM.GNNConfig(**kw)


def _assert_tree_close(got, want, what=""):
    got, want = P.tree_leaves(P.to_numpy_tree(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


def _run_three_steps(jfns, tfns, params):
    """3 AdamW steps of both, losses and params held after each; then the
    test-split loss and accuracy."""
    kw = dict(weight_decay=5e-4)
    jopt, topt = joptim.adamw(1e-2, **kw), toptim.adamw(1e-2, **kw)
    jstep, jeval = jfns(jopt)
    tstep, teval = tfns(topt)
    jp, tp = jax.tree.map(jnp.asarray, params), P.from_numpy_tree(params,
                                                                  "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        jp, js, jloss = jstep(jp, js)
        tp, ts, tloss = tstep(tp, ts)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
        _assert_tree_close(tp, jp, f"step {i}")
    (jl, ja), (tl, ta) = jeval(jp, "test"), teval(tp, "test")
    np.testing.assert_allclose([tl.item(), ta.item()],
                               [float(jl), float(ja)], atol=ATOL)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield jsynth.sbm_power_law(**GRAPH), tsynth.sbm_power_law(**GRAPH)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Naive TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", BACKENDS)
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_naive_one_rank_train_steps_match_jax(one_rank, layers, agg):
    jdata, tdata = one_rank
    jb = jD.prepare_bundle(jdata, n_workers=1, n_chunks=CHUNKS, agg=agg,
                           agg_block_size=BS)
    tb = tD.prepare_bundle(tdata, n_workers=1, n_chunks=CHUNKS, agg=agg,
                           agg_block_size=BS, device="cpu")
    jcfg = jD.padded_gnn_config(jdata, jb, hidden_dim=HIDDEN,
                                num_layers=layers)
    tcfg = tD.padded_gnn_config(tdata, tb, hidden_dim=HIDDEN,
                                num_layers=layers)
    _run_three_steps(
        lambda o: jD.make_tp_train_fns(jcfg, jb, tp_mesh(1), o,
                                       mode="naive"),
        lambda o: tD.make_tp_train_fns(tcfg, tb, TPMesh(), o, mode="naive"),
        _init_params(jcfg, seed=layers))


def _naive_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        data = tsynth.sbm_power_law(**GRAPH)
        p = P.from_numpy_tree(params, "cpu")
        out = {}
        for agg in BACKENDS:
            bundle = tD.prepare_bundle(data, n_workers=world,
                                       n_chunks=CHUNKS, agg=agg,
                                       agg_block_size=BS, device="cpu")
            cfg = tD.padded_gnn_config(data, bundle, hidden_dim=HIDDEN,
                                       num_layers=2)
            loss, grads = tD.make_tp_value_and_grad(
                cfg, bundle, TPMesh(), mode="naive")(p, bundle.train_mask)
            out[f"{agg}-loss"] = loss.numpy()
            for i, g in enumerate(P.tree_leaves(grads)):
                out[f"{agg}-g{i}"] = g.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _spawn(target, world, tmp_path, *args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, tmp_path / "rendezvous", *args,
                               tmp_path)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world


def test_naive_two_ranks_match_single_device_reference(tmp_path):
    world = 2
    jdata = jsynth.sbm_power_law(**GRAPH)
    jb = jD.prepare_bundle(jdata, n_workers=world, n_chunks=CHUNKS)
    jcfg = jD.padded_gnn_config(jdata, jb, hidden_dim=HIDDEN, num_layers=2,
                                decoupled=False)
    params = _init_params(jcfg, seed=5)
    _spawn(_naive_rank, world, tmp_path, params)

    def ref_loss(p):
        logits = jM.coupled_forward(p, jcfg, jb.graph.edges, jb.features)
        ls, _, cnt = jM.masked_loss_and_acc(logits, jb.labels, jb.train_mask,
                                            jdata.num_classes)
        return ls / jnp.maximum(cnt, 1.0)

    want_loss, want_grads = jax.value_and_grad(ref_loss)(
        jax.tree.map(jnp.asarray, params))
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        for agg in BACKENDS:
            np.testing.assert_allclose(got[f"{agg}-loss"], float(want_loss),
                                       atol=ATOL)
            for i, g in enumerate(jax.tree.leaves(want_grads)):
                np.testing.assert_allclose(got[f"{agg}-g{i}"], np.asarray(g),
                                           atol=ATOL, err_msg=agg)


# ---------------------------------------------------------------------------
# DP halo-exchange baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", BACKENDS)
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_dp_one_rank_train_steps_match_jax(one_rank, layers, agg):
    jdata, tdata = one_rank
    jb = jDP.prepare_dp_bundle(jdata, k=1, agg=agg, agg_block_size=BS)
    tb = tDP.prepare_dp_bundle(tdata, k=1, agg=agg, agg_block_size=BS,
                               device="cpu")
    jcfg, tcfg = _dp_cfgs(layers)
    _run_three_steps(
        lambda o: jDP.make_dp_train_fns(jcfg, jb, tp_mesh(1), o),
        lambda o: tDP.make_dp_train_fns(tcfg, tb, TPMesh(), o),
        _init_params(jcfg, seed=layers))


@pytest.mark.parametrize("balance", ["vertex", "edge"])
@pytest.mark.parametrize("agg", BACKENDS)
def test_dp_bundle_arrays_equal(agg, balance):
    data = jsynth.sbm_power_law(**GRAPH)
    jb = jDP.prepare_dp_bundle(data, k=3, balance=balance, agg=agg,
                               agg_block_size=BS)
    tb = tDP.prepare_dp_bundle(data, k=3, balance=balance, agg=agg,
                               agg_block_size=BS, device="cpu")
    jg, tg = jb.graph, tb.graph
    for f in ("k", "m", "halo_size", "n_local_max", "e_max", "agg"):
        assert getattr(jg, f) == getattr(tg, f), f
    for f in ("send_idx_local", "recv_pos", "src", "dst", "weight",
              "valid_rows"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.comm_rows_per_worker,
                                  jb.comm_rows_per_worker)
    if agg == "dense":
        np.testing.assert_array_equal(tg.dense_adj.numpy(),
                                      np.asarray(jg.dense_adj))


def test_dp_rejects_unported_options(one_rank):
    jdata, tdata = one_rank
    # n_replicas pads each partition's rows to a multiple, as the
    # reference does (130 rows: 2 divides, 4 pads to 132)
    for r in (2, 4):
        jb = jDP.prepare_dp_bundle(jdata, k=1, n_replicas=r)
        tb = tDP.prepare_dp_bundle(tdata, k=1, n_replicas=r, device="cpu")
        assert tb.graph.n_local_max == jb.graph.n_local_max
        np.testing.assert_array_equal(tb.features.numpy(),
                                      np.asarray(jb.features))
        np.testing.assert_array_equal(tb.graph.valid_rows.numpy(),
                                      np.asarray(jb.graph.valid_rows))
    tb = tDP.prepare_dp_bundle(tdata, k=1, device="cpu")
    jcfg, tcfg = _dp_cfgs(2)
    # data axes that a pure-TP mesh does not have: the reference's error
    with pytest.raises(KeyError, match="data"):
        jDP.make_dp_value_and_grad(jcfg, jDP.prepare_dp_bundle(jdata, k=1),
                                   tp_mesh(1), data_axes=("data",))
    with pytest.raises(KeyError, match="data"):
        tDP.make_dp_value_and_grad(tcfg, tb, TPMesh(), data_axes=("data",))
    with pytest.raises(ValueError, match="k=1"):
        tDP.make_dp_value_and_grad(
            tcfg, tDP.prepare_dp_bundle(tdata, k=2, device="cpu"), TPMesh())
    with pytest.raises(ValueError, match="no dense adjacency"):
        tDP.make_dp_value_and_grad(tcfg, tb, TPMesh(), agg="dense")


def _jax_dp_child(out: str, world: int, seed: int) -> None:
    """Child process with ``world`` forced host devices: the reference DP
    baseline's loss and grads at k=world on every backend."""
    assert len(jax.devices()) == world
    data = jsynth.sbm_power_law(**GRAPH)
    jcfg, _ = _dp_cfgs(2)
    params = jax.tree.map(jnp.asarray, _init_params(jcfg, seed))
    res = {}
    for agg in BACKENDS:
        bundle = jDP.prepare_dp_bundle(data, k=world, agg=agg,
                                       agg_block_size=BS)
        loss, grads = jDP.make_dp_value_and_grad(
            jcfg, bundle, tp_mesh(world))(params, bundle.train_mask)
        res[f"{agg}-loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            res[f"{agg}-g{i}"] = np.asarray(g)
    np.savez(out, **res)


def _dp_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        data = tsynth.sbm_power_law(**GRAPH)
        _, cfg = _dp_cfgs(2)
        p = P.from_numpy_tree(params, "cpu")
        out = {}
        for agg in BACKENDS:
            bundle = tDP.prepare_dp_bundle(data, k=world, agg=agg,
                                           agg_block_size=BS, device="cpu")
            loss, grads = tDP.make_dp_value_and_grad(cfg, bundle, TPMesh())(
                p, bundle.train_mask)
            out[f"{agg}-loss"] = loss.numpy()
            for i, g in enumerate(P.tree_leaves(grads)):
                out[f"{agg}-g{i}"] = g.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_dp_two_ranks_match_reference(tmp_path):
    world, seed = 2, 7
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_naive_dp as t; "
            "t._jax_dp_child({!r}, {}, {})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp_path / "ref.npz"), world, seed)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    jcfg, _ = _dp_cfgs(2)
    _spawn(_dp_rank, world, tmp_path, _init_params(jcfg, seed))
    _, err = child.communicate(timeout=180)
    assert child.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "ref.npz")
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL,
                                       err_msg=key)
