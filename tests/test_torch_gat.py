"""The port's GNN model family under tensor parallelism against the JAX
package's, on the CPU over gloo: GAT in all three TP schedules (the
paper's generalized decoupling, with the O(V) score all-gather), and
SAGE, GIN and R-GCN on the decoupled path.

* Units: ``segment_softmax`` (vertices with no in-edge included) and its
  gradient; for all five models the ``init_params`` tree (keys, shapes)
  and ``mlp_phase`` / ``decoupled_forward`` on the same parameters.
* One rank (in-process): GAT × {decoupled, decoupled_pipelined, naive} ×
  L ∈ {1, 2}, two AdamW steps of loss and params against ``repro``'s
  ``make_tp_train_fns`` on a blocksparse bundle (GAT runs its chunked
  edge arrays there); SAGE, GIN and R-GCN × decoupled_pipelined × {segment,
  blocksparse} the same; GAT's one-step ledger equal to the reference's
  traced ledger in every mode.
* Two spawned ranks: GAT decoupled_pipelined and naive, loss and grads
  against the single-device reference, and the ledger, all-gathers
  included, against the reference's taken in a child with two forced
  host devices.  A backward of the all-gather that only slices its
  cotangent is exact at one rank and wrong at two: this case catches it.
* The gates: SAGE, GIN and R-GCN in naive mode, non-GCN DP, GAT streamed.

Parameters come from ``repro.gnn.models.init_params``; atol 1e-5 (fp32,
sums in another order).  The ledger's stated departures (one stacked
loss psum, ``grad_psum``) are held as in ``test_torch_comm_ledger``.
"""
import dataclasses
import datetime
import json
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
from jax.sharding import NamedSharding, PartitionSpec

from repro import optim as joptim
from repro.core import decouple as jD
from repro.gnn import layers as jL
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import telemetry as jT
from repro.runtime import tp_mesh
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.core import stream as tST
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import layers as tL
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh
from repro_torch.runtime import telemetry as tT
from test_torch_comm_ledger import assert_parity

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
HETERO = dict(n=130, num_classes=5, num_edge_types=3, feat_dim=10,
              avg_degree=6, seed=2)
CHUNKS, BS, HIDDEN, GAMMA = 3, 32, 8, 0.8
MODES = ("decoupled", "decoupled_pipelined", "naive")
TWO_RANK_MODES = ("decoupled_pipelined", "naive")
AG = "all_gather|model|float32"
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _data(mod, model):
    return mod.heterogeneous_sbm(**HETERO) if model == "rgcn" \
        else mod.sbm_power_law(**GRAPH)


def _cfgs(model, jb, tb, jdata, tdata, layers=2):
    """(reference, port) padded configs of one model."""
    kw = dict(model=model, hidden_dim=HIDDEN, num_layers=layers,
              gamma=GAMMA)
    jcfg = jD.padded_gnn_config(jdata, jb, **kw)
    tcfg = tD.padded_gnn_config(tdata, tb, **kw)
    if model == "rgcn":
        jcfg = dataclasses.replace(jcfg, num_edge_types=jdata.num_edge_types)
        tcfg = dataclasses.replace(tcfg, num_edge_types=tdata.num_edge_types)
    return jcfg, tcfg


def _params(jcfg, seed):
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(seed), jcfg))


def _close(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def test_segment_softmax_matches_reference():
    rng = np.random.default_rng(0)
    n, e = 40, 300
    # vertices 30..39 have no in-edge; ties in the max at vertex 0
    dst = rng.integers(0, 30, size=e).astype(np.int32)
    scores = (3 * rng.normal(size=e)).astype(np.float32)
    dst[:3] = 0
    scores[:3] = 5.0
    ct = rng.normal(size=e).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jL.segment_softmax(s, jnp.asarray(dst), n),
                        jnp.asarray(scores))
    (want_grad,) = vjp(jnp.asarray(ct))
    s = torch.from_numpy(scores).requires_grad_()
    got = tL.segment_softmax(s, torch.from_numpy(dst), n)
    (got_grad,) = torch.autograd.grad(got, s, torch.from_numpy(ct))
    _close([got.detach(), got_grad], [want, want_grad], "segment_softmax")
    sums = np.zeros(n, np.float32)
    np.add.at(sums, dst, got.detach().numpy())
    np.testing.assert_allclose(sums[:30], 1.0, atol=1e-6)


@pytest.mark.parametrize("model", tM.MODELS)
def test_params_and_mlp_phase_match_reference(model):
    kw = dict(model=model, in_dim=10, hidden_dim=8, num_classes=5,
              num_layers=3, gamma=GAMMA, num_edge_types=3)
    jcfg, tcfg = jM.GNNConfig(**kw), tM.GNNConfig(**kw)
    params = _params(jcfg, seed=1)
    mine = tM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(params) == \
        jax.tree.structure(P.to_numpy_tree(mine))
    assert [a.shape for a in jax.tree.leaves(params)] == \
        [tuple(t.shape) for t in P.tree_leaves(mine)]
    x = np.random.default_rng(2).normal(size=(60, 10)).astype(np.float32)
    tp = P.from_numpy_tree(params, "cpu")
    _close([tM.mlp_phase(tp, tcfg, torch.from_numpy(x))],
           [jM.mlp_phase(params, jcfg, x)], f"{model} mlp_phase")
    jdata, tdata = _data(jsynth, model), _data(tsynth, model)
    jg = jL.edge_list_dev(jdata.graph)
    tg = tL.edge_list_dev(tdata.graph, "cpu")
    xs = jdata.features[:, :10]
    _close([tM.decoupled_forward(tp, tcfg, tg, torch.from_numpy(xs))],
           [jM.decoupled_forward(params, jcfg, jg, xs)],
           f"{model} decoupled_forward")


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield TPMesh()
    dist.destroy_process_group()


def _bundles(model, agg="blocksparse", n_workers=1):
    jdata, tdata = _data(jsynth, model), _data(tsynth, model)
    jb = jD.prepare_bundle(jdata, n_workers=n_workers, n_chunks=CHUNKS,
                           agg=agg, agg_block_size=BS)
    tb = tD.prepare_bundle(tdata, n_workers=n_workers, n_chunks=CHUNKS,
                           agg=agg, agg_block_size=BS, device="cpu")
    return jdata, tdata, jb, tb


def _two_steps(model, mode, agg, layers, mesh):
    """Two AdamW steps of the reference and the port from the same
    parameters: losses and params held after each."""
    jdata, tdata, jb, tb = _bundles(model, agg)
    jcfg, tcfg = _cfgs(model, jb, tb, jdata, tdata, layers)
    params = _params(jcfg, seed=layers)
    kw = dict(weight_decay=5e-4)
    jopt, topt = joptim.adamw(1e-2, **kw), toptim.adamw(1e-2, **kw)
    jstep, _ = jD.make_tp_train_fns(jcfg, jb, tp_mesh(1), jopt, mode=mode)
    tstep, _ = tD.make_tp_train_fns(tcfg, tb, mesh, topt, mode=mode)
    # placed as the step's outputs are, so that step 2 reuses step 1's
    # compiled program
    jp = jax.tree.map(jnp.asarray, params)
    jp, js = jax.device_put((jp, jopt.init(jp)),
                            NamedSharding(tp_mesh(1).mesh, PartitionSpec()))
    tp = P.from_numpy_tree(params, "cpu")
    ts = topt.init(tp)
    for i in range(2):
        jp, js, jloss = jstep(jp, js)
        tp, ts, tloss = tstep(tp, ts)
        what = f"{model}/{mode}/{agg}/L={layers} step {i}"
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL,
                                   err_msg=what)
        _close(P.tree_leaves(P.to_numpy_tree(tp)), jax.tree.leaves(jp),
               what)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_gat_one_rank_train_steps_match_jax(one_rank, mode, layers):
    _two_steps("gat", mode, "blocksparse", layers, one_rank)


@pytest.mark.parametrize("agg", ["segment", "blocksparse"])
@pytest.mark.parametrize("model", ["sage", "gin", "rgcn"])
def test_gcn_like_one_rank_train_steps_match_jax(one_rank, model, agg):
    _two_steps(model, "decoupled_pipelined", agg, 2, one_rank)


def _param_bytes(params) -> float:
    return float(sum(np.asarray(a).nbytes for a in jax.tree.leaves(params)))


def reference_ledgers(n: int) -> dict:
    """{mode: (the reference's traced one-step ledger of GAT at L=2 on
    ``n`` devices, parameter bytes)}."""
    data = jsynth.sbm_power_law(**GRAPH)
    bundle = jD.prepare_bundle(data, n_workers=n, n_chunks=CHUNKS)
    cfg = jD.padded_gnn_config(data, bundle, model="gat",
                               hidden_dim=HIDDEN, num_layers=2, gamma=GAMMA)
    params = jM.init_params(jax.random.PRNGKey(0), cfg)
    out = {}
    for mode in MODES:
        loss_fn = jD.make_tp_loss_fn(cfg, bundle, tp_mesh(n), mode=mode)
        with jT.collect_comm() as ledger:
            jax.jit(jax.value_and_grad(loss_fn)).lower(params,
                                                       bundle.train_mask)
        out[mode] = (ledger.as_dict(), _param_bytes(params))
    return out


def port_ledger(mode, mesh, params_np=None) -> tuple[dict, float, list]:
    """(one GAT step's ledger at L=2, loss, grads) at ``mesh``."""
    data = tsynth.sbm_power_law(**GRAPH)
    bundle = tD.prepare_bundle(data, n_workers=mesh.size, n_chunks=CHUNKS,
                               device="cpu")
    cfg = tD.padded_gnn_config(data, bundle, model="gat", hidden_dim=HIDDEN,
                               num_layers=2, gamma=GAMMA)
    params = tM.init_params(cfg, torch.Generator().manual_seed(0), "cpu") \
        if params_np is None else P.from_numpy_tree(params_np, "cpu")
    vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode)
    with tT.collect_comm() as ledger:
        loss, grads = vg(params, bundle.train_mask)
    return ledger.as_dict(), loss.item(), \
        [g.numpy() for g in P.tree_leaves(grads)]


def _hold_gat_ledger(got, want, n, param_bytes, mode, v_padded):
    assert_parity(got, want, n, param_bytes)
    led = tT.CommLedger.from_dict(got)
    layers = 2 if mode == "naive" else 1
    a2a = {"decoupled": 4, "decoupled_pipelined": 4 * CHUNKS,
           "naive": 4 * 2}[mode]
    assert led.call_count("all_to_all", train=True) == a2a, mode
    assert got[AG]["calls"] == got[AG]["mirrored_calls"] == 2 * layers
    assert got[AG]["payload_bytes"] == 2 * layers * 4 * v_padded // n
    assert got[AG]["wire_bytes"] == (n - 1) * got[AG]["payload_bytes"]


@pytest.fixture(scope="module")
def one_device_ledgers():
    return reference_ledgers(1)


@pytest.mark.parametrize("mode", MODES)
def test_gat_one_rank_ledger_matches_reference(one_rank, one_device_ledgers,
                                               mode):
    want, param_bytes = one_device_ledgers[mode]
    got, loss, _ = port_ledger(mode, one_rank)
    assert np.isfinite(loss)
    v_padded = tD.padded_size(GRAPH["n"], CHUNKS)
    _hold_gat_ledger(got, want, 1, param_bytes, mode, v_padded)


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def _reference_child(out: str, n: int) -> None:
    """Child process with ``n`` forced host devices: the reference's GAT
    ledgers, written to ``out`` as JSON."""
    assert len(jax.devices()) == n
    Path(out).write_text(json.dumps(reference_ledgers(n)))


def _port_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = {}
        for mode in TWO_RANK_MODES:
            ledger, loss, grads = port_ledger(mode, TPMesh(), params)
            out[mode] = {"ledger": ledger, "loss": loss,
                         "grads": [g.tolist() for g in grads]}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def test_gat_two_ranks_match_reference(tmp_path):
    world = 2
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_gat as t; "
            "t._reference_child({!r}, {})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp_path / "ref.json"), world)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    jdata = jsynth.sbm_power_law(**GRAPH)
    jb = jD.prepare_bundle(jdata, n_workers=world, n_chunks=CHUNKS)
    jcfg = jD.padded_gnn_config(jdata, jb, model="gat", hidden_dim=HIDDEN,
                                num_layers=2, gamma=GAMMA)
    params = _params(jcfg, seed=5)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp_path / "rendezvous", params,
                               tmp_path))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    _, err = child.communicate(timeout=180)
    assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world

    ref_cfgs = {"decoupled_pipelined": (jM.decoupled_forward, jcfg),
                "naive": (jM.coupled_forward,
                          dataclasses.replace(jcfg, decoupled=False))}
    ref = json.loads((tmp_path / "ref.json").read_text())
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(world)]
    for mode in TWO_RANK_MODES:
        fwd, cfg = ref_cfgs[mode]

        def ref_loss(p):
            logits = fwd(p, cfg, jb.graph.edges, jb.features)
            ls, _, cnt = jM.masked_loss_and_acc(
                logits, jb.labels, jb.train_mask, jdata.num_classes)
            return ls / jnp.maximum(cnt, 1.0)

        want_loss, want_grads = jax.value_and_grad(ref_loss)(
            jax.tree.map(jnp.asarray, params))
        assert ranks[0][mode]["ledger"] == ranks[1][mode]["ledger"]
        for r in range(world):
            got = ranks[r][mode]
            np.testing.assert_allclose(got["loss"], float(want_loss),
                                       atol=ATOL, err_msg=mode)
            _close(got["grads"], jax.tree.leaves(want_grads),
                   f"{mode} rank {r}")
        want_led, param_bytes = ref[mode]
        _hold_gat_ledger(ranks[0][mode]["ledger"], want_led, world,
                         param_bytes, mode, jb.n_padded)
        assert tT.CommLedger.from_dict(ranks[0][mode]["ledger"]).wire_bytes(
            "all_gather", train=True) > 0.0


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def _naive(model, mesh):
    _, tdata, _, tb = _bundles(model, "segment")
    cfg = tD.padded_gnn_config(tdata, tb, model=model, hidden_dim=HIDDEN)
    tD.make_tp_train_fns(cfg, tb, mesh, toptim.adamw(1e-2), mode="naive")


def _dp(model, mesh):
    data = tsynth.sbm_power_law(**GRAPH)
    bundle = tDP.prepare_dp_bundle(data, k=1, device="cpu")
    cfg = tM.GNNConfig(model=model, in_dim=GRAPH["feat_dim"],
                       hidden_dim=HIDDEN, num_classes=data.num_classes)
    tDP.make_dp_value_and_grad(cfg, bundle, mesh)


def _stream(model, mesh):
    data = tsynth.sbm_power_law(**GRAPH)
    sb = tST.prepare_stream_bundle(data, 1, n_chunks=CHUNKS, device="cpu")
    cfg = tST.stream_gnn_config(data, sb, model=model, hidden_dim=HIDDEN)
    tST.make_stream_value_and_grad(cfg, sb, mesh)


@pytest.mark.parametrize("run, model, match", [
    (_naive, "sage", "naive TP supports"),
    (_naive, "gin", "naive TP supports"),
    (_naive, "rgcn", "naive TP supports"),
    (_dp, "gat", "GCN only"),
    (_dp, "sage", "GCN only"),
    (_stream, "gat", "streaming does not support GAT"),
])
def test_unsupported_paths_raise(one_rank, run, model, match):
    with pytest.raises(ValueError, match=match):
        run(model, one_rank)
