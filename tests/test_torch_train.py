"""The port's single-device trainer, coupled GNN layers, SGD and
``make_tp_loss_fn`` against the JAX package's, on the CPU.

* ``coupled_forward`` for GCN, SAGE, GIN, GAT and R-GCN (on a
  heterogeneous SBM), and ``forward`` with ``decoupled`` on and off:
  logits and the gradients of ``cross_entropy`` on the train mask against
  ``jax.grad`` of the reference.
* ``cross_entropy`` and ``accuracy``, an all-zero mask included.
* ``sgd``'s trajectory with and without momentum.
* ``train_full_graph`` for 6 epochs, ``log_every=2``: every ``EpochLog``'s
  loss and accuracies and the final parameters, with the reference's
  initial weights carried over by patching the port's ``init_params``.
* ``make_tp_loss_fn``: the gradients autograd takes through it against
  the port's ``make_tp_value_and_grad`` and ``jax.grad`` of the
  reference's ``make_tp_loss_fn``, at one gloo rank on both engine
  backends (with one step's ledger equal to ``make_tp_value_and_grad``'s)
  and at two spawned ranks beside a JAX child with two forced host
  devices: without the cross-rank sum each rank's gradient would be its
  own share only.

Parameters come from ``repro.gnn.models.init_params``; atol 1e-5 (fp32,
sums in another order).
"""
import dataclasses
import datetime
import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as joptim
from repro.core import decouple as jD
from repro.gnn import layers as jL
from repro.gnn import models as jM
from repro.gnn import train as jtrain
from repro.graph import synthetic as jsynth
from repro.runtime import tp_mesh
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.gnn import layers as tL
from repro_torch.gnn import models as tM
from repro_torch.gnn import train as ttrain
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh
from repro_torch.runtime import telemetry as tT

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
HETERO = dict(n=130, num_classes=5, num_edge_types=3, feat_dim=10,
              avg_degree=6, seed=2)
CHUNKS, HIDDEN = 3, 8
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _data(mod, model):
    return mod.heterogeneous_sbm(**HETERO) if model == "rgcn" \
        else mod.sbm_power_law(**GRAPH)


def _cfg_kw(model, decoupled=False):
    data = _data(tsynth, model)
    return dict(model=model, in_dim=data.features.shape[1],
                hidden_dim=HIDDEN, num_classes=data.num_classes,
                num_layers=2, decoupled=decoupled, gamma=0.9,
                num_edge_types=data.num_edge_types)


def _params(cfg_kw, seed=3):
    return jax.tree.map(np.asarray, jM.init_params(
        jax.random.PRNGKey(seed), jM.GNNConfig(**cfg_kw)))


def _close(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


def _edges(data):
    g = data.graph
    return (jL.EdgeListDev(src=jnp.asarray(g.src), dst=jnp.asarray(g.dst),
                           weight=jnp.asarray(g.weight), n=g.n),
            tL.edge_list_dev(g, "cpu"))


def _etypes(data):
    if data.edge_types is None:
        return None, None
    return jnp.asarray(data.edge_types), torch.from_numpy(data.edge_types)


# ---------------------------------------------------------------------------
# Forward passes, loss and accuracy
# ---------------------------------------------------------------------------

def _hold_forward(fwd_j, fwd_t, model, decoupled):
    """Logits and the cross-entropy gradients of one forward pair."""
    kw = _cfg_kw(model, decoupled)
    jcfg, tcfg = jM.GNNConfig(**kw), tM.GNNConfig(**kw)
    params = _params(kw)
    data = _data(tsynth, model)
    (jg, tg), (je, te) = _edges(data), _etypes(data)
    x, labels = data.features, data.labels
    mask = data.train_mask.astype(np.float32)

    def jloss(p):
        logits = fwd_j(p, jcfg, jg, jnp.asarray(x), je)
        return jM.cross_entropy(logits, jnp.asarray(labels),
                                jnp.asarray(mask)), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tp = P.tree_map(lambda t: t.requires_grad_(),
                    P.from_numpy_tree(params, "cpu"))
    logits = fwd_t(tp, tcfg, tg, torch.from_numpy(x), te)
    loss = tM.cross_entropy(logits, torch.from_numpy(labels),
                            torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, P.tree_leaves(tp), allow_unused=True,
                                materialize_grads=True)
    _close([logits.detach(), loss.detach()], [want_logits, want_loss],
           f"{model} logits and loss")
    _close(grads, jax.tree.leaves(want_grads), f"{model} grads")


@pytest.mark.parametrize("model", tM.MODELS)
def test_coupled_forward_and_grads_match_reference(model):
    _hold_forward(jM.coupled_forward, tM.coupled_forward, model, False)


@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("model", ["gin", "rgcn"])
def test_forward_dispatch_matches_reference(model, decoupled):
    _hold_forward(jM.forward, tM.forward, model, decoupled)


def test_gat_forward_matches_reference():
    """The coupled GAT layer with its ELU, which ``coupled_forward``
    inlines without the ELU on the last layer."""
    kw = _cfg_kw("gat")
    data = _data(tsynth, "gat")
    (jg, tg), x = _edges(data), data.features
    p = _params(kw)["layers"][0]
    want = jL.gat_forward(jax.tree.map(jnp.asarray, p), jg, jnp.asarray(x))
    got = tL.gat_forward(P.from_numpy_tree(p, "cpu"), tg, torch.from_numpy(x))
    _close([got], [want], "gat_forward")


def test_coupled_rgcn_needs_edge_types():
    kw = _cfg_kw("rgcn")
    data = _data(tsynth, "rgcn")
    params = P.from_numpy_tree(_params(kw), "cpu")
    with pytest.raises(ValueError, match="needs etypes"):
        tM.coupled_forward(params, tM.GNNConfig(**kw),
                           tL.edge_list_dev(data.graph, "cpu"),
                           torch.from_numpy(data.features))


@pytest.mark.parametrize("mask", ["random", "empty"])
def test_cross_entropy_and_accuracy_match_reference(mask):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(40, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=40).astype(np.int32)
    m = ((rng.random(40) < 0.5) if mask == "random"
         else np.zeros(40, bool)).astype(np.float32)
    want_ce, want_grad = jax.value_and_grad(jM.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m))
    want_acc = jM.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(m))
    t = torch.from_numpy(logits).requires_grad_()
    ce = tM.cross_entropy(t, torch.from_numpy(labels), torch.from_numpy(m))
    (grad,) = torch.autograd.grad(ce, t)
    acc = tM.accuracy(t.detach(), torch.from_numpy(labels),
                      torch.from_numpy(m))
    _close([ce.detach(), grad, acc], [want_ce, want_grad, want_acc],
           f"{mask} mask")
    if mask == "empty":
        assert ce.item() == 0.0 and acc.item() == 0.0


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_trajectory_matches_jax(momentum):
    rng = np.random.default_rng(7)
    params = {"layers": [{"w": rng.normal(size=(6, 5)).astype(np.float32),
                          "b": rng.normal(size=(5,)).astype(np.float32)}]}
    lr = 0.05 if momentum else joptim.cosine_decay(0.1, 8, 1e-3)
    tlr = 0.05 if momentum else toptim.cosine_decay(0.1, 8, 1e-3)
    jopt = joptim.sgd(lr, momentum=momentum)
    topt = toptim.sgd(tlr, momentum=momentum)
    jp, tp = jax.tree.map(jnp.asarray, params), P.from_numpy_tree(params,
                                                                  "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(8):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(P.from_numpy_tree(grads, "cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        _close(P.tree_leaves(P.to_numpy_tree(tp)), jax.tree.leaves(jp),
               "params")
        _close(P.tree_leaves(P.to_numpy_tree(ts.mu)), jax.tree.leaves(js.mu),
               "momentum")
    assert ts.count == int(js.count) == 8 and ts.nu is None


# ---------------------------------------------------------------------------
# The single-device trainer
# ---------------------------------------------------------------------------

TRAIN_CASES = [("gcn", False), ("gcn", True), ("gat", False),
               ("rgcn", False), ("sage", False), ("gin", False)]


@pytest.mark.parametrize("model, decoupled", TRAIN_CASES,
                         ids=[f"{m}-{'decoupled' if d else 'coupled'}"
                              for m, d in TRAIN_CASES])
def test_train_full_graph_matches_reference(model, decoupled):
    kw = _cfg_kw(model, decoupled)
    jcfg, tcfg = jM.GNNConfig(**kw), tM.GNNConfig(**kw)
    run = dict(epochs=6, lr=1e-2, weight_decay=5e-4, seed=4, log_every=2)
    want_params, want_logs = jtrain.train_full_graph(
        _data(jsynth, model), jcfg, **run)
    params0 = jax.tree.map(np.asarray, jM.init_params(
        jax.random.PRNGKey(run["seed"]), jcfg))
    seen = []
    with mock.patch.object(
            tM, "init_params",
            lambda cfg, gen, device: P.from_numpy_tree(params0, device)):
        params, logs = ttrain.train_full_graph(
            _data(tsynth, model), tcfg, **run, callback=seen.append,
            device="cpu")
    assert [lg.epoch for lg in logs] == [lg.epoch for lg in want_logs] \
        == [2, 4, 6]
    assert seen == logs
    for got, want in zip(logs, want_logs):
        fields = ("loss", "train_acc", "val_acc", "test_acc")
        np.testing.assert_allclose([getattr(got, f) for f in fields],
                                   [getattr(want, f) for f in fields],
                                   atol=ATOL, err_msg=f"epoch {got.epoch}")
        assert got.seconds > 0
    _close(P.tree_leaves(P.to_numpy_tree(params)),
           jax.tree.leaves(want_params), f"{model} final params")


# ---------------------------------------------------------------------------
# make_tp_loss_fn
# ---------------------------------------------------------------------------

def _tp_setup(n_workers):
    data = tsynth.sbm_power_law(**GRAPH)
    bundle = tD.prepare_bundle(data, n_workers=n_workers, n_chunks=CHUNKS,
                               device="cpu")
    cfg = tD.padded_gnn_config(data, bundle, hidden_dim=HIDDEN,
                               num_layers=2, gamma=0.8)
    return cfg, bundle


def _tp_params(n_workers):
    jdata = jsynth.sbm_power_law(**GRAPH)
    jb = jD.prepare_bundle(jdata, n_workers=n_workers, n_chunks=CHUNKS)
    jcfg = jD.padded_gnn_config(jdata, jb, hidden_dim=HIDDEN, num_layers=2,
                                gamma=0.8)
    return jcfg, jb, _params(dataclasses.asdict(jcfg), seed=6)


def reference_loss_fn_grads(n_workers, mode, backend) -> tuple:
    """(loss, grads) of ``jax.grad`` through the reference's
    ``make_tp_loss_fn`` on ``n_workers`` devices (jitted: one compile,
    not one dispatch per operation)."""
    jcfg, jb, params = _tp_params(n_workers)
    loss_fn = jD.make_tp_loss_fn(jcfg, jb, tp_mesh(n_workers), mode=mode,
                                 backend=backend)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params), jb.train_mask)
    return float(loss), [np.asarray(g).tolist()
                         for g in jax.tree.leaves(grads)]


def port_loss_fn_grads(mesh, params, mode, backend) -> dict:
    """The port's loss and grads through ``make_tp_loss_fn`` and through
    ``make_tp_value_and_grad``, each with its ledger."""
    cfg, bundle = _tp_setup(mesh.size)
    loss_fn = tD.make_tp_loss_fn(cfg, bundle, mesh, mode=mode,
                                 backend=backend)
    vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                   backend=backend)
    p = P.tree_map(lambda t: t.requires_grad_(),
                   P.from_numpy_tree(params, "cpu"))
    with tT.collect_comm() as led_fn:
        loss = loss_fn(p, bundle.train_mask)
        grads = torch.autograd.grad(loss, P.tree_leaves(p))
    with tT.collect_comm() as led_vg:
        vloss, vgrads = vg(P.from_numpy_tree(params, "cpu"),
                           bundle.train_mask)
    return {"loss": loss.item(), "grads": [g.tolist() for g in grads],
            "vg_loss": vloss.item(),
            "vg_grads": [g.tolist() for g in P.tree_leaves(vgrads)],
            "ledger": led_fn.as_dict(), "vg_ledger": led_vg.as_dict()}


def _hold_loss_fn(got, want, what):
    np.testing.assert_allclose([got["loss"], got["loss"]],
                               [got["vg_loss"], want[0]], atol=ATOL,
                               err_msg=what)
    _close(got["grads"], got["vg_grads"], f"{what} vs value_and_grad")
    _close(got["grads"], want[1], f"{what} vs reference")
    assert got["ledger"] == got["vg_ledger"], what


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield TPMesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["explicit", "constraint"])
@pytest.mark.parametrize("mode", ["decoupled_pipelined", "naive"])
def test_tp_loss_fn_one_rank_matches(one_rank, mode, backend):
    _, _, params = _tp_params(1)
    got = port_loss_fn_grads(one_rank, params, mode, backend)
    _hold_loss_fn(got, reference_loss_fn_grads(1, mode, backend),
                  f"{mode} {backend}")
    grad_psum = "grad_psum|model|float32"
    assert (grad_psum in got["ledger"]) == (backend == "explicit")


def _reference_child(out: str, n: int) -> None:
    """Child process with ``n`` forced host devices: the reference's
    ``make_tp_loss_fn`` grads, written to ``out`` as JSON."""
    assert len(jax.devices()) == n
    Path(out).write_text(json.dumps(
        reference_loss_fn_grads(n, "decoupled_pipelined", "explicit")))


def _port_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = {b: port_loss_fn_grads(TPMesh(), params, "decoupled_pipelined",
                                     b) for b in ("explicit", "constraint")}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def test_tp_loss_fn_two_ranks_matches(tmp_path):
    world = 2
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_train as t; "
            "t._reference_child({!r}, {})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp_path / "ref.json"), world)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    _, _, params = _tp_params(world)
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
    want = json.loads((tmp_path / "ref.json").read_text())
    for r in range(world):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for backend, case in got.items():
            _hold_loss_fn(case, want, f"rank {r} {backend}")
