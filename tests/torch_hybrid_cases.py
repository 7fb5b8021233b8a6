"""The port's hybrid DP×TP against the JAX package's, on the CPU over gloo.

* ``resolve_mesh_shape``: both packages give the same shape, or the same
  error text, on a grid of device counts 1–16 × degrees.
* One rank (in-process): ``hybrid_mesh(1, 1)`` against the reference's
  ``hybrid_mesh(model=1, data=1)`` — GCN × {decoupled,
  decoupled_pipelined, naive} × {segment, blocksparse}, GAT ×
  {decoupled_pipelined, naive} and DP GCN × {segment, blocksparse}: loss
  and grads of one value-and-grad step, and its ledger's ``as_dict()``
  against the reference's traced ledger, data-axis entries included.
* Four spawned ranks, once for the file: the same cases on (data=2,
  model=2) and on (pod=2, data=1, model=2), which has two replica axes,
  against the reference in a child with four forced host devices; the
  rank layout of both meshes; ``data_axes=()`` on them, the pure-TP
  escape hatch, against the reference's; ``replica_slice`` on an axis
  that does not divide the replica count.
* The errors: bundle degrees that contradict the mesh, and a hybrid mesh
  given to the streamed epoch (the reference's messages).

The reference runs the ``segment`` backend throughout; the port's
``blocksparse`` cases are held against it, since the backend changes the
order of the sums and not the function, and the ledger is
backend-invariant.  Parameters come from ``repro.gnn.models.init_params``;
atol 1e-5 (fp32, sums in another order).  The ledger's stated departures
(``runtime/telemetry.py``): one stacked loss psum per axis group, on the
model axis and on the replica axes (1 call of 12 bytes against the
reference's three), and the gradient all-reduce ``grad_psum``, here over
model and replicas, under the label ``model+data`` (``model+pod+data``).

The tests are spread over ``tests/test_torch_hybrid_*.py``
(``tests/torch_split.py``).
"""
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

from repro.core import decouple as jD
from repro.core import stream as jST
from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import collectives as jC
from repro.runtime import mesh as jmesh
from repro.runtime import telemetry as jT
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.core import stream as tST
from repro_torch.core import tp as ttp
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import collectives as tC
from repro_torch.runtime import mesh as tmesh
from repro_torch.runtime import telemetry as tT

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, BS, HIDDEN, GAMMA = 3, 32, 8, 0.8
# (model, mode, port backend); the reference runs segment for each
CASES = ([("gcn", mode, agg)
          for mode in ("decoupled", "decoupled_pipelined", "naive")
          for agg in ("segment", "blocksparse")]
         + [("gat", "decoupled_pipelined", "segment"),
            ("gat", "naive", "segment"),
            ("dp", "dp", "segment"), ("dp", "dp", "blocksparse")])
MESHES = {"data2-model2": dict(model=2, data=2),
          "pod2-data1-model2": dict(model=2, data=1, pod=2)}
# the escape hatch's bundle: 5 chunks pad V=130 to 130, a multiple of the
# model degree's 10 but not of the four ranks
ESCAPE_CHUNKS = 5
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _case_id(case) -> str:
    return "-".join(case)


# ---------------------------------------------------------------------------
# The reference and the port, one case each
# ---------------------------------------------------------------------------

def _jax_setup(model, mode, n, r, n_chunks=CHUNKS):
    """(cfg, bundle) of the reference for ``n`` workers × ``r`` replicas."""
    data = jsynth.sbm_power_law(**GRAPH)
    if model == "dp":
        bundle = jDP.prepare_dp_bundle(data, k=n, n_replicas=r)
        cfg = jM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=2,
                           decoupled=False)
    else:
        bundle = jD.prepare_bundle(data, n_workers=n, n_chunks=n_chunks,
                                   n_replicas=r)
        cfg = jD.padded_gnn_config(data, bundle, model=model,
                                   hidden_dim=HIDDEN, num_layers=2,
                                   gamma=GAMMA)
    return cfg, bundle


def case_params(model, mode, n, r, n_chunks=CHUNKS) -> list:
    """The case's parameters, from the reference's ``init_params``."""
    cfg, _ = _jax_setup(model, mode, n, r, n_chunks)
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(3), cfg))


def _param_bytes(params) -> float:
    return float(sum(np.asarray(a).nbytes for a in jax.tree.leaves(params)))


def reference_case(model, mode, mesh, data_axes=None,
                   n_chunks=CHUNKS) -> dict:
    """Loss, grads and traced ledger of one reference step on ``mesh``."""
    n, r = jmesh.resolve_replicas(mesh, data_axes=data_axes)
    cfg, bundle = _jax_setup(model, mode, n, r, n_chunks)
    params = jax.tree.map(jnp.asarray,
                          case_params(model, mode, n, r, n_chunks))
    if model == "dp":
        vg = jDP.make_dp_value_and_grad(cfg, bundle, mesh,
                                        data_axes=data_axes)
    else:
        vg = jD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       data_axes=data_axes)
    with jT.collect_comm() as ledger:
        loss, grads = vg(params, bundle.train_mask)
    return {"loss": float(loss),
            "grads": [np.asarray(g).tolist() for g in jax.tree.leaves(grads)],
            "ledger": ledger.as_dict(), "param_bytes": _param_bytes(params)}


def port_case(model, mode, agg, mesh, params, data_axes=None,
              n_chunks=CHUNKS) -> dict:
    """Loss, grads and ledger of one port step on ``mesh``."""
    data = tsynth.sbm_power_law(**GRAPH)
    if model == "dp":
        bundle = tDP.prepare_dp_bundle(data, mesh=mesh, agg=agg,
                                       agg_block_size=BS, device="cpu")
        cfg = tM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=2)
        vg = tDP.make_dp_value_and_grad(cfg, bundle, mesh,
                                        data_axes=data_axes)
    else:
        n, r = tmesh.resolve_replicas(mesh, data_axes)
        bundle = tD.prepare_bundle(data, n_workers=n, n_chunks=n_chunks,
                                   n_replicas=r, agg=agg,
                                   agg_block_size=BS, device="cpu")
        cfg = tD.padded_gnn_config(data, bundle, model=model,
                                   hidden_dim=HIDDEN, num_layers=2,
                                   gamma=GAMMA)
        vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       data_axes=data_axes)
    with tT.collect_comm() as ledger:
        loss, grads = vg(P.from_numpy_tree(params, "cpu"), bundle.train_mask)
    return {"loss": loss.item(),
            "grads": [g.numpy().tolist() for g in P.tree_leaves(grads)],
            "ledger": ledger.as_dict()}


def hold_ledger(port: dict, ref: dict, n: int, r: int,
                data_axes: tuple, param_bytes: float) -> None:
    """The port's one-step ledger against the reference's traced one:
    every key and counter equal but the stated departures — the stacked
    loss psums (1 call against 3) and ``grad_psum`` over every rank."""
    psums = {"psum|model|float32"}
    if data_axes:
        psums.add(f"psum|{'+'.join(data_axes)}|float32")
    grad = f"grad_psum|{'+'.join(('model',) + tuple(data_axes))}|float32"
    assert set(port) - {grad} == set(ref), (sorted(port), sorted(ref))
    for key, want in ref.items():
        got = dict(port[key])
        if key in psums:
            assert (got.pop("calls"), want["calls"]) == (1.0, 3.0), key
            want = {k: v for k, v in want.items() if k != "calls"}
        assert got == want, key
    assert port[grad] == {
        "calls": 1.0, "payload_bytes": param_bytes,
        "wire_bytes": tT.ring_wire_factor("psum", n * r) * param_bytes,
        "mirrored_calls": 0.0, "mirrored_wire_bytes": 0.0}
    for a in data_axes:
        assert f"all_gather|{a}|float32" in port, a


def hold_case(got: dict, want: dict, n: int, r: int, data_axes: tuple,
              what: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL,
                               err_msg=what)
    assert len(got["grads"]) == len(want["grads"]), what
    for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} grad {i}")
    hold_ledger(got["ledger"], want["ledger"], n, r, data_axes,
                want["param_bytes"])


# ---------------------------------------------------------------------------
# The mesh shape contract
# ---------------------------------------------------------------------------

def _shape_or_error(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("n_devices", range(1, 17))
def test_resolve_mesh_shape_matches_reference(n_devices):
    for model in (None, 1, 2, 3, 4, 8, 0, -1, 2.0):
        for data in (1, 2, 3, 4):
            for pod in (1, 2):
                kw = dict(model=model, data=data, pod=pod, note=" (x)")
                assert _shape_or_error(tmesh.resolve_mesh_shape, n_devices,
                                       **kw) == \
                    _shape_or_error(jmesh.resolve_mesh_shape, n_devices,
                                    **kw), kw
    assert _shape_or_error(tmesh.resolve_mesh_shape, 0) == \
        _shape_or_error(jmesh.resolve_mesh_shape, 0)


# ---------------------------------------------------------------------------
# One rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield tmesh.hybrid_mesh(model=1, data=1)
    dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_rank_hybrid_matches_reference(one_rank, case):
    model, mode, agg = case
    assert (one_rank.size, one_rank.data_size, one_rank.data_axes) == \
        (1, 1, ("data",))
    want = reference_case(model, mode, jmesh.hybrid_mesh(model=1, data=1))
    got = port_case(model, mode, agg, one_rank,
                    case_params(model, mode, 1, 1))
    hold_case(got, want, 1, 1, ("data",), _case_id(case))
    assert tT.CommLedger.from_dict(got["ledger"]).wire_bytes(
        train=True) == 0.0                  # no ring traffic at 1 rank


def test_bundle_degrees_must_match_mesh(one_rank):
    jdata, tdata = (m.sbm_power_law(**GRAPH) for m in (jsynth, tsynth))
    jm = jmesh.hybrid_mesh(model=1, data=1)
    for jcall, tcall in [
            (lambda: jD.prepare_bundle(jdata, n_workers=2, mesh=jm),
             lambda: tD.prepare_bundle(tdata, n_workers=2, mesh=one_rank,
                                       device="cpu")),
            (lambda: jDP.prepare_dp_bundle(jdata, k=1, n_replicas=2,
                                           mesh=jm),
             lambda: tDP.prepare_dp_bundle(tdata, k=1, n_replicas=2,
                                           mesh=one_rank, device="cpu"))]:
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError, match="contradicts mesh degrees") \
                as got:
            tcall()
        assert str(got.value) == str(want.value)


def test_hybrid_mesh_is_not_streamable(one_rank):
    jdata, tdata = (m.sbm_power_law(**GRAPH) for m in (jsynth, tsynth))
    with pytest.raises(ValueError) as want:
        jST.prepare_stream_bundle(jdata, mesh=jmesh.hybrid_mesh(1, 1),
                                  n_chunks=CHUNKS)
    sb = tST.prepare_stream_bundle(tdata, 1, n_chunks=CHUNKS, device="cpu")
    cfg = tST.stream_gnn_config(tdata, sb, hidden_dim=HIDDEN)
    with pytest.raises(ValueError) as got:
        tST.make_stream_value_and_grad(cfg, sb, one_rank)
    # the reference's gate, word for word from its subject on
    gate = "hybrid DP×TP meshes (data axes ('data',)) are not streamable " \
           "— the stripe slicing contract is pure-TP vertex-sharded."
    assert gate in str(want.value) and gate in str(got.value)
    # the constraint backend keeps the gate
    with pytest.raises(ValueError) as got:
        tST.make_stream_value_and_grad(cfg, sb, one_rank,
                                       backend="constraint")
    assert gate in str(got.value)


def test_replica_block_refuses_to_floor():
    with pytest.raises(ValueError) as want:
        jC._replica_block(7, 2, 0, ("pod", "data"))
    with pytest.raises(ValueError) as got:
        tC._replica_block(7, 2, 0, ("pod", "data"))
    head = "replica_slice: axis 0 of length 7 does not divide the replica " \
           "count 2 (= product of data axes ('pod', 'data')) — flooring " \
           "would silently drop 1 trailing rows per replica"
    assert str(want.value).startswith(head)
    assert str(got.value).startswith(head)
    assert tC._replica_block(8, 2, 0, ("data",)) == 4


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

def _reference_child(out: str) -> None:
    """Child process with four forced host devices: the reference's cases
    on both meshes, and the pure-TP escape hatch on each, as JSON."""
    assert len(jax.devices()) == 4
    res = {}
    for name, shape in MESHES.items():
        mesh = jmesh.hybrid_mesh(**shape)
        for model, mode in dict.fromkeys((m, mo) for m, mo, _ in CASES):
            res[f"{name}/{model}-{mode}"] = reference_case(model, mode, mesh)
        res[f"{name}/escape"] = reference_case(
            "gcn", "decoupled_pipelined", mesh, data_axes=(),
            n_chunks=ESCAPE_CHUNKS)
    Path(out).write_text(json.dumps(res))


def _port_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        res = {}
        for name, shape in MESHES.items():
            mesh = tmesh.hybrid_mesh(**shape)
            rep = mesh.replicas()
            res[f"{name}/layout"] = [
                mesh.index, tC.replica_index(rep), tC.replica_size(rep),
                list(ttp.vertex_block(mesh)),
                list(mesh.shape.items())]
            for model, mode, agg in CASES:
                res[f"{name}/{model}-{mode}-{agg}"] = port_case(
                    model, mode, agg, mesh, params[f"{model}-{mode}"])
            # the escape hatch's bundle does not fit the hybrid layout
            data = tsynth.sbm_power_law(**GRAPH)
            bundle = tD.prepare_bundle(data, n_workers=mesh.size,
                                       n_chunks=ESCAPE_CHUNKS, device="cpu")
            cfg = tD.padded_gnn_config(data, bundle, hidden_dim=HIDDEN)
            try:
                tD.make_tp_value_and_grad(cfg, bundle, mesh)
                res[f"{name}/escape-unpadded"] = "no error"
            except ValueError as e:
                res[f"{name}/escape-unpadded"] = str(e)
            res[f"{name}/escape"] = port_case(
                "gcn", "decoupled_pipelined", "segment", mesh,
                params["escape"], data_axes=(), n_chunks=ESCAPE_CHUNKS)
            try:
                tC.replica_slice(torch.zeros(3, 2), rep)
                res[f"{name}/slice"] = "no error"
            except ValueError as e:
                res[f"{name}/slice"] = str(e)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn for the file: four port ranks and the reference child,
    side by side; their results as ({key: reference}, [{key: port}] by
    rank)."""
    world, tmp = 4, tmp_path_factory.mktemp("four")
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import torch_hybrid_cases as t; "
            "t._reference_child({!r})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp / "ref.json"))
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    params = {f"{m}-{mo}": case_params(m, mo, 2, 2)
              for m, mo, _ in CASES}
    params["escape"] = case_params("gcn", "decoupled_pipelined", 2, 1,
                                   ESCAPE_CHUNKS)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", params, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    for p in procs:
        if p.is_alive():
            p.kill()
    _, err = child.communicate(timeout=180)
    assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world
    return (json.loads((tmp / "ref.json").read_text()),
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])


@pytest.mark.parametrize("name", MESHES)
def test_four_ranks_hybrid_matches_reference(four_ranks, name):
    ref, ranks = four_ranks
    shape = MESHES[name]
    n, data, pod = shape["model"], shape["data"], shape.get("pod", 1)
    r = data * pod
    data_axes = ("pod", "data") if pod > 1 else ("data",)
    # rank (p·data + d)·model + m: model index m, replica p·data + d, rows
    # block m·R + (p·data + d)
    for rank, got in enumerate(ranks):
        m, rep_idx = rank % n, rank // n
        axes = [["model", n]] + ([["pod", pod]] if pod > 1 else []) \
            + [["data", data]]
        assert got[f"{name}/layout"] == [m, rep_idx, r,
                                         [m * r + rep_idx, n * r], axes]
    for model, mode, agg in CASES:
        key = f"{model}-{mode}-{agg}"
        want = ref[f"{name}/{model}-{mode}"]
        for rank, got in enumerate(ranks):
            hold_case(got[f"{name}/{key}"], want, n, r, data_axes,
                      f"{name} {key} rank {rank}")
        assert all(got[f"{name}/{key}"]["ledger"]
                   == ranks[0][f"{name}/{key}"]["ledger"] for got in ranks)
        led = tT.CommLedger.from_dict(ranks[0][f"{name}/{key}"]["ledger"])
        assert led.wire_bytes("all_gather", data_axes[0], train=True) > 0.0
    # data_axes=() is pure TP inside each replica group, and validates
    # against the model degree alone
    for rank, got in enumerate(ranks):
        assert "n_replicas=2" in got[f"{name}/escape-unpadded"]
        hold_case(got[f"{name}/escape"], ref[f"{name}/escape"], n, 1, (),
                  f"{name} escape rank {rank}")
        assert "does not divide the replica count 2" in got[f"{name}/slice"]
