"""The port's constraint engine backend against the JAX package's, on the
CPU over gloo.

* The ledger's transition side: ``implied_collectives``,
  ``normalize_spec`` and ``_spec_placement`` against the reference's on a
  table of (shape, src, dst, axis sizes), hybrid and three axes included.
* One rank, in process: GCN × {decoupled, decoupled_pipelined, naive} ×
  {segment, blocksparse}, GAT naive and DP × {segment, blocksparse} under
  ``backend="constraint"`` — loss and grads of one step against the
  reference's constraint backend and the port's explicit one, the ledger's
  all-to-all and all-gather entries against both; the streamed epoch
  against the in-memory constraint step and, on ``segment``, the
  reference's streamed constraint epoch (and its ``h2d`` bytes against
  ``expected_h2d_bytes``); the gates; ``constrain``'s refusals.
* Four spawned ranks, once for the file, beside a JAX child with four
  forced host devices: pure TP (model=4), (data=2, model=2) and (pod=2,
  data=1, model=2); GCN decoupled and naive, GAT decoupled, DP — loss and
  grads against the reference's constraint backend, the ledger against
  its constraint ledger and the port's explicit one; the streamed epoch
  on pure TP; each transition's records against ``implied_collectives``;
  the ``full_tensor()`` row order of the hybrid vertex layout; and a
  ``CommDebugMode`` census of the step: DTensor's own collectives
  (``c10d_functional.*``) are all-reduces only, the loss sums' and the
  gradients', one per mesh dim of size > 1 each.

The reference runs the ``segment`` backend throughout; the port's
``blocksparse`` cases are held against it (the backend changes the order
of the sums, not the function).  atol 1e-5 (fp32).  The stated
departures (``runtime/telemetry.py``): the port runs and records GAT's
score all-gathers (``all_gather|model``) and the DP baseline's replica
gathers (``all_gather|data``, ``pod``) under this backend, where the
reference's partitioner makes them unrecorded — they equal the port's
explicit ledger's instead; and it records no ``psum`` or ``grad_psum``:
those reductions are DTensor's, counted by the census.
"""
import datetime
import json
import math
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
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor.debug import CommDebugMode

from repro.core import decouple as jD
from repro.core import stream as jST
from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import mesh as jmesh
from repro.runtime import telemetry as jT
from repro_torch import params as P
from repro_torch.core import decouple as tD
from repro_torch.core import stream as tST
from repro_torch.core import tp as ttp
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import constraint as K
from repro_torch.runtime import mesh as tmesh
from repro_torch.runtime import telemetry as tT

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, BS, HIDDEN, GAMMA = 3, 32, 8, 0.8
ONE_RANK = ([("gcn", mode, agg)
             for mode in ("decoupled", "decoupled_pipelined", "naive")
             for agg in ("segment", "blocksparse")]
            + [("gat", "naive", "segment")]
            + [("dp", "dp", "segment"), ("dp", "dp", "blocksparse")])
MESHES = {"model4": dict(model=4),
          "data2-model2": dict(model=2, data=2),
          "pod2-data1-model2": dict(model=2, data=1, pod=2)}
# the four-rank cases on each mesh (few: the reference child compiles
# each one)
GCN_DEC, GCN_NAIVE = ("gcn", "decoupled", "blocksparse"), \
    ("gcn", "naive", "segment")
GAT, DP = ("gat", "decoupled", "segment"), ("dp", "dp", "blocksparse")
FOUR_RANKS = {"model4": [GCN_DEC, GAT, DP],
              "data2-model2": [GCN_DEC, GAT, DP],
              "pod2-data1-model2": [GCN_NAIVE]}
# (shape, src, dst, axis sizes): the transitions of the TP, DP and GAT
# paths, each as the forwards stage it
TRANSITIONS = [
    ((8, 8), ("model", None), (None, "model"), {"model": 4}),
    ((8, 8), (None, "model"), ("model", None), {"model": 4}),
    ((8, 6), (("model", "data"), None), ("model", None),
     {"model": 2, "data": 2}),
    ((8, 6), (("model", "data"), None), (None, "model"),
     {"model": 2, "data": 2}),
    ((8, 6), ("model", None), (("model", "data"), None),
     {"model": 2, "data": 2}),
    ((8, 6), (("model", "pod", "data"), None), ("model", None),
     {"model": 2, "pod": 2, "data": 1}),
    ((8, 6), (("model", "pod", "data"), None), (None, "model"),
     {"model": 2, "pod": 2, "data": 1}),
    ((2, 4, 3), ("model", "data", None), ("model", None, None),
     {"model": 2, "data": 2}),
    ((4, 4, 3, 5), (None, "model"), ("model",), {"model": 4}),
    ((8,), ("model",), (), {"model": 4}),
    ((8, 8), ("model", None), ("model",), {"model": 4}),
]
COLLECTIVES = ("all_to_all", "all_gather")
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _case_id(case) -> str:
    return "-".join(case)


def _mesh_axes(sizes: dict) -> tuple:
    """A mesh's replica axes, outermost first, for ``sizes``."""
    return tuple(a for a in ("pod", "data") if a in sizes)


# ---------------------------------------------------------------------------
# The reference and the port, one case each
# ---------------------------------------------------------------------------

def _jax_setup(model, n, r):
    data = jsynth.sbm_power_law(**GRAPH)
    if model == "dp":
        bundle = jDP.prepare_dp_bundle(data, k=n, n_replicas=r)
        cfg = jM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=2,
                           decoupled=False)
    else:
        bundle = jD.prepare_bundle(data, n_workers=n, n_chunks=CHUNKS,
                                   n_replicas=r)
        cfg = jD.padded_gnn_config(data, bundle, model=model,
                                   hidden_dim=HIDDEN, num_layers=2,
                                   gamma=GAMMA)
    return cfg, bundle


def case_params(model, n, r) -> list:
    """The case's parameters, from the reference's ``init_params``."""
    cfg, _ = _jax_setup(model, n, r)
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(3), cfg))


def reference_case(model, mode, mesh) -> dict:
    """Loss, grads and traced ledger of one reference constraint step."""
    n, r = jmesh.resolve_replicas(mesh)
    cfg, bundle = _jax_setup(model, n, r)
    params = jax.tree.map(jnp.asarray, case_params(model, n, r))
    if model == "dp":
        vg = jDP.make_dp_value_and_grad(cfg, bundle, mesh,
                                        backend="constraint")
    else:
        vg = jD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       backend="constraint")
    with jT.collect_comm() as ledger:
        loss, grads = vg(params, bundle.train_mask)
    return {"loss": float(loss),
            "grads": [np.asarray(g).tolist() for g in jax.tree.leaves(grads)],
            "ledger": ledger.as_dict()}


def _port_setup(model, agg, mesh):
    data = tsynth.sbm_power_law(**GRAPH)
    if model == "dp":
        bundle = tDP.prepare_dp_bundle(data, mesh=mesh, agg=agg,
                                       agg_block_size=BS, device="cpu")
        cfg = tM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=2)
    else:
        bundle = tD.prepare_bundle(data, mesh=mesh, n_chunks=CHUNKS,
                                   agg=agg, agg_block_size=BS, device="cpu")
        cfg = tD.padded_gnn_config(data, bundle, model=model,
                                   hidden_dim=HIDDEN, num_layers=2,
                                   gamma=GAMMA)
    return cfg, bundle


def port_case(model, mode, agg, mesh, params, backend) -> dict:
    """Loss, grads, ledger and ``CommDebugMode`` census of one port step."""
    cfg, bundle = _port_setup(model, agg, mesh)
    if model == "dp":
        vg = tDP.make_dp_value_and_grad(cfg, bundle, mesh, backend=backend)
    else:
        vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       backend=backend)
    with tT.collect_comm() as ledger, CommDebugMode() as census:
        loss, grads = vg(P.from_numpy_tree(params, "cpu"), bundle.train_mask)
    return {"loss": loss.item(),
            "grads": [g.numpy().tolist() for g in P.tree_leaves(grads)],
            "ledger": ledger.as_dict(),
            "census": {str(k): v
                       for k, v in census.get_comm_counts().items()},
            "transitions": len(ledger.transitions())}


def moves(ledger: dict) -> dict:
    """The ledger's all-to-all and all-gather entries."""
    return {k: v for k, v in ledger.items()
            if k.split("|")[0] in COLLECTIVES}


def _close(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL,
                               err_msg=what)
    assert len(got["grads"]) == len(want["grads"]), what
    for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} grad {i}")


def hold_case(model, got: dict, explicit: dict, ref: dict,
              functional_reduces: int | None, what: str) -> None:
    """The port's constraint step against the reference's constraint step
    and the port's explicit one (module docstring)."""
    _close(got, ref, what + " vs reference")
    _close(got, explicit, what + " vs explicit")
    led = got["ledger"]
    assert set(led) == set(moves(led)), (what, sorted(led))
    assert moves(led) == moves(explicit["ledger"]), what
    departures = {k for k in led if k.startswith("all_gather|") and (
        model == "dp" or (model == "gat" and k.split("|")[1] == "model"))}
    assert {k: v for k, v in led.items() if k not in departures} == \
        moves(ref["ledger"]), what
    assert not departures & set(ref["ledger"]), what
    assert got["transitions"] > 0, what
    functional = {k: v for k, v in got["census"].items()
                  if k.startswith("c10d_functional.")}
    assert set(functional) <= {"c10d_functional.all_reduce"}, \
        (what, got["census"])
    if functional_reduces is not None:
        assert sum(functional.values()) == functional_reduces, \
            (what, got["census"])


# ---------------------------------------------------------------------------
# The ledger's transition side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TRANSITIONS,
                         ids=lambda c: f"{c[1]}->{c[2]}@{c[3]}")
def test_implied_collectives_match_reference(case):
    shape, src, dst, sizes = case
    assert tT.implied_collectives(shape, 4, src, dst, sizes) == \
        jT.implied_collectives(shape, 4, JP(*src), JP(*dst), sizes)
    for spec in (src, dst):
        assert tT.normalize_spec(spec) == jT.normalize_spec(JP(*spec))
        assert tT._spec_placement(spec, len(shape)) == \
            jT._spec_placement(JP(*spec), len(shape))
    with pytest.raises(tT.TelemetryError, match="mesh axis"):
        tT.implied_collectives(shape, 4, src, dst, {})


def test_transition_records_are_kept_apart_from_counters():
    led = tT.CommLedger()
    with tT.collect_comm(led):
        tT.record_transition((8, 6), "float32", ("model", None),
                             (None, "model"), anchored=True)
    assert not led and led.transitions() == (tT.TransitionRecord(
        (8, 6), "float32", ("model",), (None, "model"), True, True),)
    assert led.as_dict() == {}


# ---------------------------------------------------------------------------
# One rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield tmesh.TPMesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def references():
    """The reference's constraint steps at one device, by (model, mode)."""
    cache = {}

    def get(model, mode):
        if (model, mode) not in cache:
            cache[model, mode] = reference_case(model, mode,
                                                jmesh.tp_mesh(1))
        return cache[model, mode]

    return get


@pytest.mark.parametrize("case", ONE_RANK, ids=_case_id)
def test_one_rank_matches_reference_and_explicit(one_rank, references, case):
    model, mode, agg = case
    params = case_params(model, 1, 1)
    # decoupled_pipelined is decoupled under this backend, as in the
    # reference: its ledger is the unpipelined explicit step's
    unpipelined = "decoupled" if mode == "decoupled_pipelined" else mode
    got = port_case(model, mode, agg, one_rank, params, "constraint")
    explicit = port_case(model, unpipelined, agg, one_rank, params,
                         "explicit")
    hold_case(model, got, explicit, references(model, unpipelined), None,
              _case_id(case))
    if mode != "naive":
        # the alias: the constraint backend runs no chunk interleaving
        assert got["ledger"]["all_to_all|model|float32"]["calls"] == 2.0


@pytest.mark.parametrize("agg", ["segment", "blocksparse"])
def test_streamed_epoch_matches_in_memory(one_rank, agg):
    data = tsynth.sbm_power_law(**GRAPH)
    sb = tST.prepare_stream_bundle(data, 1, n_chunks=CHUNKS, agg=agg,
                                   agg_block_size=BS, device="cpu")
    cfg = tST.stream_gnn_config(data, sb, hidden_dim=HIDDEN, gamma=GAMMA)
    params = case_params("gcn", 1, 1)
    vg = tST.make_stream_value_and_grad(cfg, sb, one_rank,
                                        mode="decoupled_pipelined",
                                        backend="constraint")
    with tT.collect_comm() as led:
        loss, grads = vg(P.from_numpy_tree(params, "cpu"), sb.train_mask)
    want = port_case("gcn", "decoupled", agg, one_rank, params, "constraint")
    _close({"loss": loss.item(),
            "grads": [g.numpy() for g in P.tree_leaves(grads)]}, want,
           f"stream {agg}")
    assert moves(led.as_dict()) == moves(want["ledger"])
    assert led.payload_bytes(op=tT.H2D_OP) == tST.expected_h2d_bytes(sb,
                                                                      cfg)
    assert not led.payload_bytes(op="psum") + led.payload_bytes(
        op="grad_psum")
    if agg == "segment":
        # and the reference's streamed constraint epoch (its blocksparse
        # runs the Pallas interpreter: the in-memory hold covers it)
        jdata = jsynth.sbm_power_law(**GRAPH)
        jsb = jST.prepare_stream_bundle(jdata, n_chunks=CHUNKS)
        jcfg = jST.stream_gnn_config(jdata, jsb, hidden_dim=HIDDEN,
                                     gamma=GAMMA)
        jloss, jgrads = jST.make_stream_value_and_grad(
            jcfg, jsb, backend="constraint")(
            jax.tree.map(jnp.asarray, params), jsb.train_mask)
        _close({"loss": loss.item(),
                "grads": [g.numpy() for g in P.tree_leaves(grads)]},
               {"loss": float(jloss),
                "grads": [np.asarray(g) for g in jax.tree.leaves(jgrads)]},
               "stream vs reference")


def test_streamed_gates_keep_reference_messages(one_rank):
    data = tsynth.sbm_power_law(**GRAPH)
    sb = tST.prepare_stream_bundle(data, 1, n_chunks=CHUNKS, device="cpu")
    cfg = tST.stream_gnn_config(data, sb, hidden_dim=HIDDEN)
    gat = tST.stream_gnn_config(data, sb, model="gat", hidden_dim=HIDDEN)
    for kw, c, text in [
            ({"mode": "naive"}, cfg, "the coupled 'naive' baseline "
             "re-splits every layer"),
            ({}, gat, "streaming does not support GAT"),
            ({"backend": "xla"}, cfg, "stream backend must be 'explicit' "
             "or 'constraint', got 'xla'")]:
        with pytest.raises(ValueError, match=text):
            tST.make_stream_value_and_grad(c, sb, one_rank,
                                           **{"backend": "constraint", **kw})
    hybrid = tmesh.hybrid_mesh(1, 1)
    with pytest.raises(ValueError, match="hybrid DP×TP meshes .* are not "
                       "streamable — the stripe slicing contract is "
                       "pure-TP vertex-sharded."):
        tST.make_stream_value_and_grad(cfg, sb, hybrid, backend="constraint")


def test_constrain_moves_only_what_is_free(one_rank):
    x = torch.arange(12.0).reshape(4, 3)
    assert K.constrain(x, (None, "model")) is x      # no active mesh
    assert K.layout_cast(x, (None, "model"), ("model",)) is x
    with K.mesh_context(one_rank):
        rows = K.from_local(x, ("model", None))
        assert K.constrain(rows, ("model", None)) is rows
        with pytest.raises(ValueError, match="needs a collective; write "
                           "it as layout_cast"):
            K.constrain(rows, (None, "model"))
        with pytest.raises(ValueError, match="needs a collective"):
            K.constrain(rows, ())
        whole = K.from_local(x, ())
        assert torch.equal(K.constrain(whole, (None, "model"))
                           .to_local(), x)          # a local slice
        with pytest.raises(ValueError, match="names mesh axis 'data'"):
            K.constrain(whole, ("data",))
        part = K.local_map(lambda t: t.sum(), None, rows, partial=True)
        with pytest.raises(ValueError, match="Partial tensor"):
            K.constrain(part, ())
        assert K.replicate(part).to_local() == x.sum()
        with pytest.raises(ValueError, match="no Partial dim"):
            K.replicate(whole)
        with pytest.raises(ValueError, match="mirror=False on a tensor "
                           "that requires grad"):
            K.layout_cast(K.from_local(x.requires_grad_(), ("model",)),
                          (None, "model"), ("model", None),
                          mirror=False)
        with pytest.raises(ValueError, match="laid out"):
            K.note_transition(rows, (None, "model"), ("model",))


def test_unknown_backend_and_bad_specs(one_rank):
    cfg, bundle = _port_setup("gcn", "segment", one_rank)
    with pytest.raises(ValueError, match="engine backend must be"):
        tD.make_tp_value_and_grad(cfg, bundle, one_rank, backend="xla")
    dcfg, dp = _port_setup("dp", "segment", one_rank)
    with pytest.raises(ValueError, match="engine backend must be"):
        tDP.make_dp_train_fns(dcfg, dp, one_rank, None, backend="xla")
    with pytest.raises(ValueError, match="on more than one dimension"):
        K.validate_specs(one_rank, [("model", "model")])
    hybrid = tmesh.hybrid_mesh(1, 1)
    with pytest.raises(ValueError, match="must follow the mesh's dim order"):
        K.placements((("data", "model"),), hybrid)
    with K.mesh_context(hybrid):
        x = K.from_local(torch.zeros(4, 2), (("model", "data"), None))
        with pytest.raises(NotImplementedError, match="not the innermost"):
            K.layout_cast(x, ("data", None), (("model", "data"), None))


def test_constraint_train_fns_train(one_rank):
    cfg, bundle = _port_setup("gcn", "blocksparse", one_rank)
    from repro_torch.optim.adamw import adamw
    opt = adamw(1e-2)
    params = P.from_numpy_tree(case_params("gcn", 1, 1), "cpu")
    step, evaluate = tD.make_tp_train_fns(cfg, bundle, one_rank, opt,
                                          backend="constraint")
    estep, _ = tD.make_tp_train_fns(cfg, bundle, one_rank, opt)
    p, o, ep, eo = params, opt.init(params), params, opt.init(params)
    for _ in range(3):
        p, o, loss = step(p, o)
        ep, eo, eloss = estep(ep, eo)
        np.testing.assert_allclose(loss.item(), eloss.item(), atol=ATOL)
    loss, acc = evaluate(p, "val")
    assert isinstance(loss, torch.Tensor) and 0.0 <= acc.item() <= 1.0


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

def _jax_mesh(shape: dict):
    if "data" in shape:
        return jmesh.hybrid_mesh(**shape)
    return jmesh.tp_mesh(shape["model"])


def _torch_mesh(shape: dict):
    if "data" in shape:
        return tmesh.hybrid_mesh(**shape)
    return tmesh.TPMesh()


def _reference_child(out: str) -> None:
    """Child process with four forced host devices: the reference's
    constraint steps on every mesh, as JSON."""
    assert len(jax.devices()) == 4
    res = {}
    for name, shape in MESHES.items():
        mesh = _jax_mesh(shape)
        for model, mode, _ in FOUR_RANKS[name]:
            res[f"{name}/{model}-{mode}"] = reference_case(model, mode, mesh)
    Path(out).write_text(json.dumps(res))


def _transition_ledgers(mesh) -> list:
    """Each TRANSITIONS case the mesh can run: one forward and backward
    through ``layout_cast`` on a fresh ledger, whether its values survive
    (``full_tensor``), and its transition record."""
    out = []
    for shape, src, dst, sizes in TRANSITIONS:
        if sizes != mesh.shape:
            continue
        x = torch.arange(float(math.prod(shape))).reshape(shape)
        with K.mesh_context(mesh):
            xs = K.constrain(K.from_local(x, ()), src)
            xs = K.from_local(xs.to_local().requires_grad_(), src)
            with tT.collect_comm() as led:
                y = K.layout_cast(xs, dst, src_spec=src)
                y.to_local().sum().backward()
        out.append({"case": [list(shape), src, dst],
                    "ledger": led.as_dict(),
                    "same": bool(torch.equal(y.full_tensor(), x)),
                    "record": [[list(r.src_spec), list(r.dst_spec),
                                r.anchored] for r in led.transitions()]})
    return out


def _port_rank(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        res = {}
        for name, shape in MESHES.items():
            mesh = _torch_mesh(shape)
            for model, mode, agg in FOUR_RANKS[name]:
                for backend in ("constraint", "explicit"):
                    res[f"{name}/{model}-{mode}-{backend}"] = port_case(
                        model, mode, agg, mesh, params[f"{name}/{model}"],
                        backend)
            res[f"{name}/transitions"] = _transition_ledgers(mesh)
            # the vertex layout's rows — the placed bundle's, this rank's
            # block only — reassembled by DTensor itself into the whole
            _, bundle = _port_setup("gcn", "segment", mesh)
            whole = tD.prepare_bundle(
                tsynth.sbm_power_law(**GRAPH), n_workers=mesh.size,
                n_chunks=CHUNKS, n_replicas=mesh.data_size, device="cpu")
            x = K.from_local(bundle.features,
                             ttp.vertex_spec("model", mesh.data_axes), mesh)
            res[f"{name}/rows"] = bool(torch.equal(x.full_tensor(),
                                                   whole.features))
        mesh = tmesh.TPMesh()
        data = tsynth.sbm_power_law(**GRAPH)
        sb = tST.prepare_stream_bundle(data, world, n_chunks=CHUNKS,
                                       device="cpu")
        cfg = tST.stream_gnn_config(data, sb, hidden_dim=HIDDEN, gamma=GAMMA)
        with tT.collect_comm() as led:
            loss, grads = tST.make_stream_value_and_grad(
                cfg, sb, mesh, backend="constraint")(
                P.from_numpy_tree(params["model4/gcn"], "cpu"), sb.train_mask)
        res["stream"] = {"loss": loss.item(),
                         "grads": [g.numpy().tolist()
                                   for g in P.tree_leaves(grads)],
                         "ledger": led.as_dict()}
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
            "import test_torch_constraint as t; "
            "t._reference_child({!r})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp / "ref.json"))
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    params = {}
    for name, shape in MESHES.items():
        n = shape["model"]
        r = shape.get("data", 1) * shape.get("pod", 1)
        for model in ("gcn", "gat", "dp"):
            params[f"{name}/{model}"] = case_params(model, n, r)
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
def test_four_ranks_match_reference_and_explicit(four_ranks, name):
    ref, ranks = four_ranks
    shape = MESHES[name]
    # DTensor reduces a Partial dim by one all-reduce per mesh dim of
    # size > 1: the loss sums once, the gradients once
    dims = sum(1 for v in shape.values() if v > 1)
    for model, mode, _ in FOUR_RANKS[name]:
        key = f"{name}/{model}-{mode}"
        for rank, got in enumerate(ranks):
            hold_case(model, got[f"{key}-constraint"],
                      got[f"{key}-explicit"], ref[key], 2 * dims,
                      f"{key} rank {rank}")
        led = tT.CommLedger.from_dict(ranks[0][f"{key}-constraint"]["ledger"])
        assert led.wire_bytes("all_to_all", "model", train=True) > 0.0
        for a in _mesh_axes(shape):
            assert f"all_gather|{a}|float32" in led.as_dict(), (key, a)
    assert all(got[f"{name}/rows"] for got in ranks)


@pytest.mark.parametrize("name", MESHES)
def test_four_ranks_transitions_record_implied_collectives(four_ranks, name):
    _, ranks = four_ranks
    runs = ranks[0][f"{name}/transitions"]
    assert runs
    for got in ranks:
        assert got[f"{name}/transitions"] == runs
    for run in runs:
        shape, src, dst = run["case"]
        src, dst = (tuple(tuple(e) if isinstance(e, list) else e for e in s)
                    for s in (src, dst))
        want = {}
        for op, axis, payload, wire in tT.implied_collectives(
                shape, 4, src, dst, MESHES[name]):
            want[f"{op}|{axis}|float32"] = {
                "calls": 1.0, "payload_bytes": payload, "wire_bytes": wire,
                "mirrored_calls": 1.0, "mirrored_wire_bytes": wire}
        assert run["ledger"] == want, run["case"]
        assert run["same"], run["case"]
        assert run["record"] == json.loads(json.dumps(
            [[tT.normalize_spec(src), tT.normalize_spec(dst), True]]))


def test_four_ranks_streamed_epoch_matches_in_memory(four_ranks):
    _, ranks = four_ranks
    for got in ranks:
        want = got["model4/gcn-decoupled-constraint"]
        _close(got["stream"], want, "stream")
        assert moves(got["stream"]["ledger"]) == moves(want["ledger"])
