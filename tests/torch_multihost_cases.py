"""The port's multihost launch path (``repro_torch.runtime.distributed``,
``repro_torch.launch.multihost``) against the JAX package's, on the CPU
over gloo.

* Fast: eager topology validation with the reference's error texts, the
  env contract parser, the single-process context, a topology query
  before ``initialize`` under the env contract, the mesh note naming the
  process topology, and the port's ``CommLedger`` round trip and merge
  (``tests/test_multihost.py``'s fast lane).
* Four processes started through the env contract alone (``initialize()``
  with no argument), once for the file, beside a JAX child with four
  forced host devices:

  - per-rank placement: a placed TP bundle holds ``n_padded/4`` rows of
    its node arrays, 1/4 of the unplaced bundle's bytes and equal to its
    block of them; a placed DP bundle one partition (also staged slab by
    slab, with one ``h2d`` entry a slab); a placed stream bundle its
    labels and masks;
  - pure TP (model=4): GCN decoupled, naive and DP (explicit), GCN
    decoupled (constraint) and GAT decoupled-pipelined; hybrid (data=2,
    model=2): GCN decoupled — loss and grads at atol 1e-5 of the
    reference's, the ledger entry for entry (the stated departures of
    ``runtime/telemetry.py``: one stacked loss psum per axis group,
    ``grad_psum``; under the constraint backend the all-to-all and
    all-gather entries);
  - every rank's ledger equal, the merged ledger 4× one rank's.

* The launcher: ``launch.multihost`` in two gloo processes (only process
  0 prints, both see the same losses), and
  ``scripts/launch_multihost_torch.sh -n 2``.
* Failure modes: an unreachable coordinator and a job launched with too
  few processes fail within ``DIST_INIT_TIMEOUT``, never hanging.

The tests are spread over ``tests/test_torch_multihost_*.py``
(``tests/torch_split.py``): each file with four processes runs its own
cases (``NAMES``).
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decouple as jD
from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import mesh as jmesh
from repro.runtime import telemetry as jT
from repro_torch import params as P
from repro_torch.runtime import distributed as dist
from repro_torch.runtime import mesh as tmesh
from repro_torch.runtime import telemetry as tT
from repro_torch.runtime.telemetry import CommLedger, TelemetryError

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
WORLD = 4
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, HIDDEN, GAMMA = 3, 8, 0.8
# name: (model, mode, backend, mesh); the reference runs the same
CASES = {
    "gcn-decoupled": ("gcn", "decoupled", "explicit", "model4"),
    "gcn-naive": ("gcn", "naive", "explicit", "model4"),
    "dp": ("dp", "dp", "explicit", "model4"),
    "gcn-decoupled-constraint": ("gcn", "decoupled", "constraint",
                                 "model4"),
    "gat-decoupled_pipelined": ("gat", "decoupled_pipelined", "explicit",
                                "model4"),
    "hybrid-gcn-decoupled": ("gcn", "decoupled", "explicit",
                             "data2-model2"),
}
MESH_DEGREES = {"model4": (4, 1), "data2-model2": (2, 2)}
LAUNCH = ["--device", "cpu", "--n", "300", "--feat-dim", "16",
          "--classes", "4", "--hidden", "8", "--epochs", "3"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**contract) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in dist.ENV_CONTRACT}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"    # several processes at once, tiny graphs
    env.update({k: str(v) for k, v in contract.items()})
    return env


# ---------------------------------------------------------------------------
# fast: eager topology validation (no sockets)
# ---------------------------------------------------------------------------

def test_initialize_rejects_bad_topology():
    with pytest.raises(ValueError, match=r"process_id=5 out of range"):
        dist.initialize(coordinator_address="127.0.0.1:1",
                        num_processes=2, process_id=5, device="cpu")
    with pytest.raises(ValueError, match="coordinator address"):
        dist.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        dist.initialize(coordinator_address="nocolon",
                        num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="num_processes=0"):
        dist.initialize(coordinator_address="127.0.0.1:1",
                        num_processes=0, process_id=0, device="cpu")
    assert not dist.is_initialized()


def test_env_topology_parsing():
    env = {dist.ENV_COORDINATOR: "10.0.0.1:1234",
           dist.ENV_NUM_PROCESSES: "16", dist.ENV_PROCESS_ID: "3",
           dist.ENV_INIT_TIMEOUT: "5.5"}
    assert dist.env_topology(env) == {
        "coordinator_address": "10.0.0.1:1234", "num_processes": 16,
        "process_id": 3, "timeout": 5.5}
    assert dist.env_topology({}) == {}
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        dist.env_topology({dist.ENV_NUM_PROCESSES: "two"})
    with pytest.raises(ValueError, match="DIST_INIT_TIMEOUT"):
        dist.env_topology({dist.ENV_INIT_TIMEOUT: "soon"})


def test_validation_texts_match_reference():
    from repro.runtime import distributed as jdist
    for args in [("127.0.0.1:1", 2, 5), (None, 2, 0), ("nocolon", 2, 0),
                 ("127.0.0.1:1", 0, 0), ("h:1", 3, -1)]:
        with pytest.raises(ValueError) as want:
            jdist._validate(*args)
        with pytest.raises(ValueError) as got:
            dist._validate(*args)
        assert str(got.value) == str(want.value), args


def test_single_process_context_without_init():
    assert not dist.is_initialized()
    ctx = dist.context()
    assert ctx.num_processes == 1 and ctx.process_id == 0
    assert ctx.is_coordinator and not ctx.is_distributed
    assert dist.is_coordinator() and dist.process_count() == 1
    assert dist.topology_note() == ""       # no noise on a single process


def test_topology_query_before_initialize_raises(monkeypatch):
    """With the multihost env contract set, querying the topology before
    initialize() must raise instead of answering for one process."""
    monkeypatch.setenv(dist.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(dist.ENV_COORDINATOR, "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="initialize\\(\\) has not run"):
        dist.context()
    with pytest.raises(RuntimeError, match="initialize\\(\\) has not run"):
        dist.process_count()
    assert dist.topology_note() == ""       # decorative: never raises


def test_initialize_is_idempotent_and_owns_the_group():
    """One process with no contract opens a one-rank group; the same call
    again returns the same context, another topology raises, and a group
    opened by someone else is refused."""
    import torch.distributed as tdist
    ctx = dist.initialize(device="cpu")
    try:
        assert (ctx.num_processes, ctx.process_id, ctx.device) == \
            (1, 0, "cpu")
        assert tdist.get_world_size() == 1 and tdist.get_backend() == "gloo"
        assert dist.initialize(device="cpu") is ctx
        with pytest.raises(RuntimeError, match="already initialized"):
            dist.initialize(coordinator_address="127.0.0.1:1",
                            num_processes=1, process_id=0, device="cpu")
        assert dist.context() is ctx and dist.rank_device() == "cpu"
    finally:
        dist.shutdown()
    assert not dist.is_initialized() and not tdist.is_initialized()
    tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                             f"{_free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already open"):
            dist.initialize(device="cpu")
        # a group the caller opened is the context's topology
        assert dist.context().num_processes == 1
    finally:
        tdist.destroy_process_group()


def _host_threads(monkeypatch, world, dev, omp=None) -> int:
    """Torch's intra-op threads after ``_share_host_threads`` on a
    32-core, four-card machine, starting from 5."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(32)))
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(5)
        dist._share_host_threads(world, torch.device(dev))
        return torch.get_num_threads()
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("world", [4, 8])
def test_cuda_ranks_share_the_host_threads(monkeypatch, world):
    """One rank a card: four ranks on the four cards take a quarter of
    the cores each, and so do eight (at most four share the machine)."""
    assert _host_threads(monkeypatch, world, "cuda:1") == 8


def test_host_threads_left_alone(monkeypatch):
    """One process keeps torch's own count, the launcher's
    ``OMP_NUM_THREADS`` is kept, and CPU ranks (which compute on the
    host) are not touched."""
    assert _host_threads(monkeypatch, 1, "cuda:0") == 5
    assert _host_threads(monkeypatch, 4, "cuda:1", omp="3") == 5
    assert _host_threads(monkeypatch, 4, "cpu") == 5


def test_put_global_blocks_on_one_rank():
    """On one rank every spec's block is the whole value, copied into a
    buffer of its own (never a view of the host value)."""
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                             f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = tmesh.hybrid_mesh(model=1, data=1)
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        for spec in [(), ("model",), (("model", "data"),),
                     ("model", ("data",)), (None, "data")]:
            got = dist.put_global(x, mesh, spec, "cpu")
            assert torch.equal(got, torch.from_numpy(x)), spec
        t = torch.from_numpy(x)
        assert dist.put_global(t, mesh, (), "cpu").data_ptr() != \
            t.data_ptr()
        with pytest.raises(KeyError):
            dist.put_global(x, mesh, ("pod",), "cpu")
        rep = dist.replicate({"w": [t]}, mesh, "cpu")
        assert torch.equal(rep["w"][0], t)
    finally:
        tdist.destroy_process_group()


def test_resolve_mesh_shape_note_names_process_topology(monkeypatch):
    ctx = dist.DistContext("127.0.0.1:1", 2, 0, 1, 2, "cpu")
    monkeypatch.setattr(dist, "_CONTEXT", ctx)
    note = dist.topology_note()
    assert note == (" [multihost: 2 processes × 1 local device each = 2 "
                    "global devices; this process (0) holds only cpu]")
    with pytest.raises(ValueError, match="2 processes × 1 local device"):
        tmesh.resolve_mesh_shape(2, model=4, note=note)
    with pytest.raises(ValueError, match="2 processes × 1 local device"):
        tmesh.resolve_mesh_shape(2, data=3, note=note)
    # the note must not change the accounting itself
    assert tmesh.resolve_mesh_shape(2, model=2, note=note) == (1, 1, 2)


def test_ledger_roundtrip_and_merge():
    led = CommLedger()
    led.add("all_to_all", "model", "float32", payload=128.0, wire=112.0,
            calls=2.0)
    led.add("all_to_all", "model", "float32", payload=128.0, wire=112.0,
            calls=2.0, backward=True)
    led.add("all_gather", ("data",), "float32", payload=64.0, wire=64.0)
    clone = CommLedger.from_dict(json.loads(json.dumps(led.as_dict())))
    assert clone.as_dict() == led.as_dict()
    # the reference reads the port's ledgers, and the port the reference's
    assert jT.CommLedger.from_dict(led.as_dict()).as_dict() == led.as_dict()
    merged = CommLedger.from_dict(led.as_dict()).merge_from(clone)
    assert merged.wire_bytes("all_to_all", train=True) == 2 * led.wire_bytes(
        "all_to_all", train=True)
    assert merged.call_count("all_gather") == 2.0
    with pytest.raises(TelemetryError, match="malformed ledger key"):
        CommLedger.from_dict({"not-a-key": {}})


# ---------------------------------------------------------------------------
# The reference at four devices
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


def case_params(name) -> list:
    model, _, _, mesh = CASES[name]
    cfg, _ = _jax_setup(model, *MESH_DEGREES[mesh])
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(3), cfg))


def _param_bytes(params) -> float:
    return float(sum(np.asarray(a).nbytes for a in jax.tree.leaves(params)))


def _reference_child(params_path: str, out: str, names) -> None:
    """Child process with four forced host devices: the loss, grads and
    traced ledger of each case of ``names``, as JSON."""
    assert len(jax.devices()) == WORLD
    params = pickle.loads(Path(params_path).read_bytes())
    res = {}
    for name in names:
        model, mode, backend, mesh_name = CASES[name]
        n, r = MESH_DEGREES[mesh_name]
        mesh = (jmesh.tp_mesh(WORLD) if r == 1
                else jmesh.hybrid_mesh(model=n, data=r))
        cfg, bundle = _jax_setup(model, n, r)
        p = jax.tree.map(jnp.asarray, params[name])
        if model == "dp":
            vg = jDP.make_dp_value_and_grad(cfg, bundle, mesh,
                                            backend=backend)
        else:
            vg = jD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                           backend=backend)
        with jT.collect_comm() as ledger:
            loss, grads = vg(p, bundle.train_mask)
        res[name] = {"loss": float(loss),
                     "grads": [np.asarray(g).tolist()
                               for g in jax.tree.leaves(grads)],
                     "ledger": ledger.as_dict(),
                     "param_bytes": _param_bytes(params[name])}
    Path(out).write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The port: four processes from the env contract alone
# ---------------------------------------------------------------------------

def _placement(mesh) -> dict:
    """Rows and bytes of the placed bundles against the unplaced ones."""
    from repro_torch.core import decouple as tD
    from repro_torch.core import stream as tST
    from repro_torch.core import tp as ttp
    from repro_torch.gnn import dp_baseline as tDP
    from repro_torch.graph import synthetic as tsynth

    data = tsynth.sbm_power_law(**GRAPH)
    out = {}
    whole = tD.prepare_bundle(data, n_workers=mesh.size, n_chunks=CHUNKS,
                              n_replicas=mesh.data_size, device="cpu")
    placed = tD.prepare_bundle(data, mesh=mesh, n_chunks=CHUNKS,
                               device="cpu")
    idx, count = ttp.vertex_block(mesh)
    rows = slice(idx * whole.n_padded // count,
                 (idx + 1) * whole.n_padded // count)
    out["tp"] = {
        "n_padded": whole.n_padded, "block": list(placed.block),
        "rows": [getattr(placed, f).shape[0] for f in tD.NODE_ARRAYS],
        "bytes": [tD.node_array_bytes(placed), tD.node_array_bytes(whole)],
        "equal": all(torch.equal(getattr(placed, f),
                                 getattr(whole, f)[rows])
                     for f in tD.NODE_ARRAYS)}
    if mesh.data_axes:
        return out
    dwhole = tDP.prepare_dp_bundle(data, k=mesh.size, device="cpu")
    dplaced = tDP.prepare_dp_bundle(data, mesh=mesh, device="cpu")
    with tT.collect_comm() as led:
        dstream = tDP.place_dp_bundle_streamed(dwhole, mesh, n_slabs=3,
                                               device="cpu")
    i = mesh.index
    out["dp"] = {
        "block": list(dplaced.block),
        "shapes": [list(getattr(dplaced, f).shape)
                   for f in tD.NODE_ARRAYS],
        "whole_shapes": [list(getattr(dwhole, f).shape)
                         for f in tD.NODE_ARRAYS],
        "bytes": [tD.node_array_bytes(dplaced), tD.node_array_bytes(dwhole)],
        "equal": all(torch.equal(getattr(dplaced, f),
                                 getattr(dwhole, f)[i:i + 1])
                     for f in tD.NODE_ARRAYS),
        "streamed_equal": all(torch.equal(getattr(dstream, f),
                                          getattr(dplaced, f))
                              for f in tD.NODE_ARRAYS),
        "h2d": led.as_dict()}
    sb = tST.prepare_stream_bundle(data, mesh=mesh, n_chunks=CHUNKS,
                                   device="cpu")
    sw = tST.prepare_stream_bundle(data, mesh.size, n_chunks=CHUNKS,
                                   device="cpu")
    srows = slice(i * sw.n_padded // mesh.size,
                  (i + 1) * sw.n_padded // mesh.size)
    out["stream"] = {
        "rows": [t.shape[0] for t in (sb.labels, *sb.masks().values())],
        "equal": all(torch.equal(a, b[srows]) for a, b in
                     zip((sb.labels, *sb.masks().values()),
                         (sw.labels, *sw.masks().values())))}
    return out


def _port_case(name, mesh, params) -> dict:
    from repro_torch.core import decouple as tD
    from repro_torch.gnn import dp_baseline as tDP
    from repro_torch.gnn import models as tM
    from repro_torch.graph import synthetic as tsynth

    model, mode, backend, _ = CASES[name]
    data = tsynth.sbm_power_law(**GRAPH)
    if model == "dp":
        bundle = tDP.prepare_dp_bundle(data, mesh=mesh, device="cpu")
        cfg = tM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=2)
        vg = tDP.make_dp_value_and_grad(cfg, bundle, mesh, backend=backend)
    else:
        bundle = tD.prepare_bundle(data, mesh=mesh, n_chunks=CHUNKS,
                                   device="cpu")
        cfg = tD.padded_gnn_config(data, bundle, model=model,
                                   hidden_dim=HIDDEN, num_layers=2,
                                   gamma=GAMMA)
        vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       backend=backend)
    with tT.collect_comm() as ledger:
        loss, grads = vg(P.from_numpy_tree(params, "cpu"), bundle.train_mask)
    return {"loss": loss.item(),
            "grads": [g.numpy().tolist() for g in P.tree_leaves(grads)],
            "ledger": ledger.as_dict()}


def _port_rank(params_path: str, out_dir: str, names) -> None:
    """One of four processes; its topology comes from the env contract."""
    torch.set_num_threads(1)
    ctx = dist.initialize(device="cpu")
    try:
        params = pickle.loads(Path(params_path).read_bytes())
        meshes = {"model4": tmesh.TPMesh(),
                  "data2-model2": tmesh.hybrid_mesh(model=2, data=2)}
        res = {"ctx": [ctx.num_processes, ctx.process_id,
                       ctx.global_device_count, ctx.is_coordinator],
               "note": dist.topology_note()}
        for mesh_name, mesh in meshes.items():
            res[f"placement/{mesh_name}"] = _placement(mesh)
        for name in names:
            res[name] = _port_case(name, meshes[CASES[name][3]],
                                   params[name])
        (Path(out_dir) / f"rank{ctx.process_id}.json").write_text(
            json.dumps(res))
    finally:
        dist.shutdown()


def _child(code: str, **contract) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT / 'tests')!r}, "
         f"{str(ROOT / 'src')!r}]; {code}"],
        env=_env(**contract), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def four_ranks(request, tmp_path_factory):
    """One spawn for the test file: four port processes, each told its
    place by the env contract alone, and the reference child with four
    forced devices, side by side, on the file's cases (``NAMES``)."""
    names = list(request.module.NAMES)
    tmp = tmp_path_factory.mktemp("four")
    params_path = tmp / "params.pkl"
    params_path.write_bytes(pickle.dumps({n: case_params(n)
                                          for n in CASES}))
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD} "
               "--xla_cpu_multi_thread_eigen=false",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT / 'tests')!r}, "
         f"{str(ROOT / 'src')!r}]; import torch_multihost_cases as t; "
         f"t._reference_child({str(params_path)!r}, "
         f"{str(tmp / 'ref.json')!r}, {names!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _free_port()
    ranks = [_child(f"import torch_multihost_cases as t; "
                    f"t._port_rank({str(params_path)!r}, {str(tmp)!r}, "
                    f"{names!r})",
                    COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    NUM_PROCESSES=WORLD, PROCESS_ID=i, DIST_INIT_TIMEOUT=60)
             for i in range(WORLD)]
    errs = []
    for p in ranks + [ref]:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append(err[-3000:])
    assert [p.returncode for p in ranks + [ref]] == [0] * (WORLD + 1), errs
    return (json.loads((tmp / "ref.json").read_text()),
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)], params_path)


def test_env_contract_alone_places_every_rank(four_ranks):
    _, ranks, _ = four_ranks
    assert [got["ctx"] for got in ranks] == [
        [WORLD, r, WORLD, r == 0] for r in range(WORLD)]
    for r, got in enumerate(ranks):
        assert got["note"] == (
            f" [multihost: 4 processes × 1 local device each = 4 global "
            f"devices; this process ({r}) holds only cpu]")


@pytest.mark.parametrize("mesh_name", MESH_DEGREES)
def test_placed_tp_bundle_holds_one_block(four_ranks, mesh_name):
    _, ranks, _ = four_ranks
    for r, got in enumerate(ranks):
        tp = got[f"placement/{mesh_name}"]["tp"]
        n_padded = tp["n_padded"]
        assert tp["rows"] == [n_padded // WORLD] * 5, (r, tp)
        assert tp["bytes"][0] * WORLD == tp["bytes"][1], (r, tp)
        assert tp["block"][1] == WORLD and tp["equal"], (r, tp)
    # the four blocks are the four ranks' own, each once
    assert sorted(got[f"placement/{mesh_name}"]["tp"]["block"][0]
                  for got in ranks) == list(range(WORLD))


def test_placed_dp_bundle_holds_one_partition(four_ranks):
    _, ranks, _ = four_ranks
    for r, got in enumerate(ranks):
        dp = got["placement/model4"]["dp"]
        assert dp["block"] == [r, 0, 1]
        for shape, whole in zip(dp["shapes"], dp["whole_shapes"]):
            assert shape == [1] + whole[1:] and whole[0] == WORLD, dp
        assert dp["bytes"][0] * WORLD == dp["bytes"][1]
        assert dp["equal"] and dp["streamed_equal"], dp
        # three slabs of each of the five node arrays and the graph once
        h2d = dp["h2d"]
        assert h2d["h2d|dp_rows|float32"]["calls"] == 4 * 3
        assert h2d["h2d|dp_rows|int64"]["calls"] == 3
        assert h2d["h2d|dp_rows|float32"]["payload_bytes"] + \
            h2d["h2d|dp_rows|int64"]["payload_bytes"] == dp["bytes"][0]
        assert sum(v["calls"] for k, v in h2d.items()
                   if k.startswith("h2d|dp_graph|")) == 1


def test_placed_stream_bundle_holds_its_labels_and_masks(four_ranks):
    _, ranks, _ = four_ranks
    for got in ranks:
        st = got["placement/model4"]["stream"]
        assert len(set(st["rows"])) == 1 and st["equal"], st


def _hold_ledger(port: dict, ref: dict, backend: str, n: int, r: int,
                 param_bytes: float) -> None:
    """The port's one-step ledger against the reference's traced one,
    entry for entry but the stated departures."""
    if backend == "constraint":
        moved = ("all_to_all", "all_gather")
        pick = {k: v for k, v in ref.items() if k.split("|")[0] in moved}
        assert {k: v for k, v in port.items()
                if k.split("|")[0] in moved} == pick
        assert set(port) == set(pick), sorted(port)
        return
    data_axes = ("data",) if r > 1 else ()
    psums = {"psum|model|float32"} | {f"psum|{a}|float32" for a in data_axes}
    grad = f"grad_psum|{'+'.join(('model',) + data_axes)}|float32"
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


@pytest.mark.parametrize("name", CASES)
def test_four_ranks_match_reference(four_ranks, name):
    ref, ranks, _ = four_ranks
    want = ref[name]
    _, _, backend, mesh_name = CASES[name]
    n, r = MESH_DEGREES[mesh_name]
    for rank, got in enumerate(ranks):
        what = f"{name} rank {rank}"
        np.testing.assert_allclose(got[name]["loss"], want["loss"],
                                   atol=ATOL, err_msg=what)
        assert len(got[name]["grads"]) == len(want["grads"]), what
        for i, (a, b) in enumerate(zip(got[name]["grads"], want["grads"])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=ATOL, err_msg=f"{what} grad {i}")
        _hold_ledger(got[name]["ledger"], want["ledger"], backend, n, r,
                     want["param_bytes"])
    assert CommLedger.from_dict(ranks[0][name]["ledger"]).wire_bytes(
        "all_to_all", train=True) > 0


@pytest.mark.parametrize("name", CASES)
def test_merged_ledger_is_four_ranks(four_ranks, name):
    _, ranks, _ = four_ranks
    ledgers = [CommLedger.from_dict(got[name]["ledger"]) for got in ranks]
    assert all(led.as_dict() == ledgers[0].as_dict() for led in ledgers)
    merged = CommLedger()
    for led in ledgers:
        merged.merge_from(led)
    one = ledgers[0]
    for key, entry in merged.entries().items():
        base = one.entries()[key]
        assert entry.calls == WORLD * base.calls, key
        assert entry.wire_bytes == WORLD * base.wire_bytes, key
        assert entry.mirrored_calls == WORLD * base.mirrored_calls, key
    assert merged.wire_bytes(train=True) == WORLD * one.wire_bytes(
        train=True)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_prints_once_and_ranks_agree():
    port = _free_port()
    code = ("import json; from repro_torch.launch import multihost as m; "
            f"r = m.run(m.parse_args({LAUNCH!r})); "
            "print('LOSSES', json.dumps(r['losses']), file=sys.stderr)")
    procs = [_child(code, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                    NUM_PROCESSES=2, PROCESS_ID=i, DIST_INIT_TIMEOUT=60)
             for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    out0, out1 = outs[0][0], outs[1][0]
    assert out1 == ""                       # process 1 is silent
    lines = out0.splitlines()
    assert lines[0].startswith("# multihost: 2 processes")
    assert [ln.split(",")[0] for ln in lines[1:4]] == ["epoch"] * 3
    results = [ln for ln in lines if ln.startswith("RESULT ")]
    assert len(results) == 1
    result = json.loads(results[0][len("RESULT "):])
    assert {"processes", "local_devices", "global_devices", "mesh", "mode",
            "backend", "model", "epochs", "loss_first", "loss_last",
            "train_acc", "wall_s"} == set(result)
    assert result["processes"] == 2 and result["mesh"] == {"model": 2}
    losses = [json.loads(e.split("LOSSES ", 1)[1].splitlines()[0])
              for _, e in outs]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    assert losses[0][0] == result["loss_first"]
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]


def test_launch_script_runs_two_processes():
    res = subprocess.run(
        ["bash", str(ROOT / "scripts" / "launch_multihost_torch.sh"),
         "-n", "2", "-t", "120", "--", sys.executable, "-m",
         "repro_torch.launch.multihost", *LAUNCH],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=150)
    assert res.returncode == 0, res.stderr[-3000:]
    results = [ln for ln in res.stdout.splitlines()
               if ln.startswith("RESULT ")]
    assert len(results) == 1, res.stdout
    assert json.loads(results[0][len("RESULT "):])["processes"] == 2


# ---------------------------------------------------------------------------
# Failure modes: actionable, within the timeout, never a hang
# ---------------------------------------------------------------------------

def test_dead_coordinator_and_short_job_fail_within_timeout():
    launch = ("from repro_torch.launch import multihost as m; "
              f"m.main({LAUNCH!r})")
    dead = f"127.0.0.1:{_free_port()}"       # nobody listens there
    short = f"127.0.0.1:{_free_port()}"
    t0 = time.monotonic()
    unreachable = _child(launch, COORDINATOR_ADDRESS=dead, NUM_PROCESSES=2,
                         PROCESS_ID=1, DIST_INIT_TIMEOUT=2)
    # NUM_PROCESSES=3, but only two processes launched
    underpopulated = [_child(launch, COORDINATOR_ADDRESS=short,
                             NUM_PROCESSES=3, PROCESS_ID=i,
                             DIST_INIT_TIMEOUT=3) for i in range(2)]
    errs = []
    for p in [unreachable] + underpopulated:
        try:
            _, err = p.communicate(timeout=60)   # the harness's hard cap
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail("a failing job hung past the harness cap")
        errs.append(err)
    assert time.monotonic() - t0 < 45
    assert all(p.returncode != 0 for p in [unreachable] + underpopulated)
    assert f"coordinator at {dead!r} unreachable after 2s" in errs[0]
    assert "(worker 1 of 2)" in errs[0]
    for err in errs[1:]:
        assert "connecting to coordinator" in err        # the preflight
        assert "init_process_group failed" in err, err[-2000:]
        assert "exactly 3 processes were launched" in err
