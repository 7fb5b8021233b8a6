"""The port's collective ledger against the JAX package's, on the CPU.

* Unit level: ``ring_wire_factor`` for every op and group size, the
  ``as_dict``/``from_dict`` round trip, both ways between the packages,
  the queries, and ``record`` outside a collection.
* One rank (gloo, in-process): the ledger of one port step equals the
  reference's ledger of its traced step (``collect_comm`` around
  ``jax.jit(jax.value_and_grad(loss_fn)).lower(...)`` on ``tp_mesh(1)``)
  for decoupled, decoupled_pipelined, naive and DP, L ∈ {1, 2, 3}, on
  every aggregation backend; and the schedules' all-to-all counts.
* Two ranks: two spawned gloo ranks against the reference's ledgers taken
  in one child process with two forced host devices.

Two departures are known and held here: the port sums (loss, correct,
count) in one stacked psum (1 call of 12 bytes; the reference makes three
scalar psums of the same bytes), and it records the replicated
parameters' gradient all-reduce under ``grad_psum``, which the reference
leaves out of its ledger.
"""
import datetime
import json
import multiprocessing as mp
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import decouple as jD
from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import telemetry as jT
from repro.runtime import tp_mesh
from repro_torch.core import decouple as tD
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh
from repro_torch.runtime import collectives as tC
from repro_torch.runtime import telemetry as tT

GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, BS, HIDDEN = 3, 32, 8
BACKENDS = ("segment", "blocksparse", "dense")
MODES = ("decoupled", "decoupled_pipelined", "naive", "dp")
OPS = ("psum", "all_gather", "all_to_all", "ppermute", "psum_scatter")
A2A, PSUM, GRAD = ("all_to_all|model|float32", "psum|model|float32",
                   "grad_psum|model|float32")
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def a2a_per_step(mode: str, layers: int) -> int:
    """The schedules' all-to-alls per step, forward + backward (§3.2)."""
    return {"decoupled": 4, "decoupled_pipelined": 4 * CHUNKS,
            "naive": 4 * layers - 2, "dp": 2 * layers - 1}[mode]


# ---------------------------------------------------------------------------
# Unit level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_ring_wire_factor_matches_reference(op, g):
    assert tT.ring_wire_factor(op, g) == jT.ring_wire_factor(op, g)


def _port_ledger():
    led = tT.CommLedger()
    led.add("all_to_all", "model", "float32", payload=64.0, wire=32.0,
            calls=2.0)
    led.add("all_to_all", "model", "float32", payload=64.0, wire=32.0,
            backward=True)
    led.add("psum", ("model", "data"), "float32", payload=12.0, wire=18.0)
    led.add("grad_psum", "model", "float32", payload=100.0, wire=150.0)
    return led


def test_as_dict_round_trip_and_queries():
    led = _port_ledger()
    d = led.as_dict()
    assert tT.CommLedger.from_dict(d).as_dict() == d
    assert json.loads(json.dumps(d)) == d
    assert d[A2A] == {"calls": 2.0, "payload_bytes": 128.0,
                      "wire_bytes": 64.0, "mirrored_calls": 1.0,
                      "mirrored_wire_bytes": 32.0}
    assert led.call_count("all_to_all") == 2.0
    assert led.call_count("all_to_all", train=True) == 3.0
    assert led.wire_bytes("all_to_all", "model", train=True) == 96.0
    # "model" names a component of the joined "model+data" label
    assert led.payload_bytes("psum", "model") == 12.0
    assert led.payload_bytes("psum", "data") == 12.0
    assert led.payload_bytes("psum", "pod") == 0.0
    assert led.wire_bytes() == 64.0 + 18.0 + 150.0
    merged = tT.CommLedger.from_dict(d).merge_from(led)
    assert merged.call_count("all_to_all", train=True) == 6.0
    assert len(led) == 3 and led and not tT.CommLedger()
    with pytest.raises(tT.TelemetryError, match="malformed"):
        tT.CommLedger.from_dict({"all_to_all|model": {}})


def test_ledger_dicts_cross_between_packages():
    ref = jT.CommLedger()
    ref.add("all_to_all", "model", "float32", payload=64.0, wire=32.0,
            calls=3.0, mirror=True)
    ref.add("psum", ("model", "data"), "float32", payload=4.0, wire=6.0)
    d = ref.as_dict()
    assert tT.CommLedger.from_dict(d).as_dict() == d
    mine = _port_ledger().as_dict()
    assert jT.CommLedger.from_dict(mine).as_dict() == mine


def test_record_only_while_collecting():
    x = torch.zeros(3, 5, dtype=torch.float32)
    tT.record("all_to_all", "model", x, group_size=4)   # no ledger: no-op
    tT.record("no_such_op", "model", x, group_size=4)   # not even checked
    with tT.collect_comm() as outer:
        with tT.collect_comm() as inner:
            tT.record("all_to_all", "model", x, group_size=4)
        tT.record("grad_psum", "model", x.double(), group_size=4)
        with pytest.raises(tT.TelemetryError, match="unknown"):
            tT.record("no_such_op", "model", x, group_size=4)
    assert inner.as_dict() == {A2A: {
        "calls": 1.0, "payload_bytes": 60.0, "wire_bytes": 45.0,
        "mirrored_calls": 0.0, "mirrored_wire_bytes": 0.0}}
    assert outer.entries()[("grad_psum", "model", "float64")].wire_bytes \
        == 1.5 * 120.0
    assert len(outer) == 2 and tT.active_ledgers() == ()


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def _param_bytes(params) -> float:
    return float(sum(np.asarray(a).nbytes
                     for a in jax.tree.leaves(params)))


def assert_parity(port: dict, ref: dict, n: int, param_bytes: float):
    """The port's one-step ledger against the reference's traced one: every
    key and counter equal but the two stated departures."""
    assert set(port) - {GRAD} == set(ref), (sorted(port), sorted(ref))
    for key, want in ref.items():
        got = dict(port[key])
        if key == PSUM:
            # one stacked psum of (loss, correct, count) against three
            assert (got.pop("calls"), want["calls"]) == (1.0, 3.0)
            want = {k: v for k, v in want.items() if k != "calls"}
        assert got == want, key
    assert port[GRAD] == {
        "calls": 1.0, "payload_bytes": param_bytes,
        "wire_bytes": tT.ring_wire_factor("psum", n) * param_bytes,
        "mirrored_calls": 0.0, "mirrored_wire_bytes": 0.0}


def _jax_setup(mode, layers, n):
    """(loss_fn, params, mask) of the reference for one mode on ``n``
    devices (the segment backend: its ledger is backend-invariant, as the
    reference's own tests hold)."""
    data = jsynth.sbm_power_law(**GRAPH)
    if mode == "dp":
        bundle = jDP.prepare_dp_bundle(data, k=n)
        cfg = jM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                           num_classes=data.num_classes, num_layers=layers,
                           decoupled=False)
        loss_fn = jDP.make_dp_loss_fn(cfg, bundle, tp_mesh(n))
    else:
        bundle = jD.prepare_bundle(data, n_workers=n, n_chunks=CHUNKS)
        cfg = jD.padded_gnn_config(data, bundle, hidden_dim=HIDDEN,
                                   num_layers=layers, gamma=0.8)
        loss_fn = jD.make_tp_loss_fn(cfg, bundle, tp_mesh(n), mode=mode)
    params = jM.init_params(jax.random.PRNGKey(layers), cfg)
    return loss_fn, params, bundle.train_mask


def reference_ledger(mode, layers, n) -> tuple[dict, float]:
    loss_fn, params, mask = _jax_setup(mode, layers, n)
    with jT.collect_comm() as ledger:
        jax.jit(jax.value_and_grad(loss_fn)).lower(params, mask)
    assert len(ledger), "empty reference ledger"
    return ledger.as_dict(), _param_bytes(params)


def port_ledgers(mode, layers, mesh: TPMesh) -> dict:
    """{backend: the ledger of one value-and-grad step} at ``mesh``."""
    data = tsynth.sbm_power_law(**GRAPH)
    out = {}
    for agg in BACKENDS:
        if mode == "dp":
            bundle = tDP.prepare_dp_bundle(data, k=mesh.size, agg=agg,
                                           agg_block_size=BS, device="cpu")
            cfg = tM.GNNConfig(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
                              num_classes=data.num_classes,
                              num_layers=layers)
            vg = tDP.make_dp_value_and_grad(cfg, bundle, mesh)
        else:
            bundle = tD.prepare_bundle(data, n_workers=mesh.size,
                                       n_chunks=CHUNKS, agg=agg,
                                       agg_block_size=BS, device="cpu")
            cfg = tD.padded_gnn_config(data, bundle, hidden_dim=HIDDEN,
                                       num_layers=layers, gamma=0.8)
            vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode)
        params = tM.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        with tT.collect_comm() as ledger:
            loss, _ = vg(params, bundle.train_mask)
        assert torch.isfinite(loss)
        out[agg] = ledger.as_dict()
    return out


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield TPMesh()
    dist.destroy_process_group()


def test_backward_on_another_thread_records_into_forward_ledgers(one_rank):
    """Autograd runs the backward of CUDA tensors on a thread of its own,
    outside the caller's context: the mirrored all-to-all must still
    reach the ledger its forward was recorded in."""
    x = torch.randn(4, 6, requires_grad=True)
    with tT.collect_comm() as ledger:
        y = tC.all_to_all(x, split_axis=1, concat_axis=0)
        worker = threading.Thread(target=lambda: y.sum().backward())
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive() and x.grad is not None
    assert ledger.as_dict() == {A2A: {
        "calls": 1.0, "payload_bytes": 96.0, "wire_bytes": 0.0,
        "mirrored_calls": 1.0, "mirrored_wire_bytes": 0.0}}


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_one_rank_ledger_matches_reference(one_rank, mode, layers):
    want, param_bytes = reference_ledger(mode, layers, 1)
    got = port_ledgers(mode, layers, one_rank)
    # backend invariance: the aggregation is local compute
    assert got["segment"] == got["blocksparse"] == got["dense"]
    assert_parity(got["segment"], want, 1, param_bytes)
    led = tT.CommLedger.from_dict(got["segment"])
    assert led.call_count("all_to_all", "model", train=True) == \
        a2a_per_step(mode, layers)
    assert led.wire_bytes() == 0.0          # no ring traffic at N=1


def _reference_child(out: str, n: int) -> None:
    """Child process with ``n`` forced host devices: the reference's
    ledgers at L=2 for every mode, written to ``out`` as JSON."""
    assert len(jax.devices()) == n
    Path(out).write_text(json.dumps(
        {mode: reference_ledger(mode, 2, n) for mode in MODES}))


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        ledgers = {mode: port_ledgers(mode, 2, TPMesh()) for mode in MODES}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(ledgers))
    finally:
        dist.destroy_process_group()


def test_two_ranks_ledger_matches_reference(tmp_path):
    world = 2
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false",
           "JAX_PLATFORMS": "cpu"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_comm_ledger as t; "
            "t._reference_child({!r}, {})").format(
                str(ROOT / "tests"), str(ROOT / "src"),
                str(tmp_path / "ref.json"), world)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp_path / "rendezvous", tmp_path))
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

    ref = json.loads((tmp_path / "ref.json").read_text())
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(world)]
    assert ranks[0] == ranks[1]             # per-device counters agree
    for mode in MODES:
        want, param_bytes = ref[mode]
        got = ranks[0][mode]
        assert got["segment"] == got["blocksparse"] == got["dense"], mode
        assert_parity(got["segment"], want, world, param_bytes)
        led = tT.CommLedger.from_dict(got["segment"])
        assert led.call_count("all_to_all", "model", train=True) == \
            a2a_per_step(mode, 2)
        assert led.wire_bytes("all_to_all", train=True) > 0.0
