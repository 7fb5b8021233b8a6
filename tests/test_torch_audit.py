"""The port's collective audit (``repro_torch.analysis.audit``): the
collectives one step issues, counted by ``torch.profiler`` below the
choke point, forward and backward, against the collective ledger.

* At one rank in process and at two spawned gloo ranks, the audit is
  clean on GCN decoupled-pipelined and naive, the DP baseline, GAT
  decoupled and the constraint backend's GCN decoupled step, and its
  census counts the backward's all-to-alls (the ledger's mirrored calls).
* Mutations: a direct ``dist.all_to_all_single`` inside the step is an
  ``unledgered_collective``; a hand-added ledger entry a
  ``phantom_ledger_entry``.
* The census's reading of a profile, on synthetic records: a backward on
  another thread (autograd's CUDA thread), a tensor-list op's dtype from
  its backend record, the card's records left out.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as tdist

from repro_torch.analysis import audit as A
from repro_torch.core import decouple as tD
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import distributed as dist
from repro_torch.runtime import mesh as tmesh
from repro_torch.runtime import telemetry as tT

ROOT = Path(__file__).resolve().parents[1]
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
CHUNKS, HIDDEN = 3, 8
# name: (model, mode, backend)
CASES = {"gcn-decoupled_pipelined": ("gcn", "decoupled_pipelined",
                                     "explicit"),
         "gcn-naive": ("gcn", "naive", "explicit"),
         "dp": ("dp", "dp", "explicit"),
         "gat-decoupled": ("gat", "decoupled", "explicit"),
         "constraint-gcn-decoupled": ("gcn", "decoupled", "constraint")}
TIMEOUT = datetime.timedelta(seconds=60)


def _step(name, mesh):
    """(value_and_grad, params, mask) of one case on ``mesh``."""
    model, mode, backend = CASES[name]
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
                                   hidden_dim=HIDDEN, num_layers=2)
        vg = tD.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode,
                                       backend=backend)
    params = tM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return vg, params, bundle.train_mask


def _audited(vg, params, mask, extra=None):
    """(census, ledger, findings) of one step."""
    with tT.collect_comm() as ledger:
        _, cen = A.census(vg, params, mask)
    if extra is not None:
        extra(ledger)
    return cen, ledger, A.audit(cen, ledger)


def _summary(name, mesh) -> dict:
    cen, ledger, findings = _audited(*_step(name, mesh))
    return {"census": cen.as_dict(), "ledger": ledger.as_dict(),
            "findings": [f.format() for f in findings]}


def _bypass(vg):
    """The step with one all-to-all that skips the choke point."""
    def step(params, mask):
        send = torch.ones(tdist.get_world_size(), 2)
        tdist.all_to_all_single(torch.empty_like(send), send)
        return vg(params, mask)
    return step


def _phantom(ledger):
    ledger.add("all_to_all", "model", "float32", payload=8.0, wire=0.0)


def _mutations(mesh) -> dict:
    vg, params, mask = _step("gcn-decoupled_pipelined", mesh)
    return {
        "bypass": [(f.kind, f.op, f.pass_, f.expected, f.actual) for f in
                   _audited(_bypass(vg), params, mask)[2]],
        "phantom": [(f.kind, f.op, f.pass_, f.expected, f.actual) for f in
                    _audited(vg, params, mask, extra=_phantom)[2]]}


def _hold(got: dict, name: str) -> None:
    assert got["findings"] == [], (name, got)
    a2a = tT.CommLedger.from_dict(got["ledger"]).entries()[
        ("all_to_all", "model", "float32")]
    census = got["census"]
    assert a2a.mirrored_calls > 0, name
    assert census["all_to_all|float32|backward"] == a2a.mirrored_calls
    assert census["all_to_all|float32|forward"] == a2a.calls


def _hold_mutations(got: dict) -> None:
    (bypass,) = got["bypass"]
    assert list(bypass[:3]) == ["unledgered_collective", "all_to_all",
                                "forward"]
    assert bypass[4] == bypass[3] + 1
    (phantom,) = got["phantom"]
    assert list(phantom[:3]) == ["phantom_ledger_entry", "all_to_all",
                                 "forward"]
    assert phantom[3] == phantom[4] + 1


# ---------------------------------------------------------------------------
# One rank, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    tdist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                             world_size=1, timeout=TIMEOUT)
    yield tmesh.TPMesh()
    tdist.destroy_process_group()


@pytest.mark.parametrize("name", CASES)
def test_one_rank_audit_is_clean(one_rank, name):
    _hold(_summary(name, one_rank), name)


def test_one_rank_mutations_are_found(one_rank):
    _hold_mutations(_mutations(one_rank))


def test_one_rank_streamed_epoch_audits_without_passes(one_rank):
    """The out-of-core epoch runs its split's transpose by hand, outside
    autograd, and records it as a backward call: its calls are held with
    both passes together."""
    from repro_torch.core import stream as tST
    data = tsynth.sbm_power_law(**GRAPH)
    sb = tST.prepare_stream_bundle(data, mesh=one_rank, n_chunks=CHUNKS,
                                   device="cpu")
    cfg = tST.stream_gnn_config(data, sb, hidden_dim=HIDDEN)
    vg = tST.make_stream_value_and_grad(cfg, sb, one_rank)
    params = tM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with tT.collect_comm() as ledger:
        _, cen = A.census(vg, params, sb.train_mask)
    assert A.audit(cen, ledger, by_pass=False) == []
    assert cen.get("all_to_all", "float32") == ledger.call_count(
        "all_to_all", train=True) == 4
    # by pass, the hand-run transpose reads as a forward call
    assert {(f.kind, f.pass_) for f in A.audit(cen, ledger)} == {
        ("unledgered_collective", "forward"),
        ("phantom_ledger_entry", "backward")}


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def _rank(out_dir: str) -> None:
    """One of two processes, placed by the env contract."""
    ctx = dist.initialize(device="cpu")
    try:
        mesh = tmesh.TPMesh()
        res = {name: _summary(name, mesh) for name in CASES}
        res["mutations"] = _mutations(mesh)
        (Path(out_dir) / f"rank{ctx.process_id}.json").write_text(
            json.dumps(res))
    finally:
        dist.shutdown()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in dist.ENV_CONTRACT}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path[:0] = [{str(ROOT / 'tests')!r}, "
             f"{str(ROOT / 'src')!r}]; import test_torch_audit as t; "
             f"t._rank({str(tmp)!r})"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=120)[1][-3000:])
        except subprocess.TimeoutExpired:
            p.kill()
            errs.append(p.communicate()[1][-3000:])
    assert [p.returncode for p in procs] == [0, 0], errs
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_audit_is_clean(two_ranks, name):
    for got in two_ranks:
        _hold(got[name], name)
    assert two_ranks[0][name]["census"] == two_ranks[1][name]["census"]


def test_two_ranks_census_sees_stated_departures(two_ranks):
    got = two_ranks[0]
    # GAT's score all-gathers: their backward is an all-reduce on gloo
    gat = got["gat-decoupled"]
    gathers = tT.CommLedger.from_dict(gat["ledger"]).entries()[
        ("all_gather", "model", "float32")]
    assert gat["census"]["all_gather|float32|forward"] == gathers.calls == 2
    assert gat["census"]["all_reduce|float32|backward"] == \
        gathers.mirrored_calls == 2
    # the constraint backend's reductions are DTensor's, unrecorded
    con = got["constraint-gcn-decoupled"]
    assert not any(k.startswith(("psum", "grad_psum"))
                   for k in con["ledger"])
    assert con["census"]["all_reduce|float32|forward"] >= 2


def test_two_ranks_mutations_are_found(two_ranks):
    for got in two_ranks:
        _hold_mutations(got["mutations"])


# ---------------------------------------------------------------------------
# The census's reading of a profile
# ---------------------------------------------------------------------------

def test_census_reads_backward_threads_and_list_dtypes():
    E = A._Event
    events = [
        # forward: an all-to-all on the caller's thread
        E("c10d::alltoall_base_", 1, 10, 20, ("float", "float")),
        E("nccl:all_to_all", 1, 15, 19, ("float",)),
        # backward on autograd's thread: a list all-gather whose dtype
        # only its backend record carries, then an all-to-all
        E("autograd::engine::evaluate_function: X", 2, 30, 80, ()),
        E("c10d::allgather_", 2, 31, 40, ("", "TensorList")),
        E("nccl:all_gather", 2, 33, 39, ("double",)),
        E("c10d::alltoall_base_", 2, 50, 60, ("float", "float")),
        E("nccl:all_to_all", 2, 52, 58, ("float",)),
        # a forward all-reduce after the backward, on the caller's thread
        E("c10d::allreduce_", 1, 90, 99, ("TensorList",)),
        E("nccl:all_reduce", 1, 91, 98, ("long int",)),
        E("aten::add", 1, 100, 101, ("float",)),
    ]
    cen = A.Census.from_events(events)
    assert cen.as_dict() == {
        "all_gather|float64|backward": 1,
        "all_reduce|int64|forward": 1,
        "all_to_all|float32|backward": 1,
        "all_to_all|float32|forward": 1}
    assert cen.threads == {"forward": [1], "backward": [2]}


def test_audit_contract_on_a_hand_made_ledger():
    led = tT.CommLedger()
    led.add("all_to_all", "model", "float32", payload=1.0, wire=0.0,
            calls=2.0)
    led.add("all_to_all", "model", "float32", payload=1.0, wire=0.0,
            calls=2.0, backward=True)
    led.add("all_gather", "model", "float32", payload=1.0, wire=0.0)
    led.add("all_gather", "model", "float32", payload=1.0, wire=0.0,
            backward=True)
    led.add("psum", "model", "float32", payload=12.0, wire=0.0)
    census = {("all_to_all", "float32", "forward"): 2,
              ("all_to_all", "float32", "backward"): 2,
              ("all_gather", "float32", "forward"): 1,
              ("reduce_scatter", "float32", "backward"): 1,
              ("all_reduce", "float32", "forward"): 3}
    assert A.audit(A.Census(dict(census)), led, gloo=False) == []
    # gloo runs the all-gather's backward as an all-reduce
    gloo = dict(census)
    del gloo[("reduce_scatter", "float32", "backward")]
    gloo[("all_reduce", "float32", "backward")] = 1
    assert A.audit(A.Census(gloo), led, gloo=True) == []
    # fewer all-reduces than the ledger's psums: a phantom; more: fine
    few = dict(census)
    few[("all_reduce", "float32", "forward")] = 0
    assert [f.kind for f in A.audit(A.Census(few), led, gloo=False)] == [
        "phantom_ledger_entry"]
    # a broadcast has no ledger op kind: always unledgered
    extra = dict(census)
    extra[("broadcast", "float32", "forward")] = 1
    (f,) = A.audit(A.Census(extra), led, gloo=False)
    assert (f.kind, f.op) == ("unledgered_collective", "broadcast")
    with pytest.raises(AssertionError, match="collective audit failed"):
        A.assert_clean(A.Census(extra), led, gloo=False, tag="t")
