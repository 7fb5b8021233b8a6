"""The program's spans in a real trace: one decoupled-pipelined training
step of a tiny GCN and GAT under the CPU profiler, on one gloo rank in
process.  The step's program spans are exactly the engine's names, and
every backward node autograd runs maps, through its sequence number, to a
forward op under a named span (``tpbench/spans.py``)."""
import datetime
import json
from collections import Counter

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import tiny  # noqa: F401  (the checkout's src/ on the path)

from repro_torch import optim
from repro_torch.core import decouple as D
from repro_torch.gnn import models as M
from repro_torch.graph import synthetic as S
from repro_torch.runtime import TPMesh

from tpbench import spans

CHUNKS = 4
NAMES = Counter(
    ["tp.train_step", "gnn.nn_phase", "gnn.edge_weights", "tp.loss",
     "tp.grad_sum", "optim.update"]
    + [f"{k}.c{c}" for c in range(CHUNKS)
       for k in ("tp.split", "agg.r0", "agg.r1", "tp.gather")])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    data = S.sbm_power_law(n=130, num_classes=5, feat_dim=10, avg_degree=6,
                           seed=2)
    yield data, D.prepare_bundle(data, n_workers=1, n_chunks=CHUNKS,
                                 device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_one_step_traced(one_rank, model, tmp_path):
    data, bundle = one_rank
    cfg = D.padded_gnn_config(data, bundle, model=model, hidden_dim=8,
                              num_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = optim.adamw(1e-2)
    step, _ = D.make_tp_train_fns(cfg, bundle, TPMesh(), opt)
    state = opt.init(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]

    tl = spans.Timeline(events)
    want = NAMES + Counter(["gat.alpha"] * (model == "gat"))
    assert Counter(name for _, _, name in tl.spans) == want
    owners = [(n, tl.forward.get(seq)) for n, seq in tl.evals]
    assert len(owners) > 20
    assert all(owner in want for _, owner in owners), \
        [o for o in owners if o[1] not in want]
    # the aggregation's, the exchange's and the NN phase's backward nodes
    # are found under their own spans
    assert {f"agg.r{r}.c{c}" for r in (0, 1) for c in range(CHUNKS)} \
        | {f"tp.split.c{c}" for c in range(CHUNKS)} \
        | {"gnn.nn_phase", "tp.loss"} <= {o for _, o in owners}
    if model == "gat":
        assert "gat.alpha" in {o for _, o in owners}
    sp = spans.reduce(events)
    assert sp["steps"] == 1 and sp["calls"] == dict(want)
