"""The engine's spans (``repro_torch.runtime.telemetry.span``): the
``SpanLog``'s nesting and parents, names formatted only when a sink is on,
a training step that enters no ``record_function`` with both sinks off and
trains bitwise as with them on, and ``prepare_bundle``'s stage names.
One gloo rank in process."""
import datetime

import pytest
import torch
import torch.autograd.profiler as AP
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim
from repro_torch.core import decouple as D
from repro_torch.gnn import models as M
from repro_torch.graph import synthetic as S
from repro_torch.params import tree_leaves
from repro_torch.runtime import TPMesh
from repro_torch.runtime import telemetry as T

GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
STAGES = ["prepare.chunk_graph", "prepare.comm_plan", "prepare.agg_plans",
          "prepare.graph_upload", "prepare.node_arrays"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    data = S.sbm_power_law(**GRAPH)
    yield data, D.prepare_bundle(data, n_workers=1, n_chunks=4,
                                 device="cpu")
    dist.destroy_process_group()


def _step(data, bundle, model):
    cfg = D.padded_gnn_config(data, bundle, model=model, hidden_dim=8,
                              num_layers=2, gamma=0.9)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, _ = D.make_tp_train_fns(cfg, bundle, TPMesh(), opt)
    return step, params, opt.init(params)


def test_span_log_nests_and_formats_only_when_on():
    assert not AP._is_profiler_enabled
    # off: the shared no-op, and the name is never formatted
    assert T.span("a") is T.span("b.c%d", 1)
    with T.span("x%d", "not a number"):
        pass
    with T.collect_spans() as log:
        with T.span("a"):
            with T.span("b.c%d", 1):
                pass
            with T.span("d"):
                pass
        with T.span("e"):
            pass
        with pytest.raises(TypeError):
            T.span("x%d", "not a number")
        with pytest.raises(ValueError):
            with T.span("boom"):
                raise ValueError
    with T.span("after"):
        pass
    assert [r[:2] for r in log.records] == [
        ["a", -1], ["b.c1", 0], ["d", 0], ["e", -1], ["boom", -1]]
    (_, _, a0, a1), (_, _, b0, b1), (_, _, d0, d1), (_, _, e0, e1), \
        (_, _, f0, f1) = log.records
    assert a0 <= b0 <= b1 <= d0 <= d1 <= a1 <= e0 <= e1 <= f0 <= f1
    with T.collect_spans() as outer:
        with T.collect_spans() as inner:
            with T.span("q"):
                pass
    assert [r[0] for r in inner.records] == ["q"] and not outer.records


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_off_path_enters_no_record_function(one_rank, model, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered record_function with no "
                             "sink on")

    with monkeypatch.context() as m:
        m.setattr(AP, "record_function", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        step, params, state = _step(*one_rank, model)
        off, off_state, off_loss = step(params, state)
    with T.collect_spans() as log, profile(
            activities=[ProfilerActivity.CPU]):
        step, params, state = _step(*one_rank, model)
        on, on_state, on_loss = step(params, state)
    assert log.records[0][:2] == ["tp.train_step", -1]
    assert torch.equal(off_loss, on_loss)
    assert off_state.count == on_state.count
    for a, b in zip(tree_leaves(off) + tree_leaves(off_state.mu)
                    + tree_leaves(off_state.nu),
                    tree_leaves(on) + tree_leaves(on_state.mu)
                    + tree_leaves(on_state.nu)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("placed", [False, True])
def test_prepare_stage_names(one_rank, placed):
    data, _ = one_rank
    kw = dict(mesh=TPMesh()) if placed else dict(n_workers=1)
    with T.collect_spans() as log:
        D.prepare_bundle(data, n_chunks=4, device="cpu", **kw)
    assert [r[:2] for r in log.records] == [
        [n, -1] for n in STAGES + ["prepare.place"] * placed]
    assert all(a <= b for _, _, a, b in log.records)
