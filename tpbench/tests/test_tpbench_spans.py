"""The span reduction (``tpbench/spans.py``) on made-up events, by hand:
attribution by correlation to the innermost span, ``.bwd`` by sequence
number, shares that sum to the busy time, the exchange's exposure, idle
clipped to the step spans and ``unattributed``; the new readers on a
made-up run and without their keys; and the trace reduction's busy time
and idle gaps blind to the spans' annotations."""
import pytest

from tiny import tiny_cell

from tpbench import spans, spec, trace

MAIN, BWD = (1, 10), (1, 20)


def _x(cat, name, ts, dur, th=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": th[0], "tid": th[1], "args": args}


def _kernel(corr, ts, dur, name="k"):
    return _x("kernel", name, ts, dur, th=(0, 7), correlation=corr)


def _launch(corr, ts, th=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, th=th,
              correlation=corr)


def _events():
    """One step on a main thread, its backward on another; times in µs.

    device:  nn [100,140] agg [140,200] split [200,230] step [220,260]
             alpha [262,270] nn.bwd [300,320] agg.bwd [330,360]
             ? [370,380] ? [600,610]
    """
    return [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("user_annotation", "tp.train_step", 10, 490),
        _x("user_annotation", "gnn.nn_phase", 20, 40),
        _x("user_annotation", "gat.alpha", 62, 6),
        _x("user_annotation", "agg.r0.c0", 70, 50),
        _x("user_annotation", "tp.split.c0", 130, 30),
        # not the program's: a collective backend's own annotation
        _x("user_annotation", "nccl:all_to_all", 131, 8),
        # the device side of an annotation is not device work
        _x("gpu_user_annotation", "agg.r0.c0", 100, 160, th=(0, 7)),
        # forward ops: seq 5 made by the mm inside the NN phase (the
        # detach before it peeked the same number), seq 6 by the agg
        _x("cpu_op", "aten::detach", 15, 1, **{"Sequence number": 5}),
        _x("cpu_op", "aten::mm", 25, 3, **{"Sequence number": 5}),
        _x("cpu_op", "aten::index_add_", 80, 3, **{"Sequence number": 6}),
        # the backward thread: the node events inside carry the number too
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           300, 40, th=BWD, **{"Sequence number": 5}),
        _x("cpu_op", "MmBackward0", 301, 38, th=BWD,
           **{"Sequence number": 5}),
        _x("cpu_op", "autograd::engine::evaluate_function: IABackward0",
           350, 30, th=BWD, **{"Sequence number": 6}),
        _x("cpu_op", "autograd::engine::evaluate_function: NoFwd",
           390, 5, th=BWD, **{"Sequence number": 99}),
        _launch(1, 30), _kernel(1, 100, 40, "gemm"),
        _launch(2, 90), _kernel(2, 140, 60, "index_add"),
        _launch(3, 135), _kernel(3, 200, 30, "nccl"),
        _launch(5, 125), _kernel(5, 220, 40, "cat"),
        _launch(10, 64), _kernel(10, 262, 8, "softmax"),
        _launch(6, 310, BWD), _kernel(6, 300, 20, "gemm"),
        _launch(7, 360, BWD), _kernel(7, 330, 30, "index_select"),
        _launch(8, 392, BWD), _kernel(8, 370, 10, "orphan"),
        _kernel(999, 600, 10, "unlaunched"),
        _launch(11, 700), _kernel(11, 1100, 100, "after the window"),
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 0},
    ]


def _owners(tl):
    return [(name, tl.forward.get(seq)) for name, seq in tl.evals]


def test_attribution_shares_and_backward():
    sp = spans.reduce(_events())
    got = {k: v * 1e6 for k, v in sp["device_s"].items()}
    want = {"gnn.nn_phase": 40, "agg.r0.c0": 60,
            "tp.split.c0": 20 + 5, "tp.train_step": 5 + 30,
            "gat.alpha": 8, "gnn.nn_phase.bwd": 20, "agg.r0.c0.bwd": 30,
            spans.UNATTRIBUTED: 10 + 10}
    assert got == pytest.approx(want)
    assert sp["busy_s"] * 1e6 == pytest.approx(sum(want.values()))
    assert sp["busy_s"] == pytest.approx(
        trace.reduce_events(_events(), 1.0)["busy_s"])
    assert sorted(n for n, _ in sp["unattributed_ops"]) == ["orphan",
                                                            "unlaunched"]
    assert sp["ops"]["agg.r0.c0"] == [["index_add", pytest.approx(60e-6)]]
    assert _owners(spans.Timeline(_events())) == [
        ("autograd::engine::evaluate_function: MmBackward0",
         "gnn.nn_phase"),
        ("autograd::engine::evaluate_function: IABackward0", "agg.r0.c0"),
        ("autograd::engine::evaluate_function: NoFwd", None)]


def test_exchange_steps_and_host():
    sp = spans.reduce(_events())
    # the split's [200,230], 10 of it beside the step's own work
    assert sp["exchange_s"] * 1e6 == pytest.approx(30)
    assert sp["exchange_exposed_s"] * 1e6 == pytest.approx(20)
    assert sp["steps"] == 1
    assert sp["step_host_s"] == [pytest.approx(490e-6)]
    # from the span's start (10) to the last launched op's end (380): busy
    # 160 + 8 + 20 + 30 + 10 of those 370; the unlaunched op is outside
    assert sp["step_idle_s"] == [pytest.approx((370 - 228) * 1e-6)]
    assert sp["calls"]["tp.split.c0"] == 1 and "nccl:all_to_all" not in \
        sp["calls"]
    assert sp["host_s"]["gnn.nn_phase"] == pytest.approx(40e-6)


def _shifted(events, k):
    """``events`` as step ``k`` of a run: times k ms later, correlations
    and sequence numbers of their own."""
    out = []
    for e in events:
        if e.get("name") == trace.WINDOW:
            continue
        e = dict(e, ts=e["ts"] + 1000 * k, args=dict(e.get("args", {})))
        for key in ("correlation", "Sequence number"):
            if key in e["args"]:
                e["args"][key] += 10000 * k
        out.append(e)
    return out


def test_steps_each_read_apart():
    ev = [_x("user_annotation", trace.WINDOW, 0, 3000)] + [
        e for k in range(3) for e in _shifted(_events(), k)]
    sp = spans.reduce(ev)
    assert sp["steps"] == 3
    assert sp["step_idle_s"] == [pytest.approx(142e-6)] * 3
    assert sp["step_exchange_exposed_s"] == [pytest.approx(20e-6)] * 3
    assert sp["device_s"]["agg.r0.c0.bwd"] == pytest.approx(90e-6)


def test_a_program_without_spans():
    ev = [e for e in _events() if e["cat"] != "user_annotation"
          or e["name"] == trace.WINDOW]
    sp = spans.reduce(ev)
    assert sp["steps"] == 0 and sp["step_idle_s"] == []
    assert set(sp["device_s"]) == {spans.UNATTRIBUTED}
    assert sp["device_s"][spans.UNATTRIBUTED] == pytest.approx(
        sp["busy_s"])
    assert spans.reduce([])["busy_s"] == 0


def test_annotations_stay_out_of_busy_and_idle_gaps():
    ev = _events()
    plain = [e for e in ev if "annotation" not in e["cat"]
             or e["name"] == trace.WINDOW]
    a, b = trace.reduce_events(ev, 1.0), trace.reduce_events(plain, 1.0)
    assert "user_annotation" not in trace.DEVICE_CATS
    assert "gpu_user_annotation" not in trace.DEVICE_CATS
    assert a["busy_s"] == pytest.approx(238e-6)
    assert (a["idle_gaps"], a["device_ops"]) == (b["idle_gaps"],
                                                 b["device_ops"])
    assert {n for n, _ in a["idle_gaps"]} <= {
        e["name"] for e in ev if e["cat"] == "cpu_op"} | {"no host op"}


def _run(world=1, with_spans=True):
    sp = spans.reduce(_events())
    return [{"step_ms": 100.0, "prepare_s": 2.0, "peak_bytes": 2 ** 31,
             "setup_s": 9.0, "steps": 50, "failed": 0,
             "shapes": {"model": "gcn", "n": 10, "e": 30, "dims": [6, 4, 4],
                        "world": world, "rounds": 2},
             "trace": dict({"wall_s": 0.5, "busy_s": 0.4, "nccl_s": 0.05,
                            "steps": 4, "wire_bytes": 3e6,
                            "device_ops": [["k", 0.3]], "idle_gaps": []},
                           **({"spans": sp} if with_spans else {})),
             "prepare_spans": [
                 ["prepare.chunk_graph", -1, 0, int(2e9) + i],
                 ["prepare.comm_plan", -1, int(2e9), int(3e9) + i],
                 ["prepare.agg_plans", -1, int(3e9), int(9e9)]]
             if with_spans else [],
             "correct": True, "forbidden": [],
             "checks": {"loss_gap": {"value": 1e-7, "limit": 1e-5}}}
            for i in range(world)]


NEW = {"nn_phase_ms", "attention_ms", "agg_ms", "exchange_exposed_ms",
       "step_dispatch_ms", "step_idle_ms", "prepare_chunk_s"}


def _read(cell, ranks) -> dict:
    """Each new reader over the run, those that find something to read."""
    run = {"cell": cell, "ranks": ranks}
    got = {name: spec.reader(name)(run) for name in NEW}
    return {k: v for k, v in got.items() if v is not None}


def test_new_readers_by_hand():
    cell = tiny_cell("gat-reddit.tp1")
    got = _read(cell, _run())
    assert NEW == set(got)
    assert got["nn_phase_ms"] == pytest.approx((40 + 20) * 1e-3)
    assert got["attention_ms"] == pytest.approx(8e-3)
    assert got["agg_ms"] == pytest.approx((60 + 30) * 1e-3)
    assert got["exchange_exposed_ms"] == pytest.approx(20e-3)
    assert got["step_dispatch_ms"] == pytest.approx(490e-3)
    assert got["step_idle_ms"] == pytest.approx(142e-3)
    assert got["prepare_chunk_s"] == pytest.approx(3.0)
    # the timeline's readings take the median step
    ranks = _run()
    ranks[0]["trace"]["spans"] = dict(
        ranks[0]["trace"]["spans"], steps=3,
        step_exchange_exposed_s=[0.3, 0.01, 0.02],
        step_idle_s=[0.004, 0.001, 0.002], step_host_s=[0.05, 0.03, 0.04])
    got = _read(cell, ranks)
    assert (got["exchange_exposed_ms"], got["step_idle_ms"],
            got["step_dispatch_ms"]) == pytest.approx((20, 2, 40))
    four = tiny_cell("gcn-reddit.tp4")
    got = _read(four, _run(world=4))
    # the slowest rank's stages
    assert got["prepare_chunk_s"] == pytest.approx(3.0 + 6e-9)


def test_new_readers_leave_out_what_they_cannot_read():
    cell = tiny_cell("gat-reddit.tp1")
    assert not _read(cell, _run(with_spans=False))
    ranks = _run()
    ranks[0]["trace"] = None
    assert set(_read(cell, ranks)) == {"prepare_chunk_s"}
    ranks = _run()
    ranks[0]["trace"]["spans"] = spans.reduce(
        [e for e in _events() if e["cat"] != "user_annotation"])
    assert set(_read(cell, ranks)) == {"prepare_chunk_s"}


def test_collect_without_the_program_spans(monkeypatch):
    from repro_torch.runtime import telemetry as T
    with spans.collect() as got:
        with T.span("prepare.x"):
            pass
    assert [r[:2] for r in got] == [["prepare.x", -1]]
    monkeypatch.delattr(T, "collect_spans")
    with spans.collect() as got:
        pass
    assert got == []
