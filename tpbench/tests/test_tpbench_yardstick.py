"""The FLOP and byte formulas against hand counts, the per-layer readers
on a made-up run, and the trace reduction on made-up events."""
import pytest

from tiny import tiny_cell

from tpbench import report, trace, yardstick

N, E, DIMS = 10, 30, [6, 4, 3]


def test_flops_by_hand():
    # forward 2·10·6·4 + 2·10·4·3 = 720, weight grads 720, the second
    # layer's input grad 240
    assert yardstick.gemm_flops(N, DIMS) == 1680
    # four rounds of 2·30·3
    assert yardstick.step_flops("gcn", N, E, DIMS, 2) == 1680 + 720
    # and the α-gradient product of each round
    assert yardstick.step_flops("gat", N, E, DIMS, 2) == 1680 + 720 + 360


def test_bytes_by_hand():
    # 30 edges × 8 + 11 offsets × 8 + rows in and out 2·10·3·4
    assert yardstick.round_bytes(N, E, 3) == 568
    # GAT's backward also reads the rows and writes an α-gradient an edge
    assert yardstick.round_bytes(N, E, 3, gat_backward=True) == 568 + 240
    bw = yardstick.PEAK_BYTES_PER_S
    assert yardstick.agg_least_s("gcn", N, E, 3, 2) == pytest.approx(
        4 * 568 / bw)
    assert yardstick.agg_least_s("gat", N, E, 3, 2) == pytest.approx(
        2 * 568 / bw + 2 * 808 / bw)


def _run(world=1, traced=True):
    rank = {"step_ms": 100.0, "prepare_s": 2.0, "peak_bytes": 2 ** 31,
            "setup_s": 9.0, "steps": 50, "failed": 0,
            "shapes": {"model": "gcn", "n": N, "e": E, "dims": [6, 4, 4],
                       "world": world, "rounds": 2},
            "trace": {"wall_s": 0.5, "busy_s": 0.4, "nccl_s": 0.05,
                      "steps": 4, "wire_bytes": 3e6,
                      "device_ops": [["k", 0.3]],
                      "idle_gaps": [["aten::index_add_", 0.1]]}
            if traced else None,
            "correct": True, "forbidden": [],
            "checks": {"loss_gap": {"value": 1e-7, "limit": 1e-5}}}
    return [dict(rank, prepare_s=2.0 + i) for i in range(world)]


def test_readers_on_a_made_up_run():
    cell = tiny_cell("gcn-reddit.tp4")
    ranks = _run(world=4)
    got = {k: v["value"] for k, v in report.per_layer(cell, ranks).items()}
    assert got["device_idle_share"] == pytest.approx(20.0)
    assert got["comm_share"] == pytest.approx(10.0)
    assert got["wire_mb_per_step"] == pytest.approx(3.0)
    assert got["prepare_s"] == 5.0
    dims = [21, 16, 5]          # the configuration's own widths
    assert got["step_mfu"] == pytest.approx(
        100 * yardstick.step_flops("gcn", N, E, dims, 2)
        / (0.1 * 4 * yardstick.PEAK_FLOPS))
    assert got["agg_roofline"] == pytest.approx(
        100 * yardstick.agg_least_s("gcn", N, E, 1, 2) / 0.1)


def test_readers_leave_out_what_they_cannot_read():
    cell = tiny_cell("gcn-reddit.tp4")
    assert set(report.per_layer(cell, _run(world=4, traced=False))) == \
        {"step_mfu", "prepare_s"}
    one = tiny_cell("gcn-reddit.tp1")
    assert "comm_share" not in report.per_layer(one, _run())


def test_result_line_shape():
    cell = tiny_cell("gcn-reddit.tp1")
    line = report.result(cell, _run(), True, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == 0.4
    line = report.result(cell, _run(), False, "NVIDIA H100 80GB HBM3")
    assert set(line["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert line["metrics"]["peak_mem_gib"]["value"] == 2.0


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "ncclAllToAll", "ts": 5,
           "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 40, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 20,
           "dur": 10},
          {"ph": "i", "cat": "kernel", "name": "x", "ts": 0}]
    got = trace.reduce_events(ev, 1e-4)
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["nccl_s"] == pytest.approx(10e-6)
    assert got["idle_gaps"] == [["aten::inner", pytest.approx(25e-6)]]
    assert got["device_ops"][0][0] in ("k1", "ncclAllToAll")


def test_trace_window_clips_device_operations():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "ncclSpin", "ts": 0,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 45, "dur": 5}]
    got = trace.reduce_events(ev, 1.0)
    assert got["wall_s"] == pytest.approx(30e-6)
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["nccl_s"] == pytest.approx(10e-6)
    assert sorted(k for k, _ in got["device_ops"]) == ["k", "ncclSpin"]


def test_traced_line_keeps_busy_within_window_over_ranks():
    cell = tiny_cell("gcn-reddit.tp4")
    ranks = _run(world=4)
    for r, (wall, busy) in zip(ranks, [(0.5, 0.49), (0.7, 0.69),
                                       (0.7, 0.69), (0.7, 0.69)]):
        r["trace"] = dict(r["trace"], wall_s=wall, busy_s=busy)
    dev = report.result(cell, ranks, True, "NVIDIA H100 80GB HBM3")["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["window_s"] == pytest.approx(0.65)
