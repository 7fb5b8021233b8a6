"""``BENCHMARK.json`` against the contract's rules, and every file it
names found by name."""
import json
import re
import statistics

import pytest

from tiny import ROOT

from tpbench import compare, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("tpbench/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf["graph"]
            assert not key.endswith(("_dim", "_rank"))


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = spec.cell(w["name"])
        limits = set(cell["limits"])
        assert limits <= set(compare.NAMES)
        for kind in ("loss", "grad", "update"):
            assert limits & {f"{kind}_gap", f"{kind}1_gap",
                             f"{kind}_median_gap"}, (w["name"], kind)
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        bound = 0.25 if m["name"] == "setup_s" else m["bound"]
        assert 0.01 <= m["bound"] <= bound
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert (ROOT / "tpbench" / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]))
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_file_found_by_name():
    for w in BENCH["workloads"]:
        assert (ROOT / "tpbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (ROOT / "tpbench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_sit_below_the_reading_of_a_state_left_unchanged(cell):
    # a state left unchanged reads 1 on the changes; every limit is
    # well under it, and above 0
    for limit in spec.cell(cell)["limits"].values():
        assert 0 < limit < 1 / 3


def test_median_floor_of_the_comparison():
    ref = {"losses": [2.0], "grad1": {"a": _t(1.0), "b": _t(1e-9),
                                      "c": _t(2.0)},
           "delta": {"a": _t(1.0), "b": _t(0.5), "c": _t(2.0)}}
    prog = {"losses": [2.0], "grad1": {"a": _t(1.0), "b": _t(0.0),
                                       "c": _t(2.0)},
            "delta": {"a": _t(1.0), "b": _t(5.0), "c": _t(2.0)}}
    got = compare.readings(prog, ref)
    # b's gradient is nought to rounding: its gap is measured against
    # the median leaf, and its change is not compared
    assert got["grad_gap"] == pytest.approx(1e-9 / statistics.median(
        [1.0, 1e-9, 2.0]))
    assert got["update_gap"] == 0.0 and got["update_median_gap"] == 0.0
    assert got["grad_median_gap"] == 0.0
    assert got["loss_gap"] == got["loss1_gap"] == 0.0
    with pytest.raises(ValueError):
        compare.verdict(got, {"nonesuch": 1.0})
    ok, checks = compare.verdict(got, {"grad_gap": 1e-12})
    assert not ok and list(checks) == ["grad_gap"]


def _t(x):
    import torch
    return torch.tensor([x])
