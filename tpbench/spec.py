"""``BENCHMARK.json`` and the files it names, found by name: a
configuration is ``configs/<name>.json`` (the entry's ``file``), a
traffic mix ``traffic/<name>.json``, a cell's correctness limits
``limits/<cell>.json`` and a per-layer metric's reader
``metrics/<name>.py``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _metrics(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` reads: its configuration, traffic
    mix and limits, and the metrics it reports."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = json.loads(
        (root / "tpbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["tp_degree"] != w["chips"]:
        raise ValueError(f"cell {name!r} asks for {w['chips']} chips but "
                         f"its traffic {w['traffic']!r} trains on "
                         f"{traffic['tp_degree']} ranks")
    return {"name": name, "chips": w["chips"],
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": traffic,
            "limits": json.loads(
                (root / "tpbench" / "limits" / f"{name}.json").read_text()),
            "end_to_end": _metrics(bench["end_to_end"], name),
            "per_layer": _metrics(bench["per_layer"], name)}


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = root / "tpbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"tpbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
