"""A cell of the benchmark cut to a size the CPU tests can hold: the real
cell's files, with a graph of a few hundred vertices and narrow widths."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from tpbench import spec  # noqa: E402

GRAPH = {"num_vertices": 300, "num_edges": 4000, "num_features": 21,
         "num_classes": 5,
         "split": {"train": 180, "val": 60, "test": 60}}


def tiny_cell(name: str, **limits) -> dict:
    cell = spec.cell(name)
    cell["config"]["graph"].update(GRAPH)
    cell["config"]["model"]["hidden_dim"] = 16
    cell["limits"].update(limits)
    return cell
