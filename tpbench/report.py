"""The run's result line from its ranks' records."""
from __future__ import annotations

import sys

from . import spec

GIB = 2 ** 30


def end_to_end(cell: dict, ranks: list) -> dict:
    r0 = ranks[0]
    values = {"step_ms": r0["step_ms"],
              "peak_mem_gib": max(r["peak_bytes"] for r in ranks) / GIB,
              "setup_s": max(r["setup_s"] for r in ranks)}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell["end_to_end"]}


def per_layer(cell: dict, ranks: list) -> dict:
    """Each per-layer metric's reader over the run; a reader that finds
    nothing to read returns None and the metric is left out."""
    run = {"cell": cell, "ranks": ranks}
    out = {}
    for m in cell["per_layer"]:
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def worst_checks(ranks: list) -> dict:
    """Each number compared, the worst over the ranks, beside its limit."""
    out = {}
    for name in ranks[0]["checks"]:
        out[name] = max((r["checks"][name] for r in ranks),
                        key=lambda c: (c["value"] != c["value"],
                                       c["value"]))
    return out


def result(cell: dict, ranks: list, trace_on: bool, kind: str) -> dict:
    r0 = ranks[0]
    device = {"platform": "gpu", "kind": kind, "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    line = {"correct": all(r["correct"] for r in ranks),
            "attempted": r0["steps"], "failed": r0["failed"]}
    if trace_on:
        line["metrics"] = per_layer(cell, ranks)
        # each rank's busy time lies within its own window, so the
        # means over the ranks keep busy_s at most window_s
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) \
            / len(ranks)
        device["window_s"] = sum(r["trace"]["wall_s"] for r in ranks) \
            / len(ranks)
        line["device"] = device
        line["breakdown"] = {k: r0["trace"][k]
                             for k in ("device_ops", "idle_gaps")}
    else:
        line["metrics"] = end_to_end(cell, ranks)
        line["device"] = device
    line["checks"] = worst_checks(ranks)
    return line


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
