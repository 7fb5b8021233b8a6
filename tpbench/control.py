#!/usr/bin/env python3
"""The readings the correctness limits are set from, at a cell's own
size, on many seeds:

* ``program``: the program's first steps against the reference (the
  lower readings);
* ``control``: the reference itself in the program's place, its GEMMs in
  TF32 (the precision below the configuration's float32 with TF32 off);
* ``half_batch``: the reference in the program's place with half of the
  training vertices left out;
* each fault of ``--faults`` planted in the program (``exchange``: the
  all-to-alls left out, on more than one rank).

A state left unchanged reads 1 on ``update_gap`` and needs no run.

    python3 tpbench/control.py --workload gcn-reddit.tp1 --seeds 1,2,3 \\
        [--faults exchange] [--out FILE]

prints one JSON line a seed and a summary (the largest and smallest
reading of each number by source), and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings_rank(cell: dict, seeds: list, device, program_faults,
                  again: bool = False) -> list:
    """This rank's readings, one dict a seed; with ``again``, also the
    program run a second time from the same inputs, and each source's
    gaps step by step and leaf by leaf (``detail``)."""
    import torch
    from repro_torch.runtime import distributed as RD
    from tpbench import compare, engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(RD.initialize(device=device).device)
    rows = []
    try:
        for seed in seeds:
            prog = engine.Program(cell, seed, device)
            got = {"program": prog.first}
            params0 = prog.free()
            for fault in program_faults:
                p = engine.Program(cell, seed, device, fault)
                got[fault] = p.first
                p.free()
            if again:
                p = engine.Program(cell, seed, device)
                got["again"] = p.first
                p.free()
            ref = engine.reference(cell, seed, device, params0)
            got["control"] = engine.reference(cell, seed, device, params0,
                                              tf32=True)
            got["half_batch"] = engine.reference(cell, seed, device, params0,
                                                 half_batch=True)
            rows.append({"seed": seed, "losses": ref["losses"],
                         **{k: compare.readings(v, ref)
                            for k, v in got.items()}})
            if again:
                rows[-1]["detail"] = {k: compare.detail(v, ref)
                                      for k, v in got.items()}
            print(json.dumps(rows[-1]), flush=True)
    finally:
        RD.shutdown()
    return rows


def merge(ranks: list, program_faults) -> list:
    """Rank 0's rows, with the program's readings, and each fault's
    planted in it, taken by the worst rank."""
    rows = []
    for i, row in enumerate(ranks[0]):
        for src in ["program"] + list(program_faults) + (
                ["again"] if "again" in row else []):
            row[src] = {k: max(r[i][src][k] for r in ranks)
                        for k in row[src]}
        rows.append(row)
    return rows


def summary(rows: list) -> dict:
    out = {}
    for src in rows[0]:
        if src in ("seed", "losses", "detail"):
            continue
        out[src] = {k: {"max": max(r[src][k] for r in rows),
                        "min": min(r[src][k] for r in rows)}
                    for k in rows[0][src]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--again", action="store_true",
                    help="run the program twice a seed and keep the "
                         "gaps step by step and leaf by leaf")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from tpbench import spec
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    if cell["chips"] == 1:
        ranks = [readings_rank(cell, seeds, "cuda", faults, args.again)]
    else:
        from tpbench import launch
        ranks = launch.launch(cell, {"task": "control", "seeds": seeds,
                                     "faults": faults, "again": args.again},
                              timeout=3000.0)
    rows = merge(ranks, faults)
    out = {"cell": cell["name"], "rows": rows, "summary": summary(rows)}
    print(json.dumps(out["summary"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
