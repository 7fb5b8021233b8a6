#!/usr/bin/env python3
"""Run a cell in sets of runs, one process a run, and report each
end-to-end metric's spread: the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) as a share of the
median, in each set, and the medians of the sets.  The bounds in
``BENCHMARK.json`` are set from these (about five times the widest
spread over the cells, never under 1 %).

    python3 tpbench/spread.py --workload gcn-reddit.tp1 --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 10 [--trace-seeds 7,8,9] [--out FILE]

Every set runs the same seeds; ``--trace-seeds`` are run once each with
``--trace 1`` after the sets.  Prints one line a run and a summary.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, cwd=str(HERE.parent))
    lines = out.stdout.strip().splitlines()
    rec = {"seed": seed, "trace": trace, "rc": out.returncode,
           "stderr_tail": out.stderr[-1500:]}
    if out.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
        rec["info"] = lines[-2] if len(lines) > 1 else ""
    return rec


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summary(sets: list) -> dict:
    out = {}
    names = sets[0][0]["result"]["metrics"]
    for name in names:
        per = [[r["result"]["metrics"][name]["value"] for r in s]
               for s in sets]
        out[name] = {"medians": [statistics.median(v) for v in per],
                     "spreads": [spread(v) for v in per]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets, traced = [], []
    for _ in range(args.sets):
        sets.append([])
        for seed in seeds:
            sets[-1].append(run_once(args.workload, seed, args.seconds, 0))
            print(json.dumps(sets[-1][-1]), flush=True)
    for seed in [int(s) for s in args.trace_seeds.split(",") if s]:
        traced.append(run_once(args.workload, seed, args.seconds, 1))
        print(json.dumps(traced[-1]), flush=True)
    ran = all(r["rc"] == 0 for s in sets for r in s)
    report = {"workload": args.workload, "seconds": args.seconds,
              "all_correct": all(r["rc"] == 0 and r["result"]["correct"]
                                 for r in sum(sets, []) + traced),
              "summary": summary(sets) if ran else None,
              "sets": sets, "traced": traced}
    print(json.dumps({k: report[k] for k in
                      ("workload", "all_correct", "summary")}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if report["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
