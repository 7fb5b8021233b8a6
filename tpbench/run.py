#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 tpbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``tpbench/spec.py`` finds their files by name.  The run makes
its graph and weights from ``--seed`` on the card, trains
``repro_torch``'s decoupled tensor-parallel GCN or GAT full-graph for
``--seconds`` of closed-loop steps (one process a card, four through
``tpbench/launch.py``), and holds its first steps against the plain
reference.  ``--trace 0`` prints the end-to-end metrics, ``--trace 1``
the per-layer ones with the profiled steps' ``breakdown``.  The last
line of standard output is the result, a JSON object; the numbers
compared are the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits with 2.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "tpbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"tpbench: the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    _caches()
    from tpbench import engine, report, spec

    cell = spec.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"tpbench: cell {cell['name']} needs {cell['chips']} CUDA "
              f"card(s), found {have}", file=sys.stderr)
        return 2

    if cell["chips"] == 1:
        ranks = [engine.run_rank(cell, args.seed, args.seconds,
                                 bool(args.trace), T0)]
    else:
        from tpbench import launch
        ranks = launch.launch(cell, {"task": "run", "seed": args.seed,
                                     "seconds": args.seconds,
                                     "trace": bool(args.trace), "t0": T0})
    bad = sorted(set(engine.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if bad:
        print(f"tpbench: the run loaded {bad}, which the port may not "
              f"use", file=sys.stderr)
        return 3
    line = report.result(cell, ranks, bool(args.trace),
                         torch.cuda.get_device_name(0))
    r0 = ranks[0]
    print(f"steps {r0['steps']} window_s {r0['window_s']!r} step_p50_ms "
          f"{r0['step_p50_ms']!r} step_p95_ms {r0['step_p95_ms']!r} "
          f"prepare_s {r0['prepare_s']!r} edges {r0['shapes']['e']}",
          flush=True)
    report.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
