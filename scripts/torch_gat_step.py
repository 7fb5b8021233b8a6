#!/usr/bin/env python3
"""Time the GAT training steps of ``chip_smoke.py`` phases 10–11 on one GPU,
from one or more checkouts of the repo.

    python3 scripts/torch_gat_step.py [ROOT ...]

Each ROOT (default: this checkout) runs in a fresh process, in the order
given; to compare two trees in one call, give parent, change, change,
parent.  A run: ``reddit_like(scale=1.0, seed=0)``, ``prepare_bundle``
with 4 chunks (segment: GAT runs no other backend), hidden 128, 2 layers,
one NCCL rank, TF32 off; then ``chip_smoke.gat`` of that ROOT for
``decoupled_pipelined`` and ``naive``: 3 warm-up + 10 timed steps with
the phase's holds (0 SpMM launches, the ledger, step 0 against the
unpipelined mode or one device) and one step profiled.  Prints each run's
output, then one JSON line per run: the step medians and the device busy
and idle share of each mode.  Exits non-zero if a run fails or no CUDA
device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, socket, sys, torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.core import decouple as D
from repro_torch.graph.synthetic import reddit_like

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{{port}}",
                        rank=0, world_size=1)
try:
    data = reddit_like(scale=1.0, seed=0)
    bundle = D.prepare_bundle(data, n_workers=1, n_chunks=4, device=dev)
    out = {{}}
    for mode in ("decoupled_pipelined", "naive"):
        info = cs.gat(bundle, data, dev, mode)
        prof = info["profile"]
        out[mode] = {{"step_ms": info["step_ms"], "busy_ms": prof["busy_ms"],
                     "idle_share": 1 - prof["busy_ms"] / prof["wall_ms"]}}
finally:
    dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [HERE]
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c",
                               CHILD.format(root=str(root))],
                              capture_output=True, text=True)
        print(f"==== {root}\n{proc.stdout}{proc.stderr[-3000:]}")
        if proc.returncode:
            print(f"run from {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        results.append((root, json.loads(line[len("RESULT "):])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    for root, res in results:
        print(json.dumps({"root": str(root), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
