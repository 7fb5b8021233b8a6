"""Run one child program per checkout of the repo on one GPU: the shared
runner of the scripts that compare a parent tree with a change in one
call (``torch_flash_fp32.py``, ``torch_spmm_bf16.py``).

Each ROOT runs in a fresh process, in the order given, with that ROOT's
``repro_torch`` (its kernels built from its own sources into its own
``build/torch_kernels/``) and this checkout's ``chip_smoke`` helpers.  A
child starts with ``PREAMBLE`` (``cs`` is ``chip_smoke``, ``dev`` the
card) and ends by printing ``RESULT <json>``.  To compare two trees,
unpack the other under ``build/`` (``git archive``) and give parent,
change, change, parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

PREAMBLE = r"""
import json, sys, time, torch
sys.path.insert(0, {src!r})
import repro_torch
sys.path.insert(0, {here!r})
import chip_smoke as cs
from repro_torch.kernels import build

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
print("repro_torch from", repro_torch.__file__)
t = time.perf_counter()
build.build()
print(f"built {{[p.name for p in build.SOURCES]}} in "
      f"{{time.perf_counter() - t:.1f}} s")
"""


def card(script: str) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    None (with a message) when no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device", file=sys.stderr)
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_roots(child: str, roots: list[Path], **fields) -> list | None:
    """``PREAMBLE + child`` run once per ROOT (default: this checkout),
    formatted with ``src``, ``here``, ``root`` and ``fields``; each run's
    ``RESULT`` object, or None when a run fails."""
    results = []
    for root in [r.resolve() for r in roots] or [HERE]:
        program = (PREAMBLE + child).format(
            src=str(root / "src"), here=str(HERE), root=str(root), **fields)
        proc = subprocess.run([sys.executable, "-c", program],
                              capture_output=True, text=True)
        print(f"==== {root}\n{proc.stdout}{proc.stderr[-3000:]}")
        if proc.returncode:
            print(f"run from {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return None
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    return results


def report(card_line: str, results: list, out: Path | None) -> None:
    """The card's line, then one JSON line per run; ``out`` gets them all."""
    print(card_line)
    for res in results:
        print(json.dumps({**res, "card": card_line}))
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card_line, "runs": results}))
