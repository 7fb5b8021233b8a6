#!/usr/bin/env python3
"""A cell's ranks as one process a card, started through the port's env
contract (``repro_torch.runtime.distributed.initialize``:
``COORDINATOR_ADDRESS`` on a free localhost port, ``NUM_PROCESSES``,
``PROCESS_ID``), each writing its record into a directory of ``TMPDIR``.
A rank that fails, or a run that outlasts its timeout, ends every rank
and fails the run with the ranks' last output.

This file is also the ranks' entry point: ``python tpbench/launch.py
--cell FILE --out FILE ...`` (started by :func:`launch`, not by hand).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAIL = 4000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cell: dict, task: dict, *, device: str = "cuda",
           timeout: float = 320.0) -> list:
    """Run ``task`` (the ranks' arguments: ``{"task": "run", "seed",
    "seconds", "trace", "t0"}`` and optionally ``"fault"``, or ``{"task":
    "control", ...}``) on ``cell["chips"]`` ranks; return each rank's
    record in rank order."""
    world = cell["chips"]
    tmp = Path(tempfile.mkdtemp(prefix="tpbench-ranks-"))
    procs, logs = [], []
    try:
        (tmp / "cell.json").write_text(json.dumps(cell))
        (tmp / "task.json").write_text(json.dumps(task))
        address = f"127.0.0.1:{_free_port()}"
        path = os.pathsep.join([str(ROOT / "src"), str(ROOT)]
                               + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p])
        for i in range(world):
            env = dict(os.environ, COORDINATOR_ADDRESS=address,
                       NUM_PROCESSES=str(world), PROCESS_ID=str(i),
                       DIST_INIT_TIMEOUT="120", PYTHONPATH=path)
            logs.append(open(tmp / f"rank{i}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--dir", str(tmp), "--device", device],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT)))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.2)
        if failed is None:
            failed = next((i for i, p in enumerate(procs)
                           if p.returncode != 0), None)
        _stop(procs)
        for f in logs:
            f.close()
        if failed is not None:
            tails = "".join(
                f"--- rank {i} (exit {p.returncode}) ---\n"
                + (tmp / f"rank{i}.log").read_text()[-TAIL:]
                for i, p in enumerate(procs))
            why = (f"ran past {timeout:.0f} s" if failed == "timeout"
                   else f"rank {failed} failed")
            raise RuntimeError(f"{why}\n{tails}")
        return [json.loads((tmp / f"rank{i}.json").read_text())
                for i in range(world)]
    finally:
        _stop(procs)
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tmp = Path(args.dir)
    cell = json.loads((tmp / "cell.json").read_text())
    task = json.loads((tmp / "task.json").read_text())
    if task["task"] == "run":
        from tpbench import engine
        record = engine.run_rank(cell, task["seed"], task["seconds"],
                                 task["trace"], task["t0"], args.device,
                                 task.get("fault"))
    else:
        from tpbench import control
        record = control.readings_rank(cell, task["seeds"], args.device,
                                       task["faults"], task.get("again",
                                                                False))
    rank = os.environ["PROCESS_ID"]
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
