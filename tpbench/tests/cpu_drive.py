"""Drives the harness on the CPU at a tiny size, past its look for a
card, for the tests: ``python cpu_drive.py``; prints one JSON object."""
from __future__ import annotations

import json
import time

import torch

from tiny import tiny_cell

from tpbench import compare, engine, launch, report

SEED = 2 ** 31 + 5


def faults() -> dict:
    """A sound run, each one-rank fault planted under the timed path, and
    the lower-precision control, on one gloo rank."""
    out = {}
    for model in ("gcn", "gat"):
        cell = tiny_cell(f"{model}-reddit.tp1")
        for fault in (None, "unchanged", "half_batch"):
            rec = engine.run_rank(cell, SEED, 0.05, False, time.time(),
                                  device="cpu", fault=fault)
            out[f"{model}.{fault}"] = rec["correct"]
        from repro_torch.runtime import distributed as RD
        RD.initialize(device="cpu")
        try:
            prog = engine.Program(cell, SEED, torch.device("cpu"))
            params0 = prog.free()
        finally:
            RD.shutdown()
        dev = torch.device("cpu")
        ref = engine.reference(cell, SEED, dev, params0)
        ctl = engine.reference(cell, SEED, dev, params0, tf32=True)
        out[f"{model}.control"] = compare.verdict(
            compare.readings(ctl, ref), cell["limits"])[0]
        out[f"{model}.program"] = compare.verdict(
            compare.readings(prog.first, ref), cell["limits"])[0]
    return out


def _two_ranks() -> dict:
    cell = tiny_cell("gcn-reddit.tp4")
    cell["chips"] = cell["traffic"]["tp_degree"] = 2
    return cell


def launch_two() -> dict:
    """Two gloo ranks through the launcher: sound, and with the
    exchange between them left out."""
    cell, out = _two_ranks(), {}
    for fault in (None, "exchange"):
        task = {"task": "run", "seed": SEED, "seconds": 0.05,
                "trace": False, "t0": time.time()}
        if fault:
            task["fault"] = fault
        ranks = launch.launch(cell, task, device="cpu", timeout=120)
        out[str(fault)] = report.result(cell, ranks, False, "cpu")["correct"]
    return out


def dead() -> dict:
    """A rank that fails ends the run, within the timeout."""
    t = time.monotonic()
    try:
        launch.launch(_two_ranks(), {"task": "run", "seed": SEED,
                                     "seconds": 60.0, "trace": False,
                                     "t0": time.time(), "fault": "nonesuch"},
                      device="cpu", timeout=100)
    except RuntimeError as e:
        return {"raised": True, "seconds": time.monotonic() - t,
                "message": str(e)[:2000]}
    return {"raised": False}


if __name__ == "__main__":
    print(json.dumps({"faults": faults(), "launch": launch_two(),
                      "dead": dead()}))
