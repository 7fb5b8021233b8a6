"""The port's runnable examples, each run as a subprocess on the CPU
(``--device cpu``), all three at once.

* ``examples/train_gcn_full_graph_torch.py`` at a small size, alone (a
  1-rank gloo group) and under ``torchrun`` with two ranks: exit code 0,
  the reference's lines, and a checkpoint that restores in the port with
  the metadata it wrote.
* ``examples/quickstart_torch.py`` as it ships (4 096 vertices, 50
  epochs; ≈ 5 s on the CPU): exit code 0 and its five epoch lines.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import checkpoint

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--n", "512", "--feat-dim", "16", "--epochs",
         "3"]
LAUNCHER_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def _commands(tmp: Path) -> dict:
    train = str(ROOT / "examples" / "train_gcn_full_graph_torch.py")
    return {
        "train": [sys.executable, train, *SMALL, "--ckpt",
                  str(tmp / "alone" / "gcn")],
        "torchrun": [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", "2", train,
                     *SMALL, "--ckpt", str(tmp / "torchrun" / "gcn")],
        "quickstart": [sys.executable,
                       str(ROOT / "examples" / "quickstart_torch.py"),
                       "--device", "cpu"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(returncode, stdout, stderr) of each command, and the directory of
    the checkpoints."""
    tmp = tmp_path_factory.mktemp("examples")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = {name: subprocess.Popen(cmd, env=env, cwd=tmp,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in _commands(tmp).items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=180)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, tmp


@pytest.mark.parametrize("name, ranks", [("train", 1), ("torchrun", 2)])
def test_train_example_runs_and_round_trips_its_checkpoint(runs, name,
                                                           ranks):
    out, tmp = runs
    rc, stdout, stderr = out[name]
    assert rc == 0, stderr[-3000:]
    ckpt = tmp / ("alone" if name == "train" else "torchrun") / "gcn"
    lines = stdout.splitlines()
    assert lines[0] == f"devices: {ranks}  mode: decoupled_pipelined"
    assert len([ln for ln in lines if ln.startswith("epoch ")]) == 3
    acc = re.search(r"test accuracy: ([0-9.]+)", stdout)
    assert acc, stdout
    assert lines[-1] == f"checkpoint round-trip OK → {ckpt}.npz"
    meta = checkpoint.load_metadata(str(ckpt))
    assert meta["model"] == "gcn"
    assert f"{meta['test_acc']:.3f}" == acc.group(1)


def test_quickstart_runs(runs):
    out, _ = runs
    rc, stdout, stderr = out["quickstart"]
    assert rc == 0, stderr[-3000:]
    lines = stdout.splitlines()
    assert lines[:2] == ["workers: 1", "graph: 4096 vertices, 44807 edges"]
    assert [ln.split()[1] for ln in lines if ln.startswith("epoch")] == \
        ["10", "20", "30", "40", "50"]
    assert lines[-1].startswith("test accuracy: ")
