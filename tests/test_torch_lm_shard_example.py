"""``examples/train_lm_neutron_tp_torch.py`` on the CPU: four gloo
processes it starts itself on (data=2, model=2), a few steps under the
plain and the explicit sharder and under the megatron strategy — finite
losses, falling from the first step, the same under the two sharders and
within 2e-4 of them (their printed four decimals) under megatron."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "train_lm_neutron_tp_torch.py"
ARGS = ["--device", "cpu", "--model", "2", "--data", "2", "--steps", "4",
        "--batch", "4", "--seq", "32"]


def _run(*extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                        "PROCESS_ID")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"    # twelve ranks at once beside the others
    return subprocess.Popen([sys.executable, str(EXAMPLE), *ARGS, *extra],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_example_trains_on_four_processes():
    runs = {"plain": _run(), "explicit": _run("--explicit"),
            "megatron": _run("--strategy", "megatron")}
    out = {k: p.communicate(timeout=150) for k, p in runs.items()}
    losses = {}
    for kind in ("plain", "explicit", "megatron"):
        stdout, stderr = out[kind]
        assert runs[kind].returncode == 0, stderr[-3000:]
        assert "mesh {'model': 2, 'data': 2}" in stdout
        assert "4 processes on cpu" in stdout
        losses[kind] = [float(x) for x in re.findall(r"loss (\d+\.\d+)",
                                                     stdout)]
        assert len(losses[kind]) == 5            # four steps and the final
        assert losses[kind][-1] < losses[kind][0]
    assert losses["plain"] == losses["explicit"]
    assert "strategy megatron" in out["megatron"][0]
    assert max(abs(a - b) for a, b in zip(losses["megatron"],
                                          losses["plain"])) <= 2e-4
