"""The rest of a run, past the look for a card, on gloo ranks at a tiny
size: sound runs come out correct, and each fault a cell can have,
planted under the timed path, and the TF32 control come out not
correct; a rank that fails ends the run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def drive() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, str(HERE / "cpu_drive.py")],
                         capture_output=True, text=True, env=env,
                         cwd=str(HERE), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_sound_runs_are_correct(drive, model):
    assert drive["faults"][f"{model}.None"] is True
    assert drive["faults"][f"{model}.program"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "control"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_faults_and_control_are_not(drive, model, fault):
    assert drive["faults"][f"{model}.{fault}"] is False


def test_exchange_left_out_between_two_ranks(drive):
    assert drive["launch"] == {"None": True, "exchange": False}


def test_a_failing_rank_fails_the_run(drive):
    got = drive["dead"]
    assert got["raised"] and got["seconds"] < 60
    assert "nonesuch" in got["message"]
