"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference nothing of the program; ``run.py`` fails, and does not fall
back, where no card is found or the program is missing."""
import ast
import json
import os
import shutil
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
ENV = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
           PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=ENV, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_port_path_load_no_jax():
    got = _loaded(
        "import tpbench.run, tpbench.engine, tpbench.launch, "
        "tpbench.control, tpbench.report\n"
        "from tpbench import spec\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "import repro_torch.core.decouple, repro_torch.graph.synthetic, "
        "repro_torch.optim.adamw, repro_torch.runtime.mesh, "
        "repro_torch.runtime.distributed, repro_torch.runtime.telemetry")
    assert "repro_torch" in got and not got & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    got = _loaded("import tpbench.reference.gnn")
    assert "repro_torch" not in got and not got & FORBIDDEN
    for path in (ROOT / "tpbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {
                    "repro_torch"}, (path, name)


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "tpbench/run.py", "--workload", "gcn-reddit.tp1",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=dict(ENV, PYTHONPATH=""),
        cwd=str(cwd), timeout=120)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode == 2
    assert "CUDA card" in out.stderr and "{" not in out.stdout


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tpbench", tmp_path / "tpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
