"""The port's distributed-discipline linter (``repro_torch.analysis.lint``),
rule by rule on in-memory sources, as ``tests/test_lint.py`` holds the
reference's: every spelling that must fire, each allowed module,
suppression, a syntax error as a finding, the stub rule on a small tree,
and the port's own tree clean (``scripts/lint_dist_torch.py`` exits 0
on it, and 1 on a copy with a planted violation).
"""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]
ENGINE = "src/repro_torch/gnn/x.py"


def _rules(text, path=ENGINE, module=None):
    src = textwrap.dedent(text)
    return sorted({f.rule for f in lint.lint_text(src, path, module)})


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_complete_and_unique():
    ids = [r.id for r in lint.all_rules()]
    assert ids == sorted(ids) and len(ids) == len(set(ids))
    assert ids == ["RT001", "RT002", "RT003", "RT004", "RT005", "W100"]
    for r in lint.all_rules():
        assert r.severity in ("error", "warn", "none")
        assert r.invariant
    # RT004 is a line in the table saying why it has no counterpart
    (rt004,) = [r for r in lint.all_rules() if r.id == "RT004"]
    assert rt004.fn is None and "loop_scope" in rt004.invariant


# ---------------------------------------------------------------------------
# RT001 — every spelling of a torch.distributed collective resolves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    """
    import torch.distributed as dist
    def f(out, x):
        dist.all_to_all_single(out, x)
    """,
    """
    from torch.distributed import all_reduce
    def f(x):
        all_reduce(x)
    """,
    """
    from torch.distributed import all_reduce as ar
    def f(x):
        ar(x)
    """,
    """
    import torch
    def f(parts, x):
        torch.distributed.all_gather(parts, x)
    """,
    """
    from torch.distributed import _functional_collectives as funcol
    def f(x, g):
        return funcol.all_reduce(x, "sum", g)
    """,
    """
    import torch.distributed._functional_collectives as fc
    def f(x, g):
        return fc.all_to_all_single(x, None, None, g)
    """,
    """
    from torch.distributed.nn.functional import all_reduce
    def f(x):
        return all_reduce(x)
    """,
    """
    import torch.distributed.nn
    def f(x):
        return torch.distributed.nn.functional.all_gather(x)
    """,
    """
    import torch
    def f(x, g):
        return torch.ops._c10d_functional.all_reduce(x, "sum", g)
    """,
    """
    import torch.distributed as dist
    def f(out, x):
        dist.reduce_scatter_tensor(out, x)
        dist.barrier()
    """,
], ids=["alias-module", "from-import", "from-import-alias",
        "attribute-chain", "functional", "functional-alias",
        "autograd-nn", "autograd-nn-chain", "c10d-ops", "more-ops"])
def test_rt001_every_spelling(src):
    assert _rules(src) == ["RT001"]


def test_rt001_allowed_in_chokepoint_module():
    assert _rules("""
        import torch.distributed as dist
        def f(out, x):
            dist.all_to_all_single(out, x)
    """, path="src/repro_torch/runtime/collectives.py") == []


def test_rt001_ignores_non_collective_api():
    assert _rules("""
        import torch.distributed as dist
        def f():
            g = dist.new_group([0])
            return dist.get_rank(g), dist.get_world_size(), \\
                dist.ReduceOp.SUM, dist.get_backend(g)
    """) == []


def test_rt001_ignores_unimported_names():
    # a local helper named all_reduce is not torch.distributed's
    assert _rules("""
        def all_reduce(x):
            return x
        def f(x):
            return all_reduce(x)
    """) == []


def test_rt001_runtime_collectives_wrapper_ok():
    # engine code calling the choke point's wrappers is the sanctioned
    # spelling, relative import included
    assert _rules("""
        from ..runtime import collectives as C
        def f(x, g):
            return C.psum(C.all_to_all(x, g, split_axis=1, concat_axis=0))
    """) == []


# ---------------------------------------------------------------------------
# RT002 — DTensor entry points only under runtime/
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    """
    from torch.distributed.tensor import distribute_tensor
    def f(x, m, p):
        return distribute_tensor(x, m, p)
    """,
    """
    from torch.distributed.tensor import DTensor
    def f(x, m, p):
        return DTensor.from_local(x, m, p)
    """,
    """
    from torch.distributed._tensor import DTensor
    def f(x, m, p):
        return DTensor.from_local(x, m, p)
    """,
    """
    from torch.distributed.device_mesh import DeviceMesh
    def f(g):
        return DeviceMesh.from_group(g, "cuda")
    """,
    """
    import torch.distributed.device_mesh as dm
    def f():
        return dm.init_device_mesh("cuda", (2,))
    """,
    """
    def f(x, m, p):
        return x.redistribute(m, p)
    """,
], ids=["distribute_tensor", "from_local", "private-module", "DeviceMesh",
        "init_device_mesh", "redistribute"])
def test_rt002_outside_runtime(src):
    assert _rules(src) == ["RT002"]


def test_rt002_entry_points_allowed_under_runtime():
    assert _rules("""
        from torch.distributed.tensor import DTensor
        from torch.distributed.device_mesh import DeviceMesh
        def f(x, g, p):
            return DTensor.from_local(x, DeviceMesh.from_group(g, "cuda"), p)
    """, path="src/repro_torch/runtime/mesh.py") == []


def test_rt002_redistribute_only_in_replicate():
    src = """
        def {name}(x, m, p):
            return x.redistribute(m, p)
    """
    path = "src/repro_torch/runtime/constraint.py"
    assert _rules(src.format(name="replicate"), path=path) == []
    assert _rules(src.format(name="layout_cast"), path=path) == ["RT002"]
    assert _rules(src.format(name="replicate"),
                  path="src/repro_torch/runtime/mesh.py") == ["RT002"]


def test_rt002_ignores_types_and_the_ports_wrappers():
    assert _rules("""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from ..runtime import constraint as K
        def f(x, spec, mesh):
            if isinstance(x, DTensor):
                return x
            return K.from_local(x, spec, mesh), Replicate(), Shard(0)
    """) == []


# ---------------------------------------------------------------------------
# RT003 — explicit mirror= on layout transitions in engine code
# ---------------------------------------------------------------------------

_RT003_SRC = """
    from repro_torch.runtime import constraint as K
    def f(h, spec, src):
        return K.{fn}(h, spec, src{suffix})
"""


@pytest.mark.parametrize("fn", ["layout_cast", "note_transition"])
def test_rt003_missing_mirror_flagged(fn):
    for path in ("src/repro_torch/core/x.py", "src/repro_torch/gnn/x.py",
                 "src/repro_torch/nn/x.py"):
        assert _rules(_RT003_SRC.format(fn=fn, suffix=""),
                      path=path) == ["RT003"], path


@pytest.mark.parametrize("fn", ["layout_cast", "note_transition"])
def test_rt003_explicit_mirror_ok(fn):
    for suffix in (", mirror=True", ", mirror=False"):
        assert _rules(_RT003_SRC.format(fn=fn, suffix=suffix),
                      path="src/repro_torch/core/x.py") == []


def test_rt003_other_constraint_calls_exempt():
    assert _rules("""
        from repro_torch.runtime import constraint as K
        def f(h, spec):
            return K.constrain(h, spec)
    """, path="src/repro_torch/core/x.py") == []


def test_rt003_only_engine_segments():
    # the runtime layer owns the defaults; the launcher is not engine code
    for path in ("src/repro_torch/runtime/constraint.py",
                 "src/repro_torch/launch/multihost.py"):
        assert _rules(_RT003_SRC.format(fn="layout_cast", suffix=""),
                      path=path) == []


def test_rt003_relative_and_from_imports_resolve():
    assert _rules("""
        from ..runtime import constraint as K
        def f(h, spec, src):
            return K.layout_cast(h, spec, src_spec=src)
    """, path="src/repro_torch/core/x.py") == ["RT003"]
    assert _rules("""
        from repro_torch.runtime.constraint import note_transition
        def f(h, a, b):
            return note_transition(h, a, b)
    """, path="src/repro_torch/gnn/x.py") == ["RT003"]


# ---------------------------------------------------------------------------
# RT005 — the process group and the env contract
# ---------------------------------------------------------------------------

def test_rt005_env_read_spellings():
    for read in ('os.environ["NUM_PROCESSES"]',
                 'os.environ.get("PROCESS_ID")',
                 'os.getenv("COORDINATOR_ADDRESS")',
                 'os.environ.get("DIST_INIT_TIMEOUT", "60")'):
        assert _rules(f"""
            import os
            def f():
                return {read}
        """) == ["RT005"], read


@pytest.mark.parametrize("src", [
    """
    import torch.distributed as dist
    def f():
        dist.init_process_group("gloo")
    """,
    """
    from torch.distributed import init_process_group
    def f():
        init_process_group("nccl")
    """,
    """
    import torch
    def f():
        torch.distributed.init_process_group("gloo")
    """,
], ids=["alias", "from-import", "chain"])
def test_rt005_init_process_group(src):
    assert _rules(src) == ["RT005"]


def test_rt005_non_contract_key_ok():
    assert _rules("""
        import os
        def f():
            return os.environ.get("WORLD_SIZE")
    """) == []


def test_rt005_writes_are_not_reads():
    # launchers *set* the contract for children; only reads are owned
    assert _rules("""
        import os
        def f():
            os.environ["NUM_PROCESSES"] = "2"
    """) == []


def test_rt005_allowed_in_distributed_module():
    assert _rules("""
        import os
        import torch.distributed as dist
        def f():
            dist.init_process_group("gloo")
            return os.environ.get("NUM_PROCESSES")
    """, path="src/repro_torch/runtime/distributed.py") == []


# ---------------------------------------------------------------------------
# suppression + drivers
# ---------------------------------------------------------------------------

_PLANTED = """
    import torch.distributed as dist
    def f(x):
        dist.all_reduce(x){comment}
"""


def test_suppression_matching_rule():
    assert _rules(_PLANTED.format(
        comment="  # lint-ok: RT001 negative test")) == []


def test_suppression_other_rule_does_not_hide():
    assert _rules(_PLANTED.format(comment="  # lint-ok: RT005")) == [
        "RT001"]


def test_suppression_bare_comment():
    assert _rules(_PLANTED.format(comment="  # lint-ok")) == []


def test_module_name_for():
    f = lint.module_name_for
    assert f("src/repro_torch/core/tp.py") == "repro_torch.core.tp"
    assert f("src/repro_torch/core/__init__.py") == "repro_torch.core"
    assert f("scripts/lint_dist_torch.py") is None


def test_lint_paths_syntax_error_is_a_finding(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    (tmp_path / "ok.py").write_text(
        "import torch.distributed as dist\n\n\ndef f(x):\n"
        "    dist.all_reduce(x)\n")
    rules = {f.rule for f in lint.lint_paths([str(tmp_path)])}
    assert "E999" in rules          # reported, not raised
    assert "RT001" in rules         # and the rest still linted


def test_w100_reports_unreferenced_stub(tmp_path):
    src = tmp_path / "src" / "repro_torch"
    cfg = src / "configs"
    os.makedirs(cfg)
    for d in (src, cfg):
        (d / "__init__.py").write_text("")
    (cfg / "dead_model.py").write_text("CONFIG = {}\n")
    (cfg / "live_model.py").write_text("CONFIG = {}\n")
    (src / "user.py").write_text(
        "from repro_torch.configs import live_model  # noqa: F401\n")
    findings = [f for f in lint.lint_paths([str(src)]) if f.rule == "W100"]
    assert [os.path.basename(f.path) for f in findings] == ["dead_model.py"]
    assert all(f.severity == "warn" for f in findings)


def test_finding_format_and_dict():
    f = lint.LintFinding("RT001", "a.py", 3, 7, "msg")
    assert f.format() == "a.py:3:7: RT001 [error] msg"
    assert f.as_dict()["severity"] == "error"


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

def test_port_tree_has_no_error():
    findings = lint.lint_paths([str(ROOT / "src" / "repro_torch")])
    assert [f.format() for f in findings if f.severity == "error"] == []


def test_cli_clean_tree_and_planted_violations(tmp_path):
    script = str(ROOT / "scripts" / "lint_dist_torch.py")
    ok = subprocess.run([sys.executable, script], capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout
    assert "0 error(s)" in ok.stdout.splitlines()[-1]
    rules = subprocess.run([sys.executable, script, "--rules"],
                           capture_output=True, text=True, timeout=120)
    assert rules.returncode == 0
    assert [ln.split()[0] for ln in rules.stdout.splitlines()] == [
        "RT001", "RT002", "RT003", "RT004", "RT005", "W100"]
    # a copy of the engine with a bypassed collective and a transition
    # whose mirror is no longer declared
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    text = (ROOT / "src" / "repro_torch" / "core" / "decouple.py").read_text()
    planted = text.replace(
        "src_spec=vspec, mirror=True)", "src_spec=vspec)", 1).replace(
        "    sums = C.psum(sums, mesh.group, axis=mesh.axis)\n",
        "    torch.distributed.all_reduce(sums)\n", 1)
    assert planted != text
    shutil.copy(ROOT / "src" / "repro_torch" / "core" / "__init__.py", core)
    (core / "decouple.py").write_text(planted)
    bad = subprocess.run([sys.executable, script, "--json",
                          str(tmp_path / "out.json"), str(core)],
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1, bad.stdout
    found = {ln.split(": ")[1].split()[0] for ln in bad.stdout.splitlines()
             if "[error]" in ln}
    assert found == {"RT001", "RT003"}, bad.stdout
    assert (tmp_path / "out.json").exists()
