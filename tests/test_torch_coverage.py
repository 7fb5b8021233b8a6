"""Coverage guard: the port defines every public top-level function, class
and constant of the JAX package, or names why not.

``src/repro/**/*.py`` and ``src/repro_torch/**/*.py`` are read with
``ast`` (no import, no JAX).  Every public name the reference defines at
the top level of a module (``def``, ``class``, an assignment) must be
defined at the top level of some module of the port, or be one of
``EXCLUDED``, each with its counterpart in the port or its reason.
``EXCLUDED`` is ROADMAP.md's "Not ported, on purpose" list, name for name.
"""
import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"


def _excluded(groups: dict) -> dict:
    return {name: why for names, why in groups.items()
            for name in names.split()}


# name(s) → the counterpart in the port, or why there is none
EXCLUDED = _excluded({
    "PRIM_TO_OP MIRROR_OP collective_counts sharding_constraint_counts":
        "analysis/jaxpr_audit.py counts collectives in a jaxpr; the port's "
        "census is analysis/audit.py (torch.profiler's c10d records)",
    "LAX_COLLECTIVES":
        "lax's collective names; the linter's are "
        "analysis/lint.py::TORCH_COLLECTIVES",
    "bundled_train_fns bundled_value_and_grad donation_supported as_mesh "
    "tp_mesh static_axis_size":
        "jit plumbing with no counterpart in an eager torch program; "
        "runtime/mesh.py::TPMesh is the mesh",
    "vertex_axes data_axes_for mesh_axes":
        "wrappers of mesh axis names; TPMesh.axis and TPMesh.data_axes "
        "hold them",
    "DATA_AXES_ORDER":
        "the reference's order of replica axes; runtime/mesh.py::"
        "hybrid_mesh takes the data axes outermost first",
    "pad_to_multiple": "runtime/mesh.py::padded_size",
    "local_slice": "core/tp.py::vertex_block",
    "NEG_INF":
        "the masked score, -1e30 in kernels/flash_attn/ref.py and "
        "kNegInf in the kernels' sources",
    "resolve_interpret":
        "the Pallas interpreter; the port's wrappers run the kernel on "
        "CUDA tensors and the plain version on CPU tensors",
    "spmm_block_sparse":
        "kernels/spmm/spmm.py::spmm_csr, the kernel on compressed rows",
    "ssd_chunked_pallas": "kernels/ssd/ops.py::ssd_chunked_fused",
    "PEAK_FLOPS HBM_BW ICI_BW":
        "the TPU's peaks; launch/roofline.py::Peaks holds the H100's",
    "hlo_census":
        "launch/roofline.py::census (the ledger, FlopCounterMode and the "
        "byte count; there is no HLO)",
    "ParamLeaf is_leaf split_params map_names_to_specs":
        "the port's init_transformer builds the value tree alone; "
        "nn/param.py::param_names gives the names tree and "
        "sharding/specs.py maps names to specs",
    "abstract_params":
        "models/transformer.py::init_transformer with device=\"meta\"",
    "constraint_engine JAX_VERSION SUPPORTED_JAX CHECK_KW "
    "resolve_shard_map smap engine":
        "shard_map and jit engines; the port's factories take the mesh, "
        "the constraint backend is runtime/constraint.py and "
        "validate_specs lives there",
    "OP_TO_HLO":
        "HLO op names of the ledger's ops; analysis/audit.py reads c10d's",
    "loop_scope loop_multiplier":
        "trace-time trip counts; the port records every execution",
    "mirror_scope mirror_suppressed":
        "trace-time suppression of a declared mirror; the port records "
        "what runs (runtime/telemetry.py's docstring)",
})


def _top_level(root: Path, public: bool) -> dict:
    """name → the modules under ``root`` that define it at the top level
    (functions, classes, assignments to plain names)."""
    found = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [e.id for t in node.targets
                         for e in (t.elts if isinstance(t, ast.Tuple)
                                   else [t]) if isinstance(e, ast.Name)]
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names = [node.target.id]
            else:
                continue
            for name in names:
                if not (public and name.startswith("_")):
                    found.setdefault(name, []).append(
                        str(path.relative_to(root)))
    return found


def test_the_scan_sees_both_packages():
    ref, port = _top_level(REFERENCE, True), _top_level(PORT, False)
    assert len(ref) > 300 and len(port) > 300
    assert "spmm_block_sparse" in ref and "spmm_csr" in port


def test_every_public_name_is_ported_or_excluded():
    port = _top_level(PORT, False)
    missing = {name: mods for name, mods in _top_level(REFERENCE,
                                                       True).items()
               if name not in port and name not in EXCLUDED}
    assert not missing, f"defined in src/repro, not in src/repro_torch " \
                        f"nor excluded: {missing}"


def test_every_exclusion_is_a_missing_reference_name():
    ref, port = _top_level(REFERENCE, True), _top_level(PORT, False)
    stale = [name for name in EXCLUDED if name not in ref or name in port]
    assert not stale, f"excluded but not missing from the port: {stale}"


def test_every_exclusion_names_a_counterpart_or_reason():
    """Each reason names a counterpart that exists (``path.py`` under
    src/repro_torch, ``path.py::name`` defined there) or gives a reason
    in words."""
    port = _top_level(PORT, False)
    for name, why in EXCLUDED.items():
        refs = re.findall(r"([\w/]+\.py)(?:::(\w+))?", why)
        for path, defined in refs:
            if path.startswith(("analysis/jaxpr_audit", "runtime/smap")):
                continue                       # the reference's own
            assert (PORT / path).exists(), (name, path)
            assert not defined or path in port.get(defined, []), \
                (name, path, defined)
        assert refs or len(why.split()) >= 4, (name, why)


def test_exclusions_equal_roadmap_list():
    """ROADMAP.md's "Not ported, on purpose" bullets read ``- `a`, `b` —
    reason``: the names before the dash, over the whole list, are
    ``EXCLUDED``'s."""
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("**Not ported, on purpose:**", 1)[1]
    section = section.split("\n**", 1)[0]
    listed = set()
    for line in section.splitlines():
        if line.startswith("- `"):
            listed.update(re.findall(r"`([^`]+)`", line.split(" — ")[0]))
    assert listed == set(EXCLUDED)
