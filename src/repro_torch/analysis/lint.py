"""AST linter for the port's distributed disciplines.

The port's correctness rests on disciplines, as the reference's does:
every collective goes through ``runtime/collectives.py`` (the choke point
the collective ledger counts at), DTensor carries layouts but moves no
data outside ``constraint.replicate``, the constraint backend's layout
transitions in engine code declare their autodiff mirror, and the
process group is opened only by ``runtime/distributed.py``.  This linter
turns a violation of any of them into a finding.  It resolves imports
(absolute, relative, aliased) to fully-qualified dotted names first, so a
rule fires on *what a name means*, not on how it is spelled: ``import
torch.distributed as dist; dist.all_to_all_single``, ``from
torch.distributed import all_reduce as ar`` and
``torch.distributed._functional_collectives.all_reduce`` are one name
each.

Rules, each the counterpart of the reference's
(``repro.analysis.lint``):

===== ========= ========================================================
id    severity  invariant
===== ========= ========================================================
RT001 error     ``torch.distributed`` collectives (and the functional and
                autograd-aware spellings, ``torch.ops.c10d*``) only in
                ``runtime/collectives.py``, in any spelling.
RT002 error     DTensor entry points (``distribute_tensor``,
                ``DTensor.from_local``, ``DeviceMesh``,
                ``init_device_mesh``, ``redistribute``) only under
                ``runtime/``; ``redistribute`` only in
                ``runtime/constraint.py::replicate``.
RT003 error     in engine code (``core/``, ``gnn/``, ``nn/``) every
                ``layout_cast`` / ``note_transition`` call passes an
                explicit ``mirror=``.
RT004 —         no counterpart: ``loop_scope`` is not ported — the port
                records every execution, so no loop needs a trip count.
RT005 error     ``init_process_group`` and reads of the
                COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID/
                DIST_INIT_TIMEOUT env contract only in
                ``runtime/distributed.py``.
W100  warn      stub modules (``configs/*`` LM configs,
                ``serve/engine``) referenced only from their own package.
===== ========= ========================================================

Suppression: append ``# lint-ok: <RULE>`` (or a bare ``# lint-ok``) to
the offending line, with a reason.

API: :func:`lint_paths` (files and directories → findings, file- and
tree-level rules; an unparseable file is an ``E999`` finding),
:func:`lint_text` (one in-memory source, file-level rules only).  CLI:
``scripts/lint_dist_torch.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Callable, Iterator

__all__ = [
    "LintFinding", "Rule", "FILE_RULES", "TREE_RULES", "UNPORTED_RULES",
    "all_rules", "lint_paths", "lint_text", "iter_py_files",
    "module_name_for",
]

# ---------------------------------------------------------------------------
# Findings and rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"          # "error" (fails the CLI) | "warn"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.severity}] {self.message}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    invariant: str                   # one line; printed by --rules
    fn: Callable | None = None


FILE_RULES: list[Rule] = []          # fn(ctx) -> list[LintFinding]
TREE_RULES: list[Rule] = []          # fn(list[ctx]) -> list[LintFinding]

#: Reference rules with no port counterpart, and why (printed by --rules).
UNPORTED_RULES = [
    Rule("RT004", "none",
         "no counterpart: loop_scope is not ported — the port records "
         "every execution eagerly, so no communicating loop needs a trip "
         "multiplier"),
]


def _register(registry, rule_id, severity, invariant):
    def deco(fn):
        registry.append(Rule(rule_id, severity, invariant, fn))
        return fn
    return deco


def file_rule(rule_id, severity, invariant):
    return _register(FILE_RULES, rule_id, severity, invariant)


def tree_rule(rule_id, severity, invariant):
    return _register(TREE_RULES, rule_id, severity, invariant)


def all_rules() -> list[Rule]:
    """Every rule of the table, the unported ones included."""
    return sorted(FILE_RULES + TREE_RULES + UNPORTED_RULES,
                  key=lambda r: r.id)


# ---------------------------------------------------------------------------
# Per-file context: imports resolved to fully-qualified dotted names
# ---------------------------------------------------------------------------

def module_name_for(path: str) -> str | None:
    """Dotted module name of ``path``, or None when it is not under a
    ``src/`` root (scripts import absolutely, so their relative imports —
    which need a package context — stay unresolved rather than
    guessed)."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if "src" not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index("src")
    mods = parts[i + 1:]
    if not mods or not mods[-1].endswith(".py"):
        return None
    mods[-1] = mods[-1][:-3]
    if mods[-1] == "__init__":
        mods.pop()
    return ".".join(mods) or None


class _FileContext:
    """Parsed file + the name-resolution tables every rule shares."""

    def __init__(self, path: str, text: str, module: str | None = None):
        self.path = path
        self.parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
        self.lines = text.splitlines()
        self.module = module if module is not None else \
            module_name_for(path)
        # package context for relative imports: a module's package is its
        # parent; an __init__ IS its package (module_name_for strips it)
        base = os.path.basename(path)
        self.package = self.module if base == "__init__.py" else (
            self.module.rsplit(".", 1)[0]
            if self.module and "." in self.module else None)
        self.tree = ast.parse(text, filename=path)
        self.aliases: dict[str, str] = {}       # local name -> dotted fq
        self.import_nodes: list = []            # (node, base) for rules
        self.parent: dict[ast.AST, ast.AST] = {}
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:   # ``import torch.distributed`` binds the root
                        root = a.name.split(".")[0]
                        self.aliases[root] = root
                self.import_nodes.append((node, None))
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node)
                if base is not None:
                    for a in node.names:
                        if a.name == "*":
                            continue
                        self.aliases[a.asname or a.name] = \
                            f"{base}.{a.name}" if base else a.name
                self.import_nodes.append((node, base))

    def _from_base(self, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            return node.module or ""
        if self.package is None:
            return None                      # unknown package context
        parts = self.package.split(".")
        # level 1 = current package; each extra level climbs one parent
        parts = parts[: len(parts) - (node.level - 1)]
        if not parts:
            return None
        if node.module:
            parts += node.module.split(".")
        return ".".join(parts)

    def resolve(self, node) -> str | None:
        """Fully-qualified dotted name of a Name/Attribute chain, through
        the file's import aliases; None when the root is not imported."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    def path_has_segment(self, *segments: str) -> bool:
        return any(s in self.parts for s in segments)

    def rel_endswith(self, suffix: str) -> bool:
        return os.path.join(*self.parts[-len(suffix.split("/")):]) == \
            os.path.join(*suffix.split("/"))

    def enclosing_function(self, node) -> str | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur.name
            cur = self.parent.get(cur)
        return None

    def outermost_loads(self) -> Iterator[tuple[ast.AST, str]]:
        """(node, fq name) of every loaded Name/Attribute chain, the
        outermost attribute of a chain only (``a.b.c`` once, not again
        for its ``a.b`` prefix)."""
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            if not isinstance(getattr(node, "ctx", None), ast.Load):
                continue
            if isinstance(self.parent.get(node), ast.Attribute):
                continue
            fq = self.resolve(node)
            if fq:
                yield node, fq

    def suppressed(self, finding: LintFinding) -> bool:
        if not 1 <= finding.line <= len(self.lines):
            return False
        line = self.lines[finding.line - 1]
        if "# lint-ok" not in line:
            return False
        tail = line.split("# lint-ok", 1)[1].lstrip()
        if not tail.startswith(":"):
            return True                  # bare `# lint-ok`: all rules
        spec = tail[1:].strip()
        return spec == "" or finding.rule in spec


# ---------------------------------------------------------------------------
# RT001 — torch.distributed collectives only in runtime/collectives.py
# ---------------------------------------------------------------------------

#: The calls that put bytes on the wire (or synchronize ranks): the
#: ``torch.distributed`` API, its functional (``_functional_collectives``)
#: and autograd-aware (``torch.distributed.nn``) spellings, and the c10d
#: ops they dispatch to.
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "all_reduce_coalesced", "all_gather",
    "all_gather_into_tensor", "all_gather_object", "all_gather_tensor",
    "all_gather_tensor_autograd", "all_to_all", "all_to_all_single",
    "all_to_all_single_autograd", "reduce_scatter",
    "reduce_scatter_tensor", "reduce_scatter_tensor_autograd",
    "broadcast", "broadcast_object_list", "reduce", "gather",
    "gather_object", "scatter", "scatter_object_list", "send", "recv",
    "isend", "irecv", "batch_isend_irecv", "barrier", "monitored_barrier",
    "permute_tensor", "allreduce_", "allgather_", "_allgather_base_",
    "alltoall_", "alltoall_base_", "reduce_scatter_", "_reduce_scatter_base_",
    "reduce_scatter_tensor_coalesced", "all_gather_into_tensor_coalesced",
})

#: Namespaces whose members of that vocabulary are collectives.
COLLECTIVE_NAMESPACES = ("torch.distributed.", "torch.ops.c10d.",
                         "torch.ops.c10d_functional.",
                         "torch.ops._c10d_functional.",
                         "torch.ops._c10d_functional_autograd.")

_RT001_ALLOWED = "runtime/collectives.py"


def _is_collective(fq: str) -> bool:
    return fq.startswith(COLLECTIVE_NAMESPACES) and \
        fq.rsplit(".", 1)[1] in TORCH_COLLECTIVES


@file_rule("RT001", "error",
           "torch.distributed collectives route through "
           "runtime/collectives.py (the choke point the collective ledger "
           "counts at), in any spelling")
def _rt001(ctx: _FileContext) -> list[LintFinding]:
    if ctx.rel_endswith(_RT001_ALLOWED):
        return []
    out = []
    for node, base in ctx.import_nodes:
        if isinstance(node, ast.ImportFrom) and base:
            for a in node.names:
                if _is_collective(f"{base}.{a.name}"):
                    out.append(LintFinding(
                        "RT001", ctx.path, node.lineno, node.col_offset,
                        f"importing {base}.{a.name} outside "
                        f"runtime/collectives.py — route the collective "
                        f"through repro_torch.runtime.collectives so the "
                        f"ledger sees its bytes"))
    for node, fq in ctx.outermost_loads():
        if _is_collective(fq):
            out.append(LintFinding(
                "RT001", ctx.path, node.lineno, node.col_offset,
                f"direct use of {fq} outside runtime/collectives.py — call "
                f"repro_torch.runtime.collectives instead (the choke point "
                f"the CommLedger counts at)"))
    return out


# ---------------------------------------------------------------------------
# RT002 — DTensor entry points only under runtime/
# ---------------------------------------------------------------------------

#: DTensor's entry points, by their public and private module paths.
DTENSOR_ENTRY = frozenset({"distribute_tensor", "distribute_module",
                           "DTensor.from_local", "DeviceMesh",
                           "DeviceMesh.from_group", "init_device_mesh"})
DTENSOR_NAMESPACES = ("torch.distributed.tensor.",
                      "torch.distributed._tensor.",
                      "torch.distributed.device_mesh.")

#: The one allowed ``redistribute``: the Partial → Replicate all-reduces.
_RT002_REDISTRIBUTE = ("runtime/constraint.py", "replicate")


def _dtensor_entry(fq: str) -> bool:
    for ns in DTENSOR_NAMESPACES:
        if fq.startswith(ns) and fq[len(ns):] in DTENSOR_ENTRY:
            return True
    return False


@file_rule("RT002", "error",
           "DTensor entry points (distribute_tensor, DTensor.from_local, "
           "DeviceMesh, init_device_mesh) only under runtime/; "
           "redistribute only in runtime/constraint.py::replicate (DTensor "
           "carries layouts, the choke point moves the data)")
def _rt002(ctx: _FileContext) -> list[LintFinding]:
    out = []
    in_runtime = ctx.path_has_segment("runtime")
    if not in_runtime:
        for node, fq in ctx.outermost_loads():
            if _dtensor_entry(fq):
                out.append(LintFinding(
                    "RT002", ctx.path, node.lineno, node.col_offset,
                    f"{fq} outside runtime/ — global tensors enter through "
                    f"repro_torch.runtime.constraint (from_local, "
                    f"local_map) and TPMesh.device_mesh"))
    path, fn = _RT002_REDISTRIBUTE
    allowed = ctx.rel_endswith(path)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr == "redistribute" \
                and isinstance(ctx.parent.get(node), ast.Call) \
                and ctx.parent[node].func is node:
            if allowed and ctx.enclosing_function(node) == fn:
                continue
            out.append(LintFinding(
                "RT002", ctx.path, node.lineno, node.col_offset,
                "DTensor.redistribute outside runtime/constraint.py::"
                "replicate — it moves data by a collective the ledger does "
                "not see; spell the move as constraint.layout_cast, which "
                "runs it through runtime/collectives.py"))
    return out


# ---------------------------------------------------------------------------
# RT003 — explicit mirror= on layout transitions in engine code
# ---------------------------------------------------------------------------

#: Transitions whose backward the caller declares with mirror=.
MIRROR_REQUIRED = frozenset({
    "repro_torch.runtime.constraint.layout_cast",
    "repro_torch.runtime.constraint.note_transition",
})

_RT003_SEGMENTS = ("core", "gnn", "nn")


@file_rule("RT003", "error",
           "layout_cast / note_transition calls in engine code (core/, "
           "gnn/, nn/) declare mirror= explicitly — whether autograd runs "
           "the transition's backward (True) or the moved data carries no "
           "gradient (False)")
def _rt003(ctx: _FileContext) -> list[LintFinding]:
    if not ctx.path_has_segment(*_RT003_SEGMENTS) or \
            ctx.path_has_segment("runtime"):
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fq = ctx.resolve(node.func)
        if fq not in MIRROR_REQUIRED:
            continue
        if any(kw.arg == "mirror" for kw in node.keywords):
            continue
        short = fq.rsplit(".", 1)[1]
        out.append(LintFinding(
            "RT003", ctx.path, node.lineno, node.col_offset,
            f"{short}(...) without an explicit mirror= — declare whether "
            f"autograd runs this transition's backward (mirror=True) or "
            f"the moved data carries no gradient (mirror=False, checked "
            f"when it runs)"))
    return out


# ---------------------------------------------------------------------------
# RT005 — init_process_group and the env contract only in
# runtime/distributed.py
# ---------------------------------------------------------------------------

#: The launcher env contract (runtime/distributed.py constants).
MULTIHOST_ENV = frozenset({
    "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
    "DIST_INIT_TIMEOUT",
})

_RT005_ALLOWED = "runtime/distributed.py"


def _const_str(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


@file_rule("RT005", "error",
           "init_process_group and reads of the COORDINATOR_ADDRESS/"
           "NUM_PROCESSES/PROCESS_ID/DIST_INIT_TIMEOUT env contract happen "
           "only in runtime/distributed.py (one validated entry)")
def _rt005(ctx: _FileContext) -> list[LintFinding]:
    if ctx.rel_endswith(_RT005_ALLOWED):
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            fq = ctx.resolve(node.func)
            if fq and fq.startswith("torch.distributed.") and \
                    fq.endswith(".init_process_group"):
                out.append(LintFinding(
                    "RT005", ctx.path, node.lineno, node.col_offset,
                    f"direct {fq} — use repro_torch.runtime.distributed."
                    f"initialize (eager validation, actionable errors, "
                    f"idempotence)"))
                continue
            if fq in ("os.environ.get", "os.getenv") and node.args:
                key = _const_str(node.args[0])
                if key in MULTIHOST_ENV:
                    out.append(LintFinding(
                        "RT005", ctx.path, node.lineno, node.col_offset,
                        f"reading {key} from the environment — the "
                        f"multihost env contract is owned by "
                        f"repro_torch.runtime.distributed (use "
                        f"env_topology())"))
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load):
            if ctx.resolve(node.value) == "os.environ":
                key = _const_str(getattr(node, "slice", None))
                if key in MULTIHOST_ENV:
                    out.append(LintFinding(
                        "RT005", ctx.path, node.lineno, node.col_offset,
                        f"reading os.environ[{key!r}] — use "
                        f"repro_torch.runtime.distributed.env_topology()"))
    return out


# ---------------------------------------------------------------------------
# W100 — stubs referenced only from their own package (tree rule)
# ---------------------------------------------------------------------------

def _watched_stub(ctx: _FileContext) -> bool:
    if ctx.module is None:
        return False
    if ctx.module.startswith("repro_torch.configs.") and \
            not ctx.module.endswith("__init__"):
        return True
    return ctx.module == "repro_torch.serve.engine"


@tree_rule("W100", "warn",
           "stub modules (configs/* LM configs, serve/engine) referenced "
           "only from their own package — tracked dead code")
def _w100(ctxs: list[_FileContext]) -> list[LintFinding]:
    watched = {c.module: c for c in ctxs if _watched_stub(c)}
    if not watched:
        return []
    referenced: set[str] = set()
    for ctx in ctxs:
        for mod in watched:
            if ctx.module == mod:
                continue
            pkg = mod.rsplit(".", 1)[0]
            if ctx.package == pkg or ctx.module == pkg:
                continue        # its own package (registry re-exports)
            for target in ctx.aliases.values():
                if target == mod or target.startswith(mod + "."):
                    referenced.add(mod)
                    break
    out = []
    for mod, ctx in sorted(watched.items()):
        if mod in referenced:
            continue
        out.append(LintFinding(
            "W100", ctx.path, 1, 0,
            f"stub {mod} is referenced only from its own package — "
            f"tracked dead code", severity="warn"))
    return out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def iter_py_files(paths) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__",))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def _run_file_rules(ctx: _FileContext) -> list[LintFinding]:
    out = []
    for rule in FILE_RULES:
        for f in rule.fn(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    return out


def lint_text(text: str, path: str = "<memory>",
              module: str | None = None) -> list[LintFinding]:
    """Lint one in-memory source file (file-level rules only).  ``path``
    places it for the path-scoped rules (``src/repro_torch/core/x.py``)."""
    return _run_file_rules(_FileContext(path, text, module=module))


def lint_paths(paths) -> list[LintFinding]:
    """Lint files and directory trees; runs file- and tree-level rules.
    Unparseable files produce an E999 error finding instead of raising."""
    ctxs, findings = [], []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        try:
            ctxs.append(_FileContext(path, text))
        except SyntaxError as e:
            findings.append(LintFinding(
                "E999", path, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}"))
    for ctx in ctxs:
        findings.extend(_run_file_rules(ctx))
    for rule in TREE_RULES:
        findings.extend(rule.fn(ctxs))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
