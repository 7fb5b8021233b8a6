"""The launch tools' tables, knobs and production mesh against the JAX
package's, and the dry-run's command line at full size.

* ``derive_terms`` equal to the reference's on one census under the
  reference's own peaks (the port carries the H100's alone).
* ``report.py``'s two tables, its notes and its ``main`` equal to the
  reference's on the same records: records of each dominant term and each
  note, and a record of the port's own dry-run.
* ``sweep_opt``'s ``KNOBS`` and ``knobs_for``, and the dry-run's
  ``applicable``, equal to the reference's (read in a child).
* ``make_production_mesh`` at 256 and 512 fake ranks, and its refusal of a
  smaller world; the dry-run's refusals (a kernel config, a process that
  already has a default group).
* ``python -m repro_torch.launch.dryrun`` at full size on the single-pod
  production mesh (Granite-MoE-1B-A400M, decode_32k: 256 fake ranks, about
  20 s): a record with the reference's keys, whose ``argument_bytes`` is
  the sum of the rank's parameter and cache shards' bytes, reckoned here
  from the specs alone."""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.launch import dryrun, report, roofline, sweep_opt
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TT
from repro_torch.nn import param as tparam
from repro_torch.params import tree_leaves
from repro_torch.runtime.distributed import fake_world
from repro_torch.sharding import specs as tspecs
from torch_lm_cases import _MOE, _tiny

ROOT = Path(__file__).resolve().parents[1]
REF_PEAKS = roofline.Peaks(jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
RECORD_KEYS = {"arch", "shape", "mesh", "strategy", "variant", "knobs",
               "chips", "compile_seconds", "memory", "cost", "collectives",
               "roofline", "params_total", "params_active"}


def _census(flops, nbytes, coll):
    c = {k: float(coll.get(k, 0.0)) for k in KINDS}
    c["total"] = sum(c.values())
    c["counts"] = {k: float(bool(c[k])) for k in KINDS}
    return {"flops": flops, "bytes": nbytes, "collectives": c}


# (arch, shape, mesh, census): one record per dominant term and note
CASES = [
    ("qwen1.5-4b", "train_4k", "16x16", _census(4e14, 1e12, {})),
    ("gemma2-9b", "prefill_32k", "16x16", _census(1e12, 9e12, {})),
    ("mamba2-1.3b", "decode_32k", "16x16", _census(1e9, 8e10, {})),
    ("minitron-8b", "long_500k", "2x16x16", _census(1e9, 8e10, {})),
    ("zamba2-2.7b", "train_4k", "16x16",
     _census(1e12, 1e11, {"all-gather": 9e11, "all-reduce": 2e11})),
    ("deepseek-v2-lite-16b", "prefill_32k", "2x16x16",
     _census(1e12, 1e11, {"all-to-all": 5e11, "reduce-scatter": 1e11})),
    ("granite-moe-1b-a400m", "train_4k", "2x16x16",
     _census(2e13, 5e12, {"all-reduce": 1e11})),
]


def _record(arch, shape, mesh, census, model_flops, derive):
    terms = derive(arch, shape, mesh, 512 if mesh == "2x16x16" else 256,
                   census, model_flops)
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "strategy": "neutron_tp", "variant": "baseline", "knobs": {},
            "chips": terms.chips, "compile_seconds": 1.5,
            "memory": {"argument_bytes": 2 ** 30, "output_bytes": 0,
                       "temp_bytes": 2 ** 31, "peak_bytes": 3 * 2 ** 30},
            "cost": {}, "collectives": census["collectives"],
            "roofline": terms.as_dict(), "params_total": 1,
            "params_active": 1}


@pytest.fixture(scope="module")
def records():
    """The records under the reference's peaks, from both packages'
    ``derive_terms`` (equal: held below), and one record of the port's
    dry-run (tiny MoE, training on (data 2, model 2))."""
    out = []
    for i, (arch, shape, mesh, census) in enumerate(CASES):
        mf = 1e15 * (i + 1)
        out.append(_record(arch, shape, mesh, census, mf,
                           lambda *a: roofline.derive_terms(
                               *a, peaks=REF_PEAKS)))
    cfg = _tiny(**_MOE)
    shape = dataclasses.replace(configs.get_shape("train_4k"),
                                global_batch=4, seq_len=32)
    out.append(dryrun.run_combo(cfg, shape, mesh_shape=dict(model=2, data=2),
                                mixing="a2a", moe="ep"))
    return out


def test_derive_terms_matches_reference():
    for arch, shape, mesh, census in CASES:
        got = roofline.derive_terms(arch, shape, mesh, 256, census, 3e15,
                                    peaks=REF_PEAKS).as_dict()
        want = jroof.derive_terms(arch, shape, mesh, 256, census,
                                  3e15).as_dict()
        assert got == want, arch
    doms = {roofline.derive_terms(*c[:3], 256, c[3], 1.0,
                                  peaks=REF_PEAKS).dominant for c in CASES}
    assert doms == {"compute", "memory", "collective"}


@pytest.mark.parametrize("table", ["roofline_table", "dryrun_table"])
def test_report_tables_match_reference(records, table):
    for kw in ({}, {"mesh": "2x16x16"}, {"mesh": "2x2"}) \
            if table == "roofline_table" else ({},):
        got = getattr(report, table)(records, **kw)
        assert got == getattr(jreport, table)(records, **kw), kw
        assert got.count("\n") >= 2


def test_notes_and_formats_match_reference(records):
    notes = {report._note(r) for r in records}
    assert notes == {jreport._note(r) for r in records}
    assert len(notes) >= 5, notes
    for r in records:
        assert report._note(r) == jreport._note(r)
    for v in (0, 1.5e-7, 3.0, 2.0 ** 33):
        assert report.fmt_s(v) == jreport.fmt_s(v)
        assert report.fmt_bytes(v) == jreport.fmt_bytes(v)


def test_load_records_and_main_match_reference(records, tmp_path,
                                               monkeypatch):
    for i, r in enumerate(records):
        (tmp_path / f"r{i:02d}.json").write_text(json.dumps(r))
    assert report.load_records(str(tmp_path)) == \
        jreport.load_records(str(tmp_path))
    outs = []
    for mod in (report, jreport):
        monkeypatch.setattr(sys, "argv", ["report", "--in", str(tmp_path)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_sweep_knobs_and_applicable_match_reference():
    """The reference's knobs and ``applicable`` read in a child: importing
    its sweep (or its dry-run) sets a 512-device ``XLA_FLAGS`` for the
    process."""
    code = ("import json; from repro.launch import sweep_opt as s; "
            "from repro.configs import list_archs; "
            "print(json.dumps([s.KNOBS, {n: s.knobs_for(n) for n in "
            "s.INPUT_SHAPES}, {a + '/' + n: s.applicable(a, n) "
            "for a in list_archs() for n in s.INPUT_SHAPES}]))")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    knobs, by_shape, applicable = json.loads(out.stdout)
    assert sweep_opt.KNOBS == knobs
    assert {f"{a}/{n}": dryrun.applicable(a, n)
            for a in configs.list_archs()
            for n in configs.INPUT_SHAPES} == applicable
    assert {n: sweep_opt.knobs_for(n) for n in configs.INPUT_SHAPES} == \
        by_shape


def test_production_mesh_and_refusals():
    """(data 16, model 16) over 256 ranks and (pod 2, data 16, model 16)
    over 512, rank 0's groups; a smaller world raises as the reference's
    does; the dry-run refuses a kernel config and a process that holds a
    default group."""
    for multi, world, shape in ((False, 256, {"model": 16, "data": 16}),
                                (True, 512, {"model": 16, "pod": 2,
                                             "data": 16})):
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi)
            assert mesh.shape == shape and mesh.index == 0
            assert mesh.data_axes == (("pod", "data") if multi
                                      else ("data",))
        with fake_world(world // 2), pytest.raises(
                ValueError, match=f"production mesh needs {world} devices"):
            make_production_mesh(multi_pod=multi)
    cfg = dataclasses.replace(_tiny(), attn_impl="flash")
    with pytest.raises(ValueError, match="traces no kernel"):
        dryrun.lower_combo(cfg, "decode_32k", mesh_shape=dict(model=2))
    with fake_world(2), pytest.raises(RuntimeError, match="default process"):
        dryrun.lower_combo(_tiny(), "decode_32k", mesh_shape=dict(model=2))


def _shard_bytes(spec, shape, dtype_bytes, mesh_shape) -> int:
    n = math.prod(shape)
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n //= mesh_shape[a]
    return n * dtype_bytes


def test_dryrun_cli_at_full_size(tmp_path):
    arch, shape = "granite-moe-1b-a400m", "decode_32k"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(tmp_path)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    (path,) = tmp_path.glob("*.json")
    assert path.name == f"{arch}__{shape}__16x16__neutron_tp.json"
    rec = json.loads(path.read_text())
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed",
                                "transcendentals"}
    assert set(rec["collectives"]) == set(KINDS) | {"total", "counts"}
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    # the rank's shards, from the specs alone
    cfg = configs.get_config(arch)
    mesh_shape = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=mesh_shape)
    rules = tspecs.ShardingRules()
    specs = rules.param_shardings(tparam.param_names(cfg),
                                  tparam.param_shapes(cfg), mesh)
    meta = TT.init_transformer(cfg, device="meta")
    want = sum(tree_leaves(tspecs._map2(
        lambda sp, t: _shard_bytes(sp, tuple(t.shape), t.element_size(),
                                   mesh_shape), specs, meta)))
    b, s = configs.get_shape(shape).global_batch, \
        configs.get_shape(shape).seq_len
    like = TT.init_caches(cfg, b, s, dtype=TT.compute_dtype(cfg),
                          device="meta")
    cspecs = tspecs.cache_shardings(rules, mesh, like)
    leaves = []
    tspecs._map_caches(lambda name, t, sp: leaves.append(
        _shard_bytes(sp, tuple(t.shape), t.element_size(), mesh_shape))
        if hasattr(t, "shape") else None, like, cspecs)
    want += sum(leaves)
    assert rec["memory"]["argument_bytes"] == want
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["model_flops"] == roofline.model_flops_for(
        cfg, configs.get_shape(shape))
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
