"""The explicit sharder's collectives against the JAX package's, and the
sharded step's audit, at four gloo ranks on (data=1, model=4) and
(data=2, model=2).

* **Ledger.** The all-to-all, all-gather and ppermute entries of one
  training step (remat off, as the reference's own check) of the
  explicit mixing and ``ep_moe`` cases equal the reference
  ``ExplicitSharder``'s ledger of its traced step, taken in a JAX child
  with four forced host devices, scaled by the two stated departures:
  the port records each repeat of a repeated layer group, where the
  reference traces its layer scan's body once (R× its entries, R the
  repeats); and the port's ring skips the last rotation, whose chunk no
  step uses ((n − 1)/n of its ppermutes).  The port's other
  entries are its stated departures too (``runtime/telemetry.py``): the
  parameter gathers (``param_gather``), the loss and load-balance sums
  (``psum``) and the gradient sums (``grad_psum``).
* **Audit.** ``analysis/audit.py``'s census of a sharded step under
  remat (the checkpoint reruns each unit's collectives, recorded as
  recomputed calls) is clean against its ledger: all-to-alls, parameter
  gathers and their gloo all-reduce mirrors, the ring's sends and
  receives.
* **Linter.** ``scripts/lint_dist_torch.py`` is clean on the port.

One spawn of four ranks for the file, beside the JAX child."""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import audit
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.runtime import telemetry as tT
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.explicit import ExplicitSharder
from repro_torch.train import make_grad_fn
from test_torch_lm_shard import MESHES, case_batch, case_cfg

ROOT = Path(__file__).resolve().parents[1]
EXPLICIT = ("gqa-kv-a2a", "gqa-kv-gather", "gqa-blockwise", "ring-attn",
            "ring-gqa-window", "moe-ep")
AUDITED = ("ring-attn", "moe-ep")     # repeated groups: checkpointed
HELD_OPS = ("all_to_all", "all_gather", "ppermute")
TIMEOUT = datetime.timedelta(seconds=120)


def _reference_child(out: str) -> None:
    """Four forced host devices: the reference ``ExplicitSharder``'s
    ledger of each case's traced value-and-grad, as JSON."""
    import numpy as np
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import transformer as JT
    from repro.runtime import telemetry as jT
    from repro.sharding.explicit import ExplicitSharder as JExplicit
    from repro.sharding.specs import ShardingRules as JRules
    from repro_torch.params import to_numpy_tree
    assert len(jax.devices()) == 4
    res = {}
    for mesh_name, shape in MESHES.items():
        mesh = jmesh(**shape)
        sharder = JExplicit(mesh=mesh, rules=JRules())
        for case in EXPLICIT:
            cfg = case_cfg(case, shape["model"])
            jcfg = JArchConfig(**dataclasses.asdict(cfg))
            params = to_numpy_tree(TT.init_transformer(cfg, device="cpu"))
            batch = case_batch(cfg)

            def loss(p, jcfg=jcfg, batch=batch):
                logits, aux = JT.forward(p, jcfg, batch["tokens"],
                                         shard=sharder, remat=False)
                return JT.lm_loss(logits, batch["targets"]) + 0.01 * aux
            with mesh, jT.collect_comm() as ledger:
                jax.jit(jax.value_and_grad(loss)).lower(params)
            res[f"{mesh_name}/{case}"] = ledger.as_dict()
    del np
    Path(out).write_text(json.dumps(res))


def _step(cfg, sharder, shards, batch, remat):
    return make_grad_fn(cfg, sharder, remat=remat)(shards, batch)[0]


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        res = {}
        for mesh_name, shape in MESHES.items():
            mesh = make_host_mesh(**shape)
            sharder = ExplicitSharder(mesh, tspecs.ShardingRules())
            for case in EXPLICIT:
                cfg = case_cfg(case, shape["model"])
                shards = tspecs.place_params(
                    TT.init_transformer(cfg, device="cpu"), cfg, sharder)
                batch = case_batch(cfg)
                with tT.collect_comm() as ledger:
                    _step(cfg, sharder, shards, batch, remat=False)
                res[f"{mesh_name}/{case}"] = ledger.as_dict()
                if case in AUDITED:
                    with tT.collect_comm() as ledger:
                        _, cen = audit.census(_step, cfg, sharder, shards,
                                              batch, True)
                    res[f"{mesh_name}/{case}/audit"] = [
                        f.format() for f in audit.audit(cen, ledger)]
                    res[f"{mesh_name}/{case}/census"] = cen.as_dict()
                    res[f"{mesh_name}/{case}/remat"] = ledger.as_dict()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    world, tmp = 4, tmp_path_factory.mktemp("ledger")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_lm_shard_ledger as t; "
            "t._reference_child({!r})").format(
                str(ROOT / "tests"), str(ROOT / "src"), str(tmp / "ref.json"))
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
    _, err = child.communicate(timeout=180)
    assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world
    return (json.loads((tmp / "ref.json").read_text()),
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])


@pytest.mark.parametrize("case", EXPLICIT)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_explicit_ledger_matches_reference(ledgers, mesh_name, case):
    ref, ranks = ledgers
    want = ref[f"{mesh_name}/{case}"]
    n = MESHES[mesh_name]["model"]
    (group,) = TB.layer_groups(case_cfg(case, n))
    assert want, "the reference traced no explicit collective"
    for got in ranks:
        got = got[f"{mesh_name}/{case}"]
        held = {k: v for k, v in got.items() if k.split("|")[0] in HELD_OPS}
        assert set(held) == set(want), (sorted(held), sorted(want))
        for key, entry in want.items():
            scale = group.repeats * (
                (n - 1) / n if key.startswith("ppermute|") else 1.0)
            assert held[key] == {f: v * scale for f, v in entry.items()}, key
        departures = {k.split("|")[0] for k in got} - set(HELD_OPS)
        assert departures == {"param_gather", "psum", "grad_psum"}, got


@pytest.mark.parametrize("case", AUDITED)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_step_audit_clean(ledgers, mesh_name, case):
    """The remat step's census is clean against its ledger; the ledger
    counts the checkpoint's reruns as recomputed calls (every forward
    all-to-all and parameter gather of the repeated units runs twice)."""
    _, ranks = ledgers
    for got in ranks:
        assert got[f"{mesh_name}/{case}/audit"] == [], \
            got[f"{mesh_name}/{case}/census"]
        plain = got[f"{mesh_name}/{case}"]
        remat = got[f"{mesh_name}/{case}/remat"]
        assert set(remat) == set(plain)
        for key, entry in remat.items():
            assert entry["calls"] == plain[key]["calls"], key
            assert entry["mirrored_calls"] == plain[key]["mirrored_calls"]
        for op in ("param_gather", "ppermute" if case.startswith("ring")
                   else "all_to_all"):
            key = f"{op}|model|float32"
            assert remat[key].get("recomputed_calls", 0) > 0, key
        census = got[f"{mesh_name}/{case}/census"]
        if case.startswith("ring"):
            assert census.get("send|float32|forward", 0) > 0, census
            assert census.get("recv|float32|backward", 0) > 0, census


def test_linter_clean_on_the_port():
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "lint_dist_torch.py")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert " 0 error(s)" in out.stdout
