"""The dry-run's collective ledger against the JAX package's dry-run and
against the port's own program run for real, on (data=2, model=2) and
(pod=2, data=1, model=2).

Each case is one combination of ``launch/dryrun.py``: a config (a tiny
GQA, one with 2 kv heads, a tiny MoE, Zamba2 and DeepSeek-V2-Lite
reduced), a kind (a training step, a prefill, a decode step, at small
shapes), a strategy (neutron_tp, megatron) and the reference's knobs
(``mixing="a2a"``, ``moe="ep"``, ``logits_last``, ``cache_seq``,
``remat``).

* **Against the reference.**  The port's dry-run (rank 0 of four on the
  fake backend, in this process) against the reference's own
  ``lower_combo`` traced on four forced host devices in a JAX child, its
  production mesh and config lookup pointed at the case's (the reference
  records its explicit sharder's collectives while it traces).  The
  all-to-all, all-gather and ppermute entries are held equal, scaled by
  the two stated departures of ``tests/torch_lm_shard_ledger_cases.py``:
  the port records each repeat of a repeated layer group (R× the
  reference's traced scan body) and its ring skips the last rotation.
  The reference declares each explicit collective's mirror as it traces,
  a forward-only prefill too; the port records a mirror when a backward
  runs it, so a prefill's and a decode step's mirrored counters are 0.
  Where the reference records nothing (the plain sharder, megatron, a
  decode step: the partitioner's moves), every port entry is one of its
  stated departures (``runtime/telemetry.py``) or one of the plain
  sharder's transitions.
* **Fake against real.**  Four gloo ranks run each case's program
  (``dryrun.program``) on real weights: rank 0's ledger equals the
  dry-run's, entry for entry, and so do the argument bytes.  For the
  ``logits_last`` cases, the sharded ``last_only`` prefill of a random
  prompt, its logits gathered, equals the last position of the unsharded
  prefill within 1e-5·max(1, max|ref|) (on the pod mesh the sequence is
  split over the model axis, so the final position comes from the last
  model rank: ``Sharder.last_position``).

One spawn of four ranks for the file, beside one JAX child."""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.runtime import telemetry as tT
from repro_torch.serve import make_serve_fns
from repro_torch.sharding.specs import place_params
from torch_lm_cases import _MOE, _reduced, _tiny

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = datetime.timedelta(seconds=120)
CONFIGS = {
    "gqa": lambda: _tiny(),
    "kv2": lambda: _tiny(num_kv_heads=2),
    "moe": lambda: _tiny(**_MOE),
    "zamba": lambda: _reduced("zamba2-2.7b"),
    "mla": lambda: _reduced("deepseek-v2-lite-16b", moe_capacity_factor=8.0),
}
SHAPES = {"train": InputShape("train_4k", 32, 4, "train"),
          "prefill": InputShape("prefill_32k", 32, 4, "prefill"),
          "decode": InputShape("decode_32k", 64, 4, "decode")}
MESHES = {"2x2": dict(model=2, data=2), "pod": dict(model=2, data=1, pod=2)}
# name → (config, kind, mesh, strategy, knobs)
CASES = {
    "gqa-train-a2a": ("gqa", "train", "2x2", "neutron_tp",
                      dict(mixing="a2a", moe="ep")),
    "moe-train-ep": ("moe", "train", "pod", "neutron_tp",
                     dict(mixing="a2a", moe="ep", remat="none")),
    "mla-prefill-ep": ("mla", "prefill", "2x2", "neutron_tp",
                       dict(mixing="a2a", moe="ep", logits_last=True)),
    "kv2-prefill-seq": ("kv2", "prefill", "pod", "neutron_tp",
                        dict(mixing="a2a", cache_seq="model",
                             logits_last=True)),
    "moe-train-plain": ("moe", "train", "2x2", "neutron_tp", {}),
    "moe-decode": ("moe", "decode", "2x2", "neutron_tp", {}),
    "zamba-train-plain": ("zamba", "train", "pod", "neutron_tp", {}),
    "zamba-decode-megatron": ("zamba", "decode", "2x2", "megatron", {}),
    "gqa-train-megatron": ("gqa", "train", "pod", "megatron", {}),
    "mla-train-megatron": ("mla", "train", "2x2", "megatron",
                           dict(remat="none")),
}
EXPLICIT = ("gqa-train-a2a", "moe-train-ep", "mla-prefill-ep",
            "kv2-prefill-seq")
HELD_OPS = ("all_to_all", "all_gather", "ppermute")
DEPARTURES = {"param_gather", "psum", "grad_psum", "cache_place",
              "softmax_gather", "conv_gather", "last_gather", "tp_psum",
              "tp_gather"}
FIELDS = ("calls", "payload_bytes", "wire_bytes", "mirrored_calls",
          "mirrored_wire_bytes")


def _knobs(knobs: dict) -> dict:
    return {**knobs, "remat": knobs.get("remat", "full")}


def _reference_child(out: str) -> None:
    """The reference's ``lower_combo`` of each case, its mesh four forced
    host devices and its config the case's, traced (not compiled) inside
    a collecting ledger; the ledgers as JSON."""
    import repro.launch.dryrun as jd
    # importing the reference's dry-run sets 512 forced devices; four do
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax
    import jax.stages
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.configs.base import InputShape as JInputShape
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.runtime import telemetry as jT
    assert len(jax.devices()) == 4
    jax.stages.Lowered.compile = lambda self, *a, **k: None
    res = {}
    for name, (c, kind, m, strategy, knobs) in CASES.items():
        jcfg = JArchConfig(**dataclasses.asdict(CONFIGS[c]()))
        shape = SHAPES[kind]
        jd.get_config = lambda arch, jcfg=jcfg: jcfg
        jd.INPUT_SHAPES = {shape.name: JInputShape(
            **dataclasses.asdict(shape))}
        jd.make_production_mesh = lambda multi_pod, m=m: jmesh(**MESHES[m])
        with jT.collect_comm() as ledger:
            jd.lower_combo(name, shape.name, multi_pod=False,
                           strategy=strategy, **_knobs(knobs))
        res[name] = ledger.as_dict()
    Path(out).write_text(json.dumps(res))


def _prompt(cfg, shape) -> torch.Tensor:
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        shape.global_batch, shape.seq_len)), dtype=torch.int32)


def _last_only(cfg, shape, mesh, strategy, knobs) -> list:
    """The case's sharded ``last_only`` prefill of a random prompt, its
    logits gathered whole."""
    sharder = dryrun.sharder_for(
        mesh, strategy=strategy, seq_cache=knobs.get("cache_seq") or False,
        mixing=knobs.get("mixing", "constraint"), moe=knobs.get("moe", "spmd"))
    prefill_fn, _ = make_serve_fns(cfg, sharder, last_only=True)
    shards = place_params(TT.init_transformer(cfg, seed=0, device="cpu"),
                          cfg, sharder)
    with torch.no_grad():
        logits, _ = prefill_fn(shards, _prompt(cfg, shape),
                               max_len=shape.seq_len + 1)
    return sharder.bound(shape.global_batch, 1).unshard(logits).tolist()


def _port_rank(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        meshes = {k: make_host_mesh(**v) for k, v in MESHES.items()}
        res = {}
        for name, (c, kind, m, strategy, knobs) in CASES.items():
            cfg = CONFIGS[c]()
            args, run = dryrun.program(
                cfg, SHAPES[kind], meshes[m], strategy=strategy,
                params=TT.init_transformer(cfg, seed=0, device="cpu"),
                **_knobs(knobs))
            with tT.collect_comm() as ledger:
                result = run()
            res[name] = {"ledger": ledger.as_dict(), "argument_bytes": sum(
                t.numel() * t.element_size() for t in args)}
            if knobs.get("logits_last"):
                res[name]["last"] = _last_only(cfg, SHAPES[kind], meshes[m],
                                               strategy, knobs)
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX child and the four gloo ranks run while this process runs
    the port's dry-run of every case."""
    world, tmp = 4, tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_launch_dryrun as t; "
            "t._reference_child({!r})").format(
                str(ROOT / "tests"), str(ROOT / "src"), str(tmp / "ref.json"))
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous",
                               tmp / "real.json"))
             for r in range(world)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fake = {}
        for name, (c, kind, m, strategy, knobs) in CASES.items():
            run = dryrun.lower_combo(CONFIGS[c](), SHAPES[kind],
                                     mesh_shape=MESHES[m],
                                     strategy=strategy, **_knobs(knobs))
            fake[name] = {"ledger": run["ledger"].as_dict(),
                          "argument_bytes": run["memory"]["argument_bytes"],
                          "mesh": run["mesh"], "chips": run["chips"]}
    finally:
        torch.set_num_threads(n)
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    _, err = child.communicate(timeout=240)
    assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world
    return (fake, json.loads((tmp / "ref.json").read_text()),
            json.loads((tmp / "real.json").read_text()))


def _repeats(cfg) -> int:
    (group,) = {g.repeats for g in TB.layer_groups(cfg)} or {1}
    return group


@pytest.mark.parametrize("name", CASES)
def test_dryrun_ledger_matches_reference(results, name):
    fake, ref, _ = results
    c, kind, m, _, _ = CASES[name]
    got, want = fake[name]["ledger"], ref[name]
    assert fake[name]["mesh"] == ("2x2" if m == "2x2" else "2x1x2")
    assert fake[name]["chips"] == 4
    held = {k: v for k, v in got.items() if k.split("|")[0] in HELD_OPS}
    if name not in EXPLICIT:
        assert want == {}, want
        assert {k.split("|")[0] for k in got} <= DEPARTURES | set(HELD_OPS)
        return
    assert want, "the reference traced no explicit collective"
    assert set(held) == set(want), (sorted(held), sorted(want))
    r, n = _repeats(CONFIGS[c]()), MESHES[m]["model"]
    for key, entry in want.items():
        scale = r * ((n - 1) / n if key.startswith("ppermute|") else 1.0)
        for f in FIELDS:
            w = entry[f] * scale
            if f.startswith("mirrored") and kind != "train":
                w = 0.0
            assert held[key][f] == w, (key, f, held[key][f], w)
    assert {k.split("|")[0] for k in got} - set(HELD_OPS) <= DEPARTURES


def test_sharded_last_only_logits_equal_unsharded(results):
    """The ``logits_last`` cases' sharded prefill of a random prompt at
    four ranks: the final position's logits, gathered, equal the
    unsharded prefill's last position (and differ from its first)."""
    _, _, real = results
    names = [n for n, case in CASES.items() if case[4].get("logits_last")]
    assert names
    for name in names:
        c, kind, _, _, _ = CASES[name]
        cfg, shape = CONFIGS[c](), SHAPES[kind]
        with torch.no_grad():
            full, _ = TT.prefill(TT.init_transformer(cfg, seed=0,
                                                     device="cpu"),
                                 cfg, _prompt(cfg, shape),
                                 max_len=shape.seq_len + 1)
        got = torch.tensor(real[name]["last"])
        want = full[:, -1:]
        assert got.shape == want.shape, name
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item()), (name, err)
        assert (full[:, :1] - want).abs().max().item() > 1e-3, name


def test_dryrun_equals_the_real_four_rank_run(results):
    """Rank 0 of four gloo ranks running each case's program on real
    weights: the same ledger, entry for entry, and the same argument
    bytes as the dry-run's."""
    fake, _, real = results
    assert set(real) == set(CASES)
    for name in CASES:
        assert real[name]["ledger"] == fake[name]["ledger"], name
        assert real[name]["argument_bytes"] == \
            fake[name]["argument_bytes"], name
