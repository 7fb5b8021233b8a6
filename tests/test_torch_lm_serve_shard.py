"""Sharded LM serving at four gloo ranks against the JAX package's sharded
serving, on (data=1, model=4), (data=2, model=2) and (pod=2, data=1,
model=2).

Each case runs ``make_serve_fns(cfg, sharder)`` of both packages on the
same weights (the port's ``init_transformer``, handed to the reference as
numpy) and prompt: the reference's closures jitted under its ``Sharder`` or
``ExplicitSharder`` in a JAX child with four forced host devices (its
explicit sharder refuses a batch of 1 on a data axis of 2, so there the
port's explicit sharder is held to its plain one), the port's per-rank
program on four gloo ranks.  Held within 1e-5 absolute
(fp32): the prefill logits (the ranks' blocks gathered), the caches after
prefill (``gather_caches``) and ``STEPS`` greedy decode steps' logits; and
the greedy tokens identical to the port's unsharded serving.

The cases cover every block and cache kind (dense, MoE with ``ep_moe`` in
prefill and the dropless dispatch in decode, gemma2-like local/global with
window and softcaps on the ring cache at ``long_context``, MLA, mamba2 with
zamba2's shared attention), heads that divide the model axis, kv heads
that do not (the GQA gather) and heads that do not at all (ring attention),
each ``seq_shard_cache`` layout (True at batch 1 on a data axis of 2, and
on the pod mesh over both data axes), the plain ``Sharder`` and the ``dp``
strategy (with the latent cache's ``dp`` + ``"model"`` quirk).

Beside them, the decode step's ledger: one step's entries equal at two
``max_len`` values in each layout (no cache is gathered; the split
softmax gathers partials whose size does not depend on it), serving's own
op kinds where they belong, and ``analysis/audit.py`` clean on a sharded
decode step.  One spawn of four ranks for the file, beside the JAX
child."""
import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import audit
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.runtime import telemetry as tT
from repro_torch.serve import make_serve_fns
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.explicit import ExplicitSharder
from torch_lm_cases import (_MOE, _cache_leaves, _greedy, _plain_step,
                            _reduced, _snapshot, _tiny)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x4": dict(model=4, data=1), "2x2": dict(model=2, data=2),
          "pod": dict(model=2, data=1, pod=2)}
SEQ, STEPS, EXTRA = 24, 4, 4
TOL = 1e-5
REF_CHILDREN = 2
TIMEOUT = datetime.timedelta(seconds=120)

CONFIGS = {
    "gqa": lambda: _tiny(),
    # 2 kv heads: gathered in the explicit prefill at model 4, the cache
    # replicated over the model axis under False
    "kv2": lambda: _tiny(num_kv_heads=2),
    # 6 heads on 4 ranks: ring attention in prefill
    "ring": lambda: _tiny(num_heads=6, num_kv_heads=6, d_model=48),
    "gemma": lambda: _tiny(num_layers=4, num_heads=6, num_kv_heads=2,
                           d_model=48, sliding_window=12,
                           local_global_pattern=True, attn_softcap=20.0,
                           logit_softcap=30.0, post_norm=True),
    "mla": lambda: _reduced("deepseek-v2-lite-16b", moe_capacity_factor=8.0),
    "zamba": lambda: _reduced("zamba2-2.7b"),
    "moe": lambda: _tiny(**_MOE),
}

# name → (mesh, config, sharder, seq_shard_cache, batch, long_context)
CASES = {
    "1x4/gqa/False": ("1x4", "gqa", "explicit", False, 2, False),
    "1x4/gqa/model": ("1x4", "gqa", "explicit", "model", 2, False),
    "1x4/kv2/False": ("1x4", "kv2", "explicit", False, 2, False),
    "1x4/ring/model": ("1x4", "ring", "explicit", "model", 2, False),
    "1x4/ring/False": ("1x4", "ring", "explicit", False, 2, False),
    "1x4/gemma/False": ("1x4", "gemma", "explicit", False, 2, True),
    "1x4/gemma/model": ("1x4", "gemma", "explicit", "model", 2, True),
    "1x4/mla/False": ("1x4", "mla", "explicit", False, 2, False),
    "1x4/mla/model": ("1x4", "mla", "explicit", "model", 2, False),
    "1x4/zamba/False": ("1x4", "zamba", "explicit", False, 2, False),
    "1x4/zamba/model": ("1x4", "zamba", "explicit", "model", 2, False),
    "1x4/moe/False": ("1x4", "moe", "explicit", False, 2, False),
    "1x4/plain-moe/model": ("1x4", "moe", "plain", "model", 2, False),
    "1x4/plain-ring/False": ("1x4", "ring", "plain", False, 2, False),
    "1x4/dp-mla/model": ("1x4", "mla", "dp", "model", 2, False),
    "2x2/gqa/True": ("2x2", "gqa", "explicit", True, 1, False),
    "2x2/gemma/True": ("2x2", "gemma", "explicit", True, 1, True),
    "2x2/mla/True": ("2x2", "mla", "explicit", True, 1, False),
    "2x2/zamba/model": ("2x2", "zamba", "explicit", "model", 2, False),
    "2x2/moe/False": ("2x2", "moe", "explicit", False, 2, False),
    "2x2/dp-gqa/True": ("2x2", "gqa", "dp", True, 1, False),
    "pod/gqa/True": ("pod", "gqa", "explicit", True, 1, False),
}
# cases whose decode step's ledger is taken at a second max_len
LEDGERED = ("1x4/gqa/False", "1x4/gqa/model", "1x4/gemma/model",
            "1x4/mla/model", "1x4/zamba/model", "2x2/gqa/True",
            "2x2/mla/True")
AUDITED = ("1x4/zamba/model", "2x2/mla/True")


def _data_axes(mesh_name):
    return ("pod", "data") if mesh_name == "pod" else ("data",)


def case_setup(name):
    """(cfg, params, prompt, max_len) of a case."""
    mesh_name, cfg_name, _, _, batch, _ = CASES[name]
    cfg = CONFIGS[cfg_name]()
    params = TT.init_transformer(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(sorted(CASES).index(name))
    prompt = rng.integers(0, cfg.vocab_size, (batch, SEQ), dtype=np.int32)
    return cfg, params, prompt, SEQ + STEPS + EXTRA


def _sharder(kind, ssc, mesh, mesh_name):
    rules = tspecs.ShardingRules("dp" if kind == "dp" else "neutron_tp",
                                 data_axes=_data_axes(mesh_name),
                                 seq_shard_cache=ssc)
    if kind == "explicit":
        return ExplicitSharder(mesh, rules)
    return tspecs.Sharder(mesh, rules)


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        meshes = {k: make_host_mesh(**v) for k, v in MESHES.items()}
        res = {}
        for name, (mesh_name, _, kind, ssc, batch, lc) in CASES.items():
            cfg, params, prompt, max_len = case_setup(name)
            mesh = meshes[mesh_name]
            sharder = _sharder(kind, ssc, mesh, mesh_name)
            shards = tspecs.place_params(params, cfg, sharder)
            prefill_fn, decode_fn = make_serve_fns(cfg, sharder,
                                                   long_context=lc)
            ledgers = {}

            def step(fn, p, tok, caches, ledgers=ledgers):
                with tT.collect_comm() as led:
                    out = fn(p, tok, caches)
                ledgers.setdefault("decode", led.as_dict())
                return out

            def last(logits, s, b=batch, sharder=sharder):
                return sharder.bound(b, s).unshard(logits)

            with torch.no_grad(), tT.collect_comm() as pre_led:
                first, caches0, steps, toks = _greedy(
                    prefill_fn, decode_fn, shards, torch.as_tensor(prompt),
                    max_len, last, step, STEPS)
                like = TT.init_caches(cfg, batch, max_len, device="meta",
                                      long_context=lc)
                whole = tspecs.gather_caches(caches0, like, sharder)
                placed = tspecs.place_caches(whole, sharder)
            out = {"prefill_keys": sorted(pre_led.as_dict()),
                   "decode": ledgers["decode"],
                   "tokens": [t.tolist() for t in toks],
                   "placed": all(
                       torch.equal(a, b) if torch.is_tensor(a) else a == b
                       for a, b in zip(_cache_leaves(placed),
                                       _cache_leaves(caches0)))}
            if name in LEDGERED:
                with torch.no_grad():
                    _, caches = prefill_fn(shards, torch.as_tensor(prompt),
                                           max_len=max_len + 40)
                    with tT.collect_comm() as led:
                        decode_fn(shards, toks[0][:, None], caches)
                out["decode_long"] = led.as_dict()
            if name in AUDITED:
                with torch.no_grad():
                    _, caches = prefill_fn(shards, torch.as_tensor(prompt),
                                           max_len=max_len)
                    with tT.collect_comm() as led:
                        _, cen = audit.census(decode_fn, shards,
                                              toks[0][:, None], caches)
                out["audit"] = [f.format() for f in audit.audit(cen, led)]
                out["census"] = cen.as_dict()
            if rank == 0:
                tag = name.replace("/", "_")
                np.savez(Path(out_dir) / f"{tag}.npz", first.numpy(),
                         *[s.numpy() for s in steps],
                         *[t.numpy() if torch.is_tensor(t) else np.asarray(t)
                           for t in _cache_leaves(whole)])
            res[name] = out
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _reference_child(out_dir: str, part: int, parts: int) -> None:
    """Four forced host devices: the reference's sharded serving (jitted
    prefill and decode) of every ``parts``-th case from ``part``, as npz
    files."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.serve.engine import make_serve_fns as jserve
    from repro.sharding.explicit import ExplicitSharder as JExplicit
    from repro.sharding.specs import Sharder as JSharder
    from repro.sharding.specs import ShardingRules as JRules
    from repro_torch.params import to_numpy_tree
    assert len(jax.devices()) == 4
    meshes = {k: jmesh(**v) for k, v in MESHES.items()}
    for name in list(CASES)[part::parts]:
        mesh_name, _, kind, ssc, batch, lc = CASES[name]
        cfg, params, prompt, max_len = case_setup(name)
        jcfg = JArchConfig(**dataclasses.asdict(cfg))
        mesh = meshes[mesh_name]
        rules = JRules("dp" if kind == "dp" else "neutron_tp",
                       data_axes=_data_axes(mesh_name), seq_shard_cache=ssc)
        # the reference's explicit sharder refuses a batch that its data
        # axes do not divide (its shard_map's in_specs): there the port's
        # explicit sharder is held to the reference's plain one
        explicit = kind == "explicit" and batch % math.prod(
            mesh.shape[a] for a in _data_axes(mesh_name)) == 0
        sharder = (JExplicit if explicit else JSharder)(mesh=mesh,
                                                         rules=rules)
        prefill_fn, decode_fn = jserve(jcfg, sharder, long_context=lc)
        p = to_numpy_tree(params)
        with mesh:
            pre = jax.jit(lambda p, t, f=prefill_fn, m=max_len: f(
                p, t, max_len=m))
            dec = jax.jit(decode_fn)
            logits, caches = pre(p, jnp.asarray(prompt))
            leaves = [np.asarray(x) for x in jax.tree.leaves(caches)]
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            steps = []
            for _ in range(STEPS):
                out, caches = dec(p, tok, caches)
                steps.append(np.asarray(out))
                tok = jnp.argmax(out[:, -1], -1)[:, None].astype(jnp.int32)
        np.savez(Path(out_dir) / f"ref_{name.replace('/', '_')}.npz",
                 np.asarray(logits), *steps, *leaves)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawn for the file: the four ranks run every case while two
    JAX children run the reference's (each compiles half the cases) and
    this process the port's unsharded serving."""
    world, tmp = 4, tmp_path_factory.mktemp("serve_shard")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false"}
    children = []
    for part in range(REF_CHILDREN):
        code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
                "import test_torch_lm_serve_shard as t; "
                "t._reference_child({!r}, {}, {})").format(
                    str(ROOT / "tests"), str(ROOT / "src"), str(tmp), part,
                    REF_CHILDREN)
        children.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    unsharded = {}
    try:
        for name, (_, _, _, _, _, lc) in CASES.items():
            cfg, params, prompt, max_len = case_setup(name)
            prefill_fn, decode_fn = make_serve_fns(cfg, long_context=lc)
            with torch.no_grad():
                toks = _greedy(prefill_fn, decode_fn, params,
                               torch.as_tensor(prompt), max_len,
                               lambda x, s: x, _plain_step, STEPS)[3]
            unsharded[name] = [t.tolist() for t in toks]
    finally:
        torch.set_num_threads(n)
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    for child in children:
        _, err = child.communicate(timeout=240)
        assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)]

    def arrays(stem):
        npz = np.load(tmp / f"{stem}.npz")
        return [npz[f"arr_{i}"] for i in range(len(npz.files))]
    got = {name: arrays(name.replace("/", "_")) for name in CASES}
    ref = {name: arrays("ref_" + name.replace("/", "_")) for name in CASES}
    return got, ref, ranks, unsharded


def _held(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("name", CASES)
def test_prefill_logits_match_reference(results, name):
    got, ref, _, _ = results
    _held(got[name][0], ref[name][0], "prefill logits")


@pytest.mark.parametrize("name", CASES)
def test_prefill_caches_match_reference(results, name):
    got, ref, _, _ = results
    g, r = got[name][1 + STEPS:], ref[name][1 + STEPS:]
    assert len(g) == len(r)
    for i, (a, b) in enumerate(zip(g, r)):
        if a.ndim == 0:     # a length: the reference stacks one a repeat
            assert (b == a).all(), (i, a, b)
            continue
        _held(a, b, f"cache leaf {i}")


@pytest.mark.parametrize("name", CASES)
def test_decode_logits_match_reference(results, name):
    got, ref, _, _ = results
    for i in range(STEPS):
        _held(got[name][1 + i], ref[name][1 + i], f"decode step {i}")


@pytest.mark.parametrize("name", CASES)
def test_greedy_tokens_equal_unsharded(results, name):
    """Every rank's greedy tokens are the port's unsharded serving's."""
    _, _, ranks, unsharded = results
    for r in ranks:
        assert r[name]["tokens"] == unsharded[name]


@pytest.mark.parametrize("name", CASES)
def test_serving_ledger_ops(results, name):
    """Prefill places its caches from the sequence-sharded prompt
    (``cache_place``; under ``dp`` the prompt's layout is the caches' up
    to a slice) and a decode step does not; a decode step gathers
    split-softmax partials where a cache's sequence is split, and a mamba2
    conv output where its channels are; under ``dp`` nothing moves over
    the model axis but the sums."""
    _, _, ranks, _ = results
    mesh_name, cfg_name, kind, ssc, _, _ = CASES[name]
    for r in ranks:
        pre, dec = r[name]["prefill_keys"], r[name]["decode"]
        assert any(k.startswith("cache_place|") for k in pre) == (
            kind != "dp"), pre
        assert not any(k.startswith("cache_place|") for k in dec), dec
        soft = any(k.startswith("softmax_gather|") for k in dec)
        assert soft == (ssc is not False and not (
            kind == "dp" and ssc == "model")), (name, sorted(dec))
        conv = any(k.startswith("conv_gather|model") for k in dec)
        assert conv == (cfg_name == "zamba"), sorted(dec)
        if kind == "dp":
            assert not any("|model" in k for k in dec
                           if not k.startswith(("psum", "softmax"))), dec


@pytest.mark.parametrize("name", CASES)
def test_place_caches_inverts_gather(results, name):
    """``place_caches`` of the gathered caches gives every rank its shards
    back, as prefill laid them out."""
    _, _, ranks, _ = results
    assert all(r[name]["placed"] for r in ranks)


@pytest.mark.parametrize("name", LEDGERED)
def test_decode_bytes_do_not_depend_on_max_len(results, name):
    """One decode step's ledger is the same at max_len and max_len + 40:
    no cache is gathered."""
    _, _, ranks, _ = results
    for r in ranks:
        assert r[name]["decode_long"] == r[name]["decode"]


@pytest.mark.parametrize("name", AUDITED)
def test_sharded_decode_step_audit_clean(results, name):
    _, _, ranks, _ = results
    for r in ranks:
        assert r[name]["audit"] == [], r[name]["census"]
