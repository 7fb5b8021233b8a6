"""The megatron strategy's serving at four gloo ranks against the JAX
package's megatron serving, on (data=1, model=4), (data=2, model=2) and
(pod=2, data=1, model=2), in the three ``seq_shard_cache`` layouts.

Four configs: a tiny GQA (heads and kv heads split), gemma2-like
(local/global layers with window and softcaps on ring caches at
``long_context``; its 6 heads do not divide 4, so at model 4 the whole
attention is replicated, at model 2 it splits), DeepSeek reduced (MLA,
MoE with the dropless decode dispatch) and Zamba2 reduced (mamba2's
caches, and the shared attention block whose 2 kv heads do not divide
4).  Weights are the port's ``init_transformer``, handed to the
reference as numpy.  The reference's ``make_serve_fns(cfg,
Sharder(mesh, ShardingRules("megatron", seq_shard_cache=...)))`` is
jitted once per (config, layout), in one JAX child with four forced host
devices, on (1, 4) at batch 2 and on (2, 2) at batch 1 for the layout
True (its value does not depend on the mesh); each port case is held to
its (config, layout) within 1e-5·max(1, max|ref|): the prefill logits
(the ranks' blocks gathered), the caches after prefill
(``gather_caches``) and ``STEPS`` greedy decode steps; and its greedy
tokens are the port's unsharded serving's.

The ledger: no parameter is gathered over the model axis in a prefill or
a decode step; a decode step's row-parallel sums (``tp_psum|model``) are
``test_torch_lm_megatron.tp_psums``; a decode step's ledger is the same at
two ``max_len``; ``analysis/audit.py`` is clean on a decode step.  One
spawn of four ranks for the file beside the JAX child; JAX is imported in
the child alone."""
import datetime
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import audit
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.params import to_numpy_tree
from repro_torch.runtime import telemetry as tT
from repro_torch.serve import make_serve_fns
from repro_torch.sharding import specs as tspecs
import jax_lm_refs
from test_torch_lm_megatron import MESHES, tp_psums
from torch_lm_cases import _cache_leaves, _greedy, _plain_step, _reduced, _tiny

SEQ, STEPS, EXTRA = 24, 4, 4
TOL = 1e-5
TIMEOUT = datetime.timedelta(seconds=120)

CONFIGS = {
    "gqa": lambda: _tiny(),
    "gemma": lambda: _tiny(num_layers=4, num_heads=6, num_kv_heads=2,
                           d_model=48, sliding_window=12,
                           local_global_pattern=True, attn_softcap=20.0,
                           logit_softcap=30.0, post_norm=True),
    "mla": lambda: _reduced("deepseek-v2-lite-16b", moe_capacity_factor=8.0),
    "zamba": lambda: _reduced("zamba2-2.7b"),
}
LONG_CONTEXT = {"gemma"}
LAYOUTS = {"False": False, "model": "model", "True": True}
# the reference's mesh and batch in each layout
REF = {"False": ("1x4", 2), "model": ("1x4", 2), "True": ("2x2", 1)}

# case name → (mesh, config, layout)
CASES = {f"{m}/{c}/{lay}": (m, c, lay) for m, c, lay in (
    ("1x4", "gqa", "False"), ("1x4", "gqa", "model"),
    ("2x2", "gqa", "True"), ("pod", "gqa", "True"),
    ("1x4", "gemma", "False"), ("1x4", "gemma", "model"),
    ("2x2", "gemma", "model"), ("2x2", "gemma", "True"),
    ("1x4", "mla", "False"), ("1x4", "mla", "model"),
    ("pod", "mla", "model"), ("2x2", "mla", "True"),
    ("1x4", "zamba", "False"), ("1x4", "zamba", "model"),
    ("2x2", "zamba", "model"), ("pod", "zamba", "True"))}
REFS = sorted({(c, lay) for _, c, lay in CASES.values()})
LEDGERED = ("1x4/gqa/model", "2x2/gemma/True", "1x4/mla/model",
            "1x4/zamba/False")
AUDITED = ("1x4/zamba/model", "2x2/mla/True")


def _data_axes(mesh_name):
    return ("pod", "data") if mesh_name == "pod" else ("data",)


def setup(cfg_name, layout):
    """(cfg, params, prompt, max_len) of a (config, layout)."""
    cfg = CONFIGS[cfg_name]()
    params = TT.init_transformer(cfg, seed=0, device="cpu")
    batch = REF[layout][1]
    rng = np.random.default_rng(sorted(CONFIGS).index(cfg_name))
    prompt = rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)
    return cfg, params, prompt[:batch], SEQ + STEPS + EXTRA


def _sharder(mesh, mesh_name, layout):
    return tspecs.Sharder(mesh, tspecs.ShardingRules(
        "megatron", data_axes=_data_axes(mesh_name),
        seq_shard_cache=LAYOUTS[layout]))


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        meshes = {k: make_host_mesh(**v) for k, v in MESHES.items()}
        res = {}
        for name, (mesh_name, cfg_name, layout) in CASES.items():
            cfg, params, prompt, max_len = setup(cfg_name, layout)
            batch = prompt.shape[0]
            lc = cfg_name in LONG_CONTEXT
            sharder = _sharder(meshes[mesh_name], mesh_name, layout)
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
            out = {"prefill": sorted(pre_led.as_dict()),
                   "decode": ledgers["decode"],
                   "tokens": [t.tolist() for t in toks]}
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
                np.savez(Path(out_dir) / f"{name.replace('/', '_')}.npz",
                         first.numpy(), *[s.numpy() for s in steps],
                         *[t.numpy() if torch.is_tensor(t) else np.asarray(t)
                           for t in _cache_leaves(whole)])
            res[name] = out
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _reference_jobs() -> list:
    """The JAX child's jobs (``jax_lm_refs``): the reference's megatron
    serving of every (config, layout) on ``REF``'s mesh."""
    jobs = []
    for cfg_name, layout in REFS:
        cfg, params, prompt, max_len = setup(cfg_name, layout)
        mesh_name = REF[layout][0]
        jobs.append(jax_lm_refs.job(
            "serving", f"{cfg_name}_{layout}", cfg, to_numpy_tree(params),
            MESHES[mesh_name], _data_axes(mesh_name),
            seq_shard_cache=LAYOUTS[layout], prompt=prompt,
            max_len=max_len, steps=STEPS,
            long_context=cfg_name in LONG_CONTEXT))
    return jobs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawn for the file: the four ranks run every case while the
    JAX child runs the reference's and this process the port's unsharded
    serving."""
    world, tmp = 4, tmp_path_factory.mktemp("megatron_serve")
    child = jax_lm_refs.start(_reference_jobs(), tmp)
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
        for cfg_name, layout in REFS:
            cfg, params, prompt, max_len = setup(cfg_name, layout)
            prefill_fn, decode_fn = make_serve_fns(
                cfg, long_context=cfg_name in LONG_CONTEXT)
            with torch.no_grad():
                toks = _greedy(prefill_fn, decode_fn, params,
                               torch.as_tensor(prompt), max_len,
                               lambda x, s: x, _plain_step, STEPS)[3]
            unsharded[(cfg_name, layout)] = [t.tolist() for t in toks]
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
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)]

    def arrays(stem):
        npz = np.load(tmp / f"{stem}.npz")
        return [npz[f"arr_{i}"] for i in range(len(npz.files))]
    got = {name: arrays(name.replace("/", "_")) for name in CASES}
    ref = {k: arrays(f"ref_{k[0]}_{k[1]}") for k in REFS}
    return got, ref, ranks, unsharded


def _held(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _ref(name):
    _, cfg_name, layout = CASES[name]
    return cfg_name, layout


@pytest.mark.parametrize("name", CASES)
def test_prefill_logits_match_reference(results, name):
    got, ref, _, _ = results
    _held(got[name][0], ref[_ref(name)][0], "prefill logits")


@pytest.mark.parametrize("name", CASES)
def test_prefill_caches_match_reference(results, name):
    got, ref, _, _ = results
    g, r = got[name][1 + STEPS:], ref[_ref(name)][1 + STEPS:]
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
        _held(got[name][1 + i], ref[_ref(name)][1 + i], f"decode step {i}")


@pytest.mark.parametrize("name", CASES)
def test_greedy_tokens_equal_unsharded(results, name):
    _, _, ranks, unsharded = results
    for r in ranks:
        assert r[name]["tokens"] == unsharded[_ref(name)]


@pytest.mark.parametrize("name", CASES)
def test_serving_ledger_row_parallel_sums(results, name):
    """No ``param_gather`` over the model axis in a prefill or a decode
    step, and a decode step's ``tp_psum|model`` calls are
    ``tp_psums``."""
    _, _, ranks, _ = results
    mesh_name, cfg_name, _ = CASES[name]
    want = tp_psums(CONFIGS[cfg_name](), MESHES[mesh_name]["model"])
    for r in ranks:
        pre, dec = r[name]["prefill"], r[name]["decode"]
        assert not any(k.startswith("param_gather|model")
                       for k in pre + list(dec)), (pre, sorted(dec))
        assert sum(v["calls"] for k, v in dec.items()
                   if k.startswith("tp_psum|model")) == want, sorted(dec)


@pytest.mark.parametrize("name", LEDGERED)
def test_decode_bytes_do_not_depend_on_max_len(results, name):
    _, _, ranks, _ = results
    for r in ranks:
        assert r[name]["decode_long"] == r[name]["decode"]


@pytest.mark.parametrize("name", AUDITED)
def test_megatron_decode_step_audit_clean(results, name):
    _, _, ranks, _ = results
    for r in ranks:
        assert r[name]["audit"] == [], r[name]["census"]
