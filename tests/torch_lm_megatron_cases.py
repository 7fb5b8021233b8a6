"""The megatron strategy's training at four gloo ranks against the JAX
package's megatron, on (data=1, model=4), (data=2, model=2) and (pod=2,
data=1, model=2).

Six configs: a tiny GQA (8 heads), one with 2 kv heads (the kv heads do
not divide the model axis at 4: the rank slices its q heads' kv groups),
one with 3 heads (they divide no axis: the whole attention replicated),
a tiny MoE (shared experts), Zamba2 reduced (mamba2's fused projection
and conv over a split axis, the gated norm's sum) and DeepSeek reduced
(MLA, MoE).  Weights come from the port's ``init_transformer`` and reach
the reference as numpy.  The reference's ``make_loss_fn(cfg,
Sharder(mesh, ShardingRules("megatron")))`` is jitted once per config, in
one JAX child with four forced host devices, on the mesh of
:data:`REF_MESH` (its value does not depend on the mesh: GSPMD), and every
mesh's port run is held to it within 1e-5·max(1, |ref|): the loss, the
MoE aux loss and every gradient leaf (the ranks' shards reduced and
gathered whole).  Two ``sharded_setup`` AdamW steps of Granite-MoE reduced
on (2, 2) are held to the reference's jitted megatron step.

The ledger of each step: no parameter is gathered over the model axis
(``param_gather|model``: a leaf keeps its model shard where the axis
divides it and is replicated where it does not), and the row-parallel
sums (``tp_psum|model``) are :func:`tp_psums` a forward, each mirrored in
the backward; one step per mesh kind is audited (``analysis/audit.py``).
``ExplicitSharder``'s explicit mixing and expert-parallel MoE decline under
megatron, as the reference's do, so its forward is ``Sharder``'s.

The configs are spread over ``tests/test_torch_lm_megatron_*.py``
(``tests/torch_split.py``), each config the reference jits in one file:
each file runs its own (``CFGS``; with ``WITH_STEP``, the explicit
sharder's check and the AdamW steps too) in one spawn of four ranks beside
the JAX child; JAX is imported in the child alone."""
import dataclasses
import datetime
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.analysis import audit
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.params import to_numpy_tree, tree_leaves
from repro_torch.runtime import telemetry as tT
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.explicit import ExplicitSharder
from repro_torch.train import (init_sharded_state, make_grad_fn,
                               sharded_setup)
import jax_lm_refs
from torch_lm_cases import _MOE, _reduced, _tiny

MESHES = {"1x4": dict(model=4, data=1), "2x2": dict(model=2, data=2),
          "pod": dict(model=2, data=1, pod=2)}
BATCH, SEQ = 2, 32
TOL = 1e-5
LR = 1e-3
TIMEOUT = datetime.timedelta(seconds=120)

CONFIGS = {
    "gqa": lambda: _tiny(),
    "kv2": lambda: _tiny(num_kv_heads=2),
    "h3": lambda: _tiny(num_heads=3, num_kv_heads=3, d_model=48),
    "moe": lambda: _tiny(**_MOE),
    "zamba": lambda: _reduced("zamba2-2.7b"),
    "mla": lambda: _reduced("deepseek-v2-lite-16b", moe_capacity_factor=8.0),
}
# the mesh the reference runs each config on
REF_MESH = {"gqa": "1x4", "kv2": "1x4", "h3": "2x2", "moe": "pod",
            "zamba": "1x4", "mla": "2x2"}
CASES = [(m, c) for m in MESHES for c in CONFIGS]
AUDITED = (("1x4", "zamba"), ("2x2", "moe"), ("pod", "mla"))
STEP_ARCH = "granite-moe-1b-a400m"
STEP_MESH = "2x2"


def _data_axes(mesh_name):
    return ("pod", "data") if mesh_name == "pod" else ("data",)


def _rules(mesh_name):
    return tspecs.ShardingRules("megatron", data_axes=_data_axes(mesh_name))


def case_batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def tp_psums(cfg, n: int) -> int:
    """Row-parallel sums of one megatron forward (or decode step) at model
    degree ``n``: the vocab-split embedding's lookup; each attention
    layer's output projection (the shared block at each use) where the
    heads divide; each MLP's down projection where d_ff does; a MoE
    layer's routed combine where the experts divide and its shared
    experts' down projection where their width does; a mamba2 layer's
    gated-norm mean square where its heads divide and its out_proj where
    d_inner does."""
    def split(size):
        return int(size % n == 0)
    total = split(cfg.padded_vocab)
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            total += split(cfg.ssm_heads) + split(cfg.d_inner)
            continue
        total += split(cfg.num_heads)
        if kind == "moe":
            total += split(cfg.num_experts)
            if cfg.num_shared_experts:
                total += split(cfg.moe_d_ff * cfg.num_shared_experts)
        else:
            total += split(cfg.d_ff)
    return total


def _step_shape():
    shape = configs.get_shape("train_4k")
    return dataclasses.replace(shape, global_batch=2, seq_len=16)


def _step_batches(cfg):
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, seed=1).batches(2, 16, cfg)
    return [next(data) for _ in range(2)]


def _explicit_declines(mesh, out):
    """``ExplicitSharder``'s hooks under megatron: both decline (None),
    and its forward equals the plain sharder's, bitwise."""
    cfg = CONFIGS["moe"]()
    params = TT.init_transformer(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(case_batch(cfg)["tokens"])
    rules = _rules("1x4")
    ex = ExplicitSharder(mesh, rules).bound(BATCH, SEQ)
    q = torch.zeros(BATCH, SEQ, 2, 8)
    top = torch.zeros(BATCH, SEQ, 2, dtype=torch.long)
    out["declines"] = [ex.explicit_a2a(cfg, q, q, q) is None,
                       ex.ep_moe({}, cfg, torch.zeros(BATCH, SEQ, 64), top,
                                 top.float(), 1.0) is None]
    with torch.no_grad():
        logits = [TT.forward(tspecs.place_params(params, cfg, sh), cfg,
                             tokens, shard=sh)[0]
                  for sh in (tspecs.Sharder(mesh, rules),
                             ExplicitSharder(mesh, rules))]
    out["explicit_equal"] = bool(torch.equal(*logits))


def _port_rank(rank, world, init, out_dir, cfgs, with_step):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        res = {}
        meshes = {k: make_host_mesh(**v) for k, v in MESHES.items()}
        for mesh_name, cfg_name in CASES:
            if cfg_name not in cfgs:
                continue
            cfg = CONFIGS[cfg_name]()
            params = TT.init_transformer(cfg, seed=0, device="cpu")
            batch = case_batch(cfg)
            sharder = tspecs.Sharder(meshes[mesh_name], _rules(mesh_name))
            shards = tspecs.place_params(params, cfg, sharder)
            grad_fn = make_grad_fn(cfg, sharder)
            with tT.collect_comm() as led:
                if (mesh_name, cfg_name) in AUDITED:
                    (grads, (total, loss, aux)), cen = audit.census(
                        grad_fn, shards, batch)
                else:
                    grads, (total, loss, aux) = grad_fn(shards, batch)
            whole = tspecs.gather_params(grads, cfg, sharder)
            tag = f"{mesh_name}_{cfg_name}"
            out = {"total": float(total), "loss": float(loss),
                   "aux": float(aux), "ledger": led.as_dict()}
            if (mesh_name, cfg_name) in AUDITED:
                out["audit"] = [f.format() for f in audit.audit(cen, led)]
            if rank == 0:
                np.savez(Path(out_dir) / f"{tag}.npz",
                         *[g.numpy() for g in tree_leaves(whole)])
            res[tag] = out
        if not with_step:
            (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
            return
        _explicit_declines(meshes["1x4"], res)
        # two AdamW steps of sharded_setup's megatron step
        cfg = configs.get_config(STEP_ARCH + "-reduced")
        mesh = meshes[STEP_MESH]
        setup = sharded_setup(cfg, _step_shape(), mesh, _rules(STEP_MESH),
                              lr=LR)
        state = init_sharded_state(
            TT.init_transformer(cfg, seed=0, device="cpu"), cfg,
            setup["optimizer"], setup["sharder"])
        metrics = []
        for batch in _step_batches(cfg):
            state, m = setup["train_step"](state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        res["adamw"] = metrics
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _reference_jobs(cfgs, with_step) -> list:
    """The JAX child's jobs (``jax_lm_refs``): the megatron loss and
    gradients of each config of ``cfgs`` on its ``REF_MESH`` and, with
    ``with_step``, the two AdamW steps."""
    jobs = []
    for name in cfgs:
        cfg, mesh_name = CONFIGS[name](), REF_MESH[name]
        jobs.append(jax_lm_refs.job(
            "grads", name, cfg, to_numpy_tree(TT.init_transformer(
                cfg, seed=0, device="cpu")), MESHES[mesh_name],
            _data_axes(mesh_name), batch=case_batch(cfg)))
    if not with_step:
        return jobs
    cfg = configs.get_config(STEP_ARCH + "-reduced")
    jobs.append(jax_lm_refs.job(
        "adamw", "adamw", cfg, to_numpy_tree(TT.init_transformer(
            cfg, seed=0, device="cpu")), MESHES[STEP_MESH],
        _data_axes(STEP_MESH), shape=dataclasses.asdict(_step_shape()),
        lr=LR, batches=_step_batches(cfg)))
    return jobs


@pytest.fixture(scope="module")
def results(request, tmp_path_factory):
    """One spawn for the test file: the four ranks run its configs'
    cases (``CFGS``, and the step's with ``WITH_STEP``) while the JAX child
    runs the reference's."""
    cfgs = list(request.module.CFGS)
    with_step = getattr(request.module, "WITH_STEP", False)
    world, tmp = 4, tmp_path_factory.mktemp("megatron")
    child = jax_lm_refs.start(_reference_jobs(cfgs, with_step), tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", tmp, cfgs,
                               with_step))
             for r in range(world)]
    for p in procs:
        p.start()
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
    got = {f"{m}_{c}": arrays(f"{m}_{c}") for m, c in CASES if c in cfgs}
    ref = {c: arrays(f"ref_{c}") for c in cfgs}
    if with_step:
        ref["adamw"] = json.loads((tmp / "ref_adamw.json").read_text())
    return got, ref, ranks


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("mesh_name,cfg_name", CASES)
def test_loss_aux_and_grads_match_reference(results, mesh_name, cfg_name):
    got, ref, ranks = results
    tag = f"{mesh_name}_{cfg_name}"
    want = ref[cfg_name]
    for r in ranks:
        _held(r[tag]["total"], want[0], "total")
        _held(r[tag]["loss"], want[1], "loss")
        _held(r[tag]["aux"], want[2], "aux")
    assert len(got[tag]) == len(want) - 3
    for i, (g, w) in enumerate(zip(got[tag], want[3:])):
        _held(g, w, f"gradient leaf {i}")


@pytest.mark.parametrize("mesh_name,cfg_name", CASES)
def test_step_ledger_row_parallel_sums(results, mesh_name, cfg_name):
    """No ``param_gather`` over the model axis; ``tp_psum|model`` calls =
    :func:`tp_psums` forward and mirrored (the recompute of a checkpointed
    group reruns its own); the loss and the gradients' sums as under
    neutron_tp."""
    _, _, ranks = results
    n = MESHES[mesh_name]["model"]
    want = tp_psums(CONFIGS[cfg_name](), n)
    for r in ranks:
        led = r[f"{mesh_name}_{cfg_name}"]["ledger"]
        assert not any(k.startswith("param_gather|model") for k in led), \
            sorted(led)
        tp = led["tp_psum|model|float32"]
        assert tp["calls"] == tp["mirrored_calls"] == want, (tp, want)
        assert not any(k.startswith(("all_to_all", "ppermute"))
                       for k in led), sorted(led)


@pytest.mark.parametrize("mesh_name,cfg_name", AUDITED)
def test_megatron_step_audit_clean(results, mesh_name, cfg_name):
    _, _, ranks = results
    for r in ranks:
        assert r[f"{mesh_name}_{cfg_name}"]["audit"] == []


def test_explicit_sharder_declines_under_megatron(results):
    """The explicit hooks return None under megatron (the reference's
    ``_a2a_mixing`` and ``_ep_moe`` do for any strategy but neutron_tp),
    so ``ExplicitSharder``'s forward is ``Sharder``'s."""
    _, _, ranks = results
    for r in ranks:
        assert r["declines"] == [True, True]
        assert r["explicit_equal"]


def test_two_sharded_adamw_steps_match_reference(results):
    """Granite-MoE reduced, two AdamW steps of ``sharded_setup``'s
    megatron step on (2, 2) against the reference's jitted one."""
    _, ref, ranks = results
    for r in ranks:
        assert len(r["adamw"]) == len(ref["adamw"]) == 2
        for got, want in zip(r["adamw"], ref["adamw"]):
            assert sorted(got) == sorted(want)
            for key in want:
                _held(got[key], want[key], key)


def test_tp_psums_formula_at_full_size():
    """The formula at the full Zamba2-2.7B on four ranks: the embedding,
    45 mamba2 layers' two sums and the shared block's attention and MLP
    at each of its 9 uses."""
    cfg = configs.get_config("zamba2-2.7b")
    assert tp_psums(cfg, 4) == 1 + 45 * 2 + 9 * 2
