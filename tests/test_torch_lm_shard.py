"""The sharded LM forward and gradients at four gloo ranks against the JAX
package's unsharded oracle, on (data=1, model=4) and (data=2, model=2).

The cases are the reference's ``tests/dist_progs/check_explicit_collectives
.py`` (gqa-kv-a2a, gqa-kv-gather, gqa-blockwise, ring-attn,
ring-gqa-window, moe-ep), their head counts chosen per model degree so
that each branch of the explicit mixing is taken at model = 4 and at
model = 2, and beside them: Zamba2 reduced (mamba2 + shared attention) at
S/m < ssm_chunk, where the causal conv needs the previous shard's tail
(without the halo the loss moves: the test shows it), DeepSeek reduced
(MLA + MoE), InternVL2 reduced behind its prefix, the plain ``Sharder``
(MoE dispatched globally, heads that do not divide gathered), the
``dp`` strategy, and each of ``ExplicitSharder``'s three flags turned off.

Weights come from the port's ``init_transformer`` and reach the reference
as numpy.  Each case's loss (loss + 0.01·aux) and every gradient leaf
(the ranks' shards reduced and gathered whole) are held at the
reference's bars (loss rtol/atol 2e-5, gradients rtol 5e-4, atol 5e-5)
against ``jax.value_and_grad`` of the reference's unsharded loss on one
CPU device, and the loss against the port's unsharded loss within 1e-5.
The branch each case took is read from its collective ledger (forward,
backward and the gradients' reduction).  One spawn
of four ranks for the file; torch on one intra-op thread."""
import dataclasses
import datetime
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import ArchConfig as JArchConfig
from repro.train import loop as jloop
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TT
from repro_torch.params import to_numpy_tree, tree_leaves
from repro_torch.runtime import telemetry as tT
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding.explicit import ExplicitSharder
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import make_grad_fn, make_loss_fn
from torch_lm_cases import _MOE, _reduced, _tiny

MESHES = {"1x4": dict(model=4, data=1), "2x2": dict(model=2, data=2)}
BATCH, SEQ = 2, 32
LOSS_TOL, GRAD_RTOL, GRAD_ATOL, PORT_TOL = 2e-5, 5e-4, 5e-5, 1e-5
TIMEOUT = datetime.timedelta(seconds=120)


def case_cfg(case: str, m: int) -> ArchConfig:
    """The case's config at model degree ``m`` (4 or 2): at m = 2 the
    kv-gather case is MQA and the ring cases have 3 q heads, so that the
    same branch is taken."""
    two = m == 2
    return {
        "gqa-kv-a2a": lambda: _tiny(),
        "gqa-kv-gather": lambda: _tiny(num_kv_heads=1 if two else 2),
        "gqa-blockwise": lambda: _tiny(attn_impl="blockwise",
                                       attn_block_q=8, attn_block_kv=16),
        "ring-attn": lambda: _tiny(num_heads=3 if two else 6,
                                   num_kv_heads=3 if two else 6, d_model=48),
        "ring-gqa-window": lambda: _tiny(
            num_heads=3 if two else 6, num_kv_heads=1 if two else 2,
            d_model=48, sliding_window=24, local_global_pattern=True),
        "moe-ep": lambda: _tiny(**_MOE),
        "mamba-halo": lambda: _reduced("zamba2-2.7b"),
        "mla": lambda: _reduced("deepseek-v2-lite-16b",
                                moe_capacity_factor=8.0),
        "vlm-prefix": lambda: _reduced("internvl2-1b"),
        "plain-moe": lambda: _tiny(**_MOE),
        "plain-ring": lambda: _tiny(num_heads=3 if two else 6,
                                    num_kv_heads=3 if two else 6,
                                    d_model=48),
        "dp": lambda: _tiny(**_MOE),
        "no-a2a-mixing": lambda: case_cfg("ring-attn", m),
        "no-ring": lambda: case_cfg("ring-attn", m),
        "no-ep-moe": lambda: _tiny(**_MOE),
    }[case]()


# case → (sharder, the ledger keys its branch must show, keys it must not)
CASES = {
    "gqa-kv-a2a": ("explicit", ["all_to_all|model"], ["all_gather|model"]),
    "gqa-kv-gather": ("explicit", ["all_gather|model", "all_to_all|model"],
                      ["ppermute"]),
    "gqa-blockwise": ("explicit", ["all_to_all|model"], ["all_gather|model"]),
    "ring-attn": ("explicit", ["ppermute|model"], ["all_to_all"]),
    "ring-gqa-window": ("explicit", ["ppermute|model"], ["all_to_all"]),
    "moe-ep": ("explicit", ["all_to_all|model"], ["all_gather|model"]),
    "mamba-halo": ("explicit", ["ppermute|model", "all_to_all|model",
                                "all_gather|model"], []),
    "mla": ("explicit", ["all_to_all|model"], ["all_gather|model"]),
    "vlm-prefix": ("explicit", ["all_to_all|model"], []),
    "plain-moe": ("plain", ["all_gather|model|int64", "all_to_all|model"],
                  []),
    "plain-ring": ("plain", ["all_gather|model"], ["ppermute",
                                                   "all_to_all"]),
    # dp: nothing moves over the model axis but the gradients' sum over
    # its replicas (grad_psum|model)
    "dp": ("dp", ["all_gather|data|int64", "grad_psum|model"],
           ["all_gather|model", "param_gather|model", "all_to_all",
            "ppermute"]),
    # each ExplicitSharder flag off: its mechanism gives way to the plain
    # path (the mixing's off takes the ring with it)
    "no-a2a-mixing": ("use_a2a_mixing", ["all_gather|model"],
                      ["ppermute", "all_to_all"]),
    "no-ring": ("use_ring", ["all_gather|model"], ["ppermute",
                                                   "all_to_all"]),
    "no-ep-moe": ("use_ep_moe", ["all_gather|model|int64",
                                 "all_to_all|model"], []),
}


def case_batch(cfg: ArchConfig) -> dict:
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.modality:
        batch["prefix"] = rng.standard_normal(
            (BATCH, cfg.num_prefix_embeddings, cfg.d_model), np.float32)
    return batch


def _sharder(kind: str, mesh):
    if kind == "explicit":
        return ExplicitSharder(mesh, tspecs.ShardingRules())
    if kind.startswith("use_"):       # the explicit sharder, one flag off
        return ExplicitSharder(mesh, tspecs.ShardingRules(), **{kind: False})
    return tspecs.Sharder(mesh, tspecs.ShardingRules(
        "dp" if kind == "dp" else "neutron_tp"))


def _sharded_value_and_grad(cfg, sharder, params, batch):
    shards = tspecs.place_params(params, cfg, sharder)
    with tT.collect_comm() as ledger:
        grads, (total, _, _) = make_grad_fn(cfg, sharder)(shards, batch)
    whole = tspecs.gather_params(grads, cfg, sharder)
    return float(total), [g.numpy() for g in tree_leaves(whole)], ledger


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        for mesh_name, shape in MESHES.items():
            mesh = make_host_mesh(**shape)
            for case, (kind, _, _) in CASES.items():
                cfg = case_cfg(case, shape["model"])
                params = TT.init_transformer(cfg, seed=0, device="cpu")
                batch = case_batch(cfg)
                sharder = _sharder(kind, mesh)
                total, grads, ledger = _sharded_value_and_grad(
                    cfg, sharder, params, batch)
                res = {"loss": total, "keys": sorted(ledger.as_dict())}
                if case == "mamba-halo":
                    # without the halo the shard boundaries are wrong
                    tspecs.Sharder.halo, keep = (
                        lambda self, x, k: torch.nn.functional.pad(
                            x, (0, 0, k, 0))), tspecs.Sharder.halo
                    try:
                        res["no_halo_loss"] = float(make_loss_fn(
                            cfg, sharder)(tspecs.place_params(
                                params, cfg, sharder), batch)[0])
                    finally:
                        tspecs.Sharder.halo = keep
                    # scoring: forward(shard=) under no_grad, gathered
                    with torch.no_grad():
                        logits, aux = TT.forward(
                            tspecs.place_params(params, cfg, sharder), cfg,
                            torch.as_tensor(batch["tokens"]), shard=sharder)
                        res["logits"] = sharder.bound(BATCH, SEQ).unshard(
                            logits).tolist()
                if rank == 0:
                    np.savez(Path(out_dir) / f"{mesh_name}-{case}.npz",
                             *grads)
                    (Path(out_dir) / f"{mesh_name}-{case}.json").write_text(
                        json.dumps(res))
    finally:
        dist.destroy_process_group()


def _reference(cfg: ArchConfig, params, batch):
    """The reference's unsharded (total, grads) on one CPU device."""
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    loss_fn = jloop.make_loss_fn(jcfg, None, remat=False)
    (total, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_numpy_tree(params), batch)
    return float(total), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One spawn for the file: the four ranks run every case on both
    meshes while this process computes the references."""
    world, tmp = 4, tmp_path_factory.mktemp("shard")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ref, by_cfg = {}, {}
    try:
        for mesh_name, shape in MESHES.items():
            for case in CASES:
                cfg = case_cfg(case, shape["model"])
                params = TT.init_transformer(cfg, seed=0, device="cpu")
                batch = case_batch(cfg)
                if cfg not in by_cfg:       # the cases share configs
                    by_cfg[cfg] = (_reference(cfg, params, batch), float(
                        make_loss_fn(cfg, remat=False)(params, batch)[0]))
                out = dict(zip(("ref", "port"), by_cfg[cfg]))
                if case == "mamba-halo":
                    with torch.no_grad():
                        out["logits"] = TT.forward(
                            params, cfg, torch.as_tensor(batch["tokens"]))[0]
                ref[(mesh_name, case)] = out
    finally:
        torch.set_num_threads(n)
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    got = {}
    for mesh_name in MESHES:
        for case in CASES:
            stem = tmp / f"{mesh_name}-{case}"
            npz = np.load(f"{stem}.npz")
            got[(mesh_name, case)] = (
                json.loads(Path(f"{stem}.json").read_text()),
                [npz[f"arr_{i}"] for i in range(len(npz.files))])
    return ref, got


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_loss_and_grads_match_reference(results, mesh_name, case):
    ref, got = results
    want = ref[(mesh_name, case)]
    res, grads = got[(mesh_name, case)]
    ref_total, ref_grads = want["ref"]
    np.testing.assert_allclose(res["loss"], ref_total, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert abs(res["loss"] - want["port"]) <= PORT_TOL * max(
        1.0, abs(want["port"]))
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _, present, absent = CASES[case]
    keys = "\n".join(res["keys"])
    for k in present:
        assert k in keys, (k, res["keys"])
    for k in absent:
        assert k not in keys, (k, res["keys"])


@pytest.mark.parametrize("mesh_name", MESHES)
def test_conv_halo_and_scoring_forward(results, mesh_name):
    """Zamba2 reduced (S/m < ssm_chunk at model = 4): the conv without the
    previous shard's tail gives another loss; ``forward(shard=)`` under
    no_grad, gathered, equals the unsharded logits."""
    ref, got = results
    res, _ = got[(mesh_name, "mamba-halo")]
    m = MESHES[mesh_name]["model"]
    cfg = case_cfg("mamba-halo", m)
    assert m != 4 or SEQ // m < cfg.ssm_chunk
    ref_total = ref[(mesh_name, "mamba-halo")]["ref"][0]
    assert abs(res["no_halo_loss"] - ref_total) > 10 * LOSS_TOL
    want = ref[(mesh_name, "mamba-halo")]["logits"]
    got_logits = torch.tensor(res["logits"])
    assert got_logits.shape == want.shape
    err = (got_logits - want).abs().max().item()
    assert err <= PORT_TOL * max(1.0, want.abs().max().item()), err
