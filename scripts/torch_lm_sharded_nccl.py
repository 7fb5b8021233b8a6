#!/usr/bin/env python3
"""The LM's NeutronTP sharding on N GPUs of one machine, one process a card
over NCCL, on the mesh (data=1, model=N): what ``chip_smoke.py``'s phase
28 on one card cannot reach — the explicit sharder's all-to-alls, ring
attention and expert-parallel MoE with wire bytes.

    scripts/launch_multihost_torch.sh -n 4 -t 900 -- \\
        python3 scripts/torch_lm_sharded_nccl.py [--out FILE] \\
        [--strategy megatron]

Every process joins through the env contract
(``runtime/distributed.py::initialize``) and runs, under
``ExplicitSharder(make_host_mesh(model=N), ShardingRules(strategy))``
(``--strategy``: ``neutron_tp`` by default; under ``megatron`` the
explicit hooks decline and the NN phase is column- and row-parallel, its
sums ledgered as ``tp_psum``):

* **cross-checks** in fp32 at full width cut in depth, on 1 × 512 tokens
  (behind the prefix): Granite-MoE-1B-A400M at 2 layers (16/8 heads: the
  kv all-to-all; 32 experts: ``ep_moe``, at a capacity factor E/k that
  drops nothing) and InternVL2-1B at 2 layers (14 heads: ring attention),
  the first step's gradients (the shards reduced and gathered) leaf for
  leaf within ‖Δ‖ ≤ 1e-5·‖ref‖ and two AdamW steps' losses within 1e-5
  relative, against the unsharded ones on the rank's own card; Zamba2-2.7B at 6 layers (5 mamba2 + the
  shared attention block, flash and SSD on the local heads) scoring
  logits against the unsharded forward within 1e-5·max|ref|;
* **training** at full width and depth, phase 27's configurations
  (naive attention, bf16 compute over fp32 parameters, 4096 tokens):
  Granite-MoE at batch 8 and InternVL2-1B at batch 4 (phase 27's one-card
  batches), 1 warm-up + 3 timed steps, the median step, one step's ledger
  (wire bytes a rank, forward + backward + recompute) and, for Granite,
  one step audited (``analysis/audit.py``, clean);
* **scoring** Zamba2-2.7B at full width, 2 × 2048 tokens: 9 flash and 45
  SSD launches a rank (flash on (2, 2048, 8, 80), SSD on 20 heads), the
  median forward;
* on rank 0, the flash and SSD kernels at those local shapes (phase 19's
  timing rows: the kernel, its plain version, the library call, the
  bound);
* **serving** Zamba2-2.7B at full width (flash, bf16 compute), 2 × 2048
  prefilled and 32 greedy steps through ``make_serve_fns(cfg,
  ExplicitSharder(...))`` under ``seq_shard_cache`` False and
  ``"model"``, beside the unsharded closures on the rank's own card: 9
  flash launches a rank in the sharded prefill (the local heads, (2,
  2048, 8, 80) at N = 4) and none in decode, the prefill and decode
  medians of both, the wire bytes of a decode step (its ledger), and how
  far the bf16 tokens and prefill logits agree (``_agreement``: bf16
  rounds otherwise on the per-rank shapes, so this is reported, and the
  arithmetic is held in fp32 below);
* **serving cross-checks** in fp32, each against its unsharded twin on
  the rank's card — tokens identical, logits within 1e-5·max|ref|:
  Zamba2-2.7B at full width and depth on 1 × 2048, gemma2 at 4 layers on
  1 × 4608 with ring caches (``long_context``) and DeepSeek at 3 layers
  on 1 × 512 (at a capacity factor E/k that drops nothing: ``ep_moe``'s
  capacity is the rank's), under False and ``"model"`` on (data 1, model
  N) and under True on (data 2, model N/2) at batch 1.

``--dryrun-check`` runs instead Granite-MoE's training step (batch 8,
as above, not audited) and one Zamba2-2.7B decode step (2 × 2048
prefilled, ``seq_shard_cache`` False) and holds rank 0's ledger of each,
entry for entry, against ``launch/dryrun.py``'s dry-run of the same cell
at world N (data 1, model N) with the same knobs (``mixing="a2a"``,
``moe="ep"``), run by rank 0 in child processes on torch's fake backend.

``--only training`` or ``--only serving`` runs one part.  ``--train``
names the training cells' configs (default both).  Rank 0 prints
the card's name and power limit and one JSON line, and writes
``--out``.  Exits non-zero if a hold fails.  ``--device cpu
--small`` runs the same on gloo processes at reduced sizes, untimed (a
rehearsal on the host).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

RTOL = 1e-5
LR = 3e-4
STEPS = 3
TRAIN = (("granite-moe-1b-a400m", 8), ("internvl2-1b", 4))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _cfg(arch, small, **over):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch + ("-reduced" if small
                                                  else "")), **over)


def _sharder(mesh, strategy, **rules):
    from repro_torch.sharding import ExplicitSharder, ShardingRules
    return ExplicitSharder(mesh, ShardingRules(strategy, **rules))


def _steps(cfg, sharder, params, batches):
    """Losses of ``batches`` through the unsharded (``sharder`` None) or
    the sharded AdamW step from ``params``."""
    from repro_torch.optim import adamw
    from repro_torch.params import tree_map
    from repro_torch.train import (init_sharded_state, init_train_state,
                                   make_train_step)
    opt = adamw(LR)
    state = init_train_state(tree_map(torch.clone, params), opt) \
        if sharder is None else init_sharded_state(params, cfg, opt, sharder)
    step = make_train_step(cfg, opt, sharder)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append(m["loss"].item())
    return out


def xcheck_training(arch, mesh, dev, small, strategy) -> dict:
    import chip_smoke as cs
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.sharding.specs import gather_params, place_params
    from repro_torch.train import make_grad_fn
    cfg = _cfg(arch, small, num_layers=2, dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
            cfg.num_experts // cfg.num_experts_per_tok))
    params = init_transformer(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab_size, seed=1).batches(
        1, 64 if small else 512, cfg)
    batches = [next(data) for _ in range(2)]
    sharder = _sharder(mesh, strategy)
    # the first step's gradients, each rank's shards reduced and gathered
    grad_rel = cs.grads_held(
        f"{arch} fp32 gradients", gather_params(make_grad_fn(cfg, sharder)(
            place_params(params, cfg, sharder), batches[0])[0], cfg,
            sharder), make_grad_fn(cfg)(params, batches[0])[0], RTOL)
    want = _steps(cfg, None, params, batches)
    got = _steps(cfg, sharder, params, batches)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if rel > RTOL:
        raise AssertionError(f"{arch} fp32 cross-check: sharded {got}, "
                             f"unsharded {want}: {rel:.2e}")
    return {"sharded": got, "unsharded": want, "rel": rel,
            "grad_rel": grad_rel}


def xcheck_scoring(mesh, dev, small, strategy) -> dict:
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.sharding.specs import place_params
    cfg = _cfg("zamba2-2.7b", small, num_layers=6, dtype="float32",
               attn_impl="flash", ssm_impl="fused")
    params = T.init_transformer(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=1)
                                  .batches(1, 64 if small else 512))
                             ["tokens"], device=dev)
    sharder = _sharder(mesh, strategy)
    with torch.no_grad():
        want = T.forward(params, cfg, tokens)[0]
        got, _ = T.forward(place_params(params, cfg, sharder), cfg, tokens,
                           shard=sharder)
        got = sharder.bound(*tokens.shape).unshard(got)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > RTOL * scale:
        raise AssertionError(f"zamba2 6-layer fp32 scoring: max|Δ| {err} "
                             f"of max|ref| {scale}")
    return {"max_abs_diff": err, "max_abs_ref": scale}


def train_cell(arch, batch, mesh, dev, small, audited, strategy) -> dict:
    from repro_torch.analysis import audit
    from repro_torch.configs import get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.train import init_sharded_state, make_train_step
    cfg = _cfg(arch, small)
    seq = 64 if small else get_shape("train_4k").seq_len
    sharder = _sharder(mesh, strategy)
    opt = adamw(LR)
    state = init_sharded_state(init_transformer(cfg, seed=0, device=dev),
                               cfg, opt, sharder)
    step = make_train_step(cfg, opt, sharder)
    data = SyntheticLM(cfg.vocab_size, seed=0).batches(batch, seq, cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(1 + STEPS):
        b = next(data)
        _sync(dev)
        t = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t) * 1e3)
    holder = [state]

    def one(b):
        holder[0], m = step(holder[0], b)
        return m["loss"].item()
    with collect_comm() as ledger:
        if audited:
            _, cen = audit.census(one, next(data))
        else:
            one(next(data))
    findings = [f.format() for f in audit.audit(cen, ledger)] \
        if audited else None
    if findings:
        raise AssertionError(f"{arch} audit: {findings}")
    if not all(v == v for v in losses):
        raise AssertionError(f"{arch} losses {losses}")
    return {"batch": batch, "seq": seq, "losses": losses,
            "step_ms": statistics.median(ms[1:]), "step_ms_runs": ms,
            "wire_bytes": ledger.wire_bytes(train=True),
            "ledger": ledger.as_dict(), "audit": findings,
            "peak_bytes": torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else None}


def scoring_cell(mesh, dev, small, strategy) -> dict:
    import chip_smoke as cs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.sharding.specs import place_params
    cfg = _cfg("zamba2-2.7b", small, attn_impl="flash", ssm_impl="fused")
    sharder = _sharder(mesh, strategy)
    shards = place_params(T.init_transformer(cfg, seed=0, device=dev), cfg,
                          sharder)
    tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=0)
                                  .batches(2, 64 if small else 2048))
                             ["tokens"], device=dev)
    with torch.no_grad():
        cs._zero_lm_counts()
        with collect_comm() as ledger:
            T.forward(shards, cfg, tokens, shard=sharder)[0].sum().item()
        counts = cs._read_lm_counts()
        want = (cs._attn_layers(cfg), cfg.layer_kinds().count("mamba"))
        if dev.type == "cuda" and counts != want:   # the CPU runs the plain
            raise AssertionError(f"sharded scoring launches {counts}, "
                                 f"expected {want}")
        ms = []
        for _ in range(3):
            _sync(dev)
            t = time.perf_counter()
            T.forward(shards, cfg, tokens, shard=sharder)[0].sum().item()
            ms.append((time.perf_counter() - t) * 1e3)
    return {"launches": {"flash": counts[0], "ssd": counts[1]},
            "ms": statistics.median(ms), "ms_runs": ms,
            "wire_bytes": ledger.wire_bytes()}


def _agreement(got, want, s: int) -> dict:
    """How far one bf16 greedy run (``chip_smoke.greedy``) agrees with
    another: the tokens, each sequence's first step whose token differs
    (None where none does) and the prefill logits' largest |Δ| over
    max|ref|.  At N > 1 the per-rank program's GEMMs run on other shapes
    (a sequence shard's rows, a rank's heads), so bf16 rounds otherwise
    and a near-tie can flip a greedy token; the fp32 cross-checks hold
    the arithmetic."""
    differs = got[1][:, s:] != want[1][:, s:]
    return {"tokens_identical": not differs.any(),
            "first_differing_step": [int(np.argmax(d)) if d.any() else None
                                     for d in differs],
            "prefill_rel_diff": (got[0] - want[0]).abs().max().item()
            / want[0].abs().max().item()}


def serving_cell(mesh, dev, small, strategy) -> dict:
    import chip_smoke as cs
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.serve import make_serve_fns
    from repro_torch.sharding.specs import place_params
    cfg = _cfg("zamba2-2.7b", small, attn_impl="flash", ssm_impl="fused")
    params = init_transformer(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=0)
                                  .batches(2, 64 if small else 2048))
                             ["tokens"], device=dev)
    steps = 8 if small else 32
    max_len = tokens.shape[1] + steps
    out = {}
    def prefill_runs(prefill_fn, p, first):
        """The greedy run's prefill time and two more."""
        runs = [first]
        for _ in range(2):
            _sync(dev)
            t = time.perf_counter()
            prefill_fn(p, tokens, max_len=max_len)
            _sync(dev)
            runs.append((time.perf_counter() - t) * 1e3)
        return {"prefill_ms": statistics.median(runs),
                "prefill_ms_runs": runs}

    with torch.no_grad():
        ms = []
        fns = make_serve_fns(cfg)
        want = cs.greedy(*fns, params, tokens, steps, max_len=max_len, ms=ms)
        out["unsharded"] = {**prefill_runs(fns[0], params, ms[0]),
                            "decode_ms": statistics.median(ms[1:]),
                            "decode_ms_runs": ms[1:]}
        for mode in (False, "model"):
            sharder = _sharder(mesh, strategy, seq_shard_cache=mode)
            shards = place_params(params, cfg, sharder)
            fns = make_serve_fns(cfg, sharder)
            ms, ledgers = [], []
            cs._zero_lm_counts()
            got = cs.greedy(*fns, shards, tokens, steps, max_len=max_len,
                            sharder=sharder, ms=ms, ledgers=ledgers)
            counts = cs._read_lm_counts()
            if dev.type == "cuda" and counts != (cs._attn_layers(cfg), 0):
                raise AssertionError(f"sharded serving launches {counts}")
            wire = [led.wire_bytes() for led in ledgers]
            out[f"seq_shard_cache={mode}"] = {
                **_agreement(got, want, tokens.shape[1]),
                "launches": {"flash": counts[0], "ssd": counts[1]},
                **prefill_runs(fns[0], shards, ms[0]),
                "decode_ms": statistics.median(ms[1:]),
                "decode_ms_runs": ms[1:],
                "decode_wire_bytes": wire[0],
                "decode_wire_bytes_equal": len(set(wire)) == 1,
                "decode_ledger": ledgers[0].as_dict(),
                "max_abs_diff": max((g - w).abs().max().item() for g, w in
                                    [(got[0], want[0])] + list(zip(
                                        got[2], want[2])))}
            del shards, got
    return out


def serving_xchecks(meshes, dev, small, strategy) -> dict:
    import chip_smoke as cs
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.serve import make_serve_fns
    from repro_torch.sharding.specs import place_params
    out = {}
    for arch, over, s, lc in (
            ("zamba2-2.7b", {}, 2048, False),
            ("gemma2-9b", {"num_layers": 4}, 4608, True),
            ("deepseek-v2-lite-16b", {"num_layers": 3}, 512, False)):
        cfg = _cfg(arch, small, dtype="float32", attn_impl="flash", **over)
        if cfg.moe:     # ep_moe's capacity is per rank: drop nothing
            cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
                cfg.num_experts // cfg.num_experts_per_tok))
        params = init_transformer(cfg, seed=0, device=dev)
        tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=1)
                                      .batches(1, 96 if small else s))
                                 ["tokens"], device=dev)
        steps = cs.LM_XCHECK_STEPS
        max_len = tokens.shape[1] + steps
        with torch.no_grad():
            want = cs.greedy(*make_serve_fns(cfg, long_context=lc), params,
                             tokens, steps, max_len=max_len)
            for mesh_name, mode in (("1xN", False), ("1xN", "model"),
                                    ("2xN/2", True)):
                sharder = _sharder(meshes[mesh_name], strategy,
                                   seq_shard_cache=mode)
                got = cs.greedy(*make_serve_fns(cfg, sharder,
                                                long_context=lc),
                                place_params(params, cfg, sharder), tokens,
                                steps, max_len=max_len, sharder=sharder)
                tag = f"{arch} fp32 on {mesh_name} seq_shard_cache={mode!r}"
                out[tag] = cs.held_serving(tag, got, want, RTOL)
        del params
    return out


def kernel_rows(dev, n: int) -> dict:
    """Phase 19's rows at the sharded scoring's local shapes."""
    import chip_smoke as cs
    gen = torch.Generator(device=dev).manual_seed(4)
    return {"flash": cs._flash_row(gen, dev, 2, 32 // n, 32 // n, 2048, 80,
                                   80),
            "ssd": cs._ssd_row(gen, dev, 2, 2048, 80 // n, 64, 64, 256)}


def training_part(mesh, n, dev, small, lead, strategy, train) -> dict:
    res = {}
    for arch in ("granite-moe-1b-a400m", "internvl2-1b"):
        res[f"xcheck {arch}"] = xcheck_training(arch, mesh, dev, small,
                                                strategy)
    res["xcheck zamba2 scoring"] = xcheck_scoring(mesh, dev, small,
                                                  strategy)
    if lead:
        print(f"cross-checks ok: {json.dumps(res)}", flush=True)
    for arch, batch in train:
        res[arch] = train_cell(arch, batch, mesh, dev, small,
                               arch.startswith("granite"), strategy)
        if lead:
            r = res[arch]
            print(f"{arch} batch {batch}: step {r['step_ms']:.1f} ms "
                  f"(runs {[round(v, 1) for v in r['step_ms_runs']]}), "
                  f"losses {[round(v, 4) for v in r['losses']]}, "
                  f"{r['wire_bytes'] / 1e9:.3f} GB on the wire a rank "
                  f"a step", flush=True)
    res["zamba2 scoring"] = scoring_cell(mesh, dev, small, strategy)
    if lead and dev.type == "cuda":
        res["kernels"] = kernel_rows(dev, n)
    return res


def serving_part(mesh, n, dev, small, lead, strategy) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    res = {"zamba2 serving": serving_cell(mesh, dev, small, strategy)}
    if lead:
        brief = {k: {f: v.get(f) for f in (
            "prefill_ms", "decode_ms", "decode_wire_bytes",
            "tokens_identical", "first_differing_step", "prefill_rel_diff")}
                 for k, v in res["zamba2 serving"].items()}
        print(f"zamba2 serving: {json.dumps(brief)}", flush=True)
    res["serving xchecks"] = serving_xchecks(
        {"1xN": mesh, "2xN/2": make_host_mesh(model=n // 2, data=2)}, dev,
        small, strategy)
    return res


def decode_ledger(mesh, dev, small, strategy) -> dict:
    """Zamba2-2.7B (flash, bf16 compute): 2 × 2048 prefilled and one
    decode step's ledger under ``ExplicitSharder`` with
    ``seq_shard_cache`` False."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.runtime.telemetry import collect_comm
    from repro_torch.serve import make_serve_fns
    from repro_torch.sharding.specs import place_params
    cfg = _cfg("zamba2-2.7b", small, attn_impl="flash", ssm_impl="fused")
    sharder = _sharder(mesh, strategy, seq_shard_cache=False)
    shards = place_params(init_transformer(cfg, seed=0, device=dev), cfg,
                          sharder)
    tokens = torch.as_tensor(next(SyntheticLM(cfg.vocab_size, seed=0)
                                  .batches(2, 64 if small else 2048))
                             ["tokens"], device=dev)
    b, s = tokens.shape
    prefill_fn, decode_fn = make_serve_fns(cfg, sharder)
    with torch.no_grad():
        _, caches = prefill_fn(shards, tokens, max_len=s + 1)
        with collect_comm() as ledger:
            decode_fn(shards, tokens[:, -1:].to(torch.int32), caches)
    return {"batch": b, "cache_len": s + 1, "ledger": ledger.as_dict(),
            "wire_bytes": ledger.wire_bytes()}


def dryrun_part(mesh, n, dev, small, lead, strategy) -> dict:
    """``--dryrun-check``: the two cells' ledgers on the cards, and on rank
    0 the dry-run of each at world ``n`` held to them entry for entry."""
    import chip_smoke as cs
    arch = "granite-moe-1b-a400m"
    train = train_cell(arch, 8, mesh, dev, small, False, strategy)
    decode = decode_ledger(mesh, dev, small, strategy)
    res = {"granite train": train, "zamba2 decode": decode}
    if not lead:
        return res
    suffix = "-reduced" if small else ""
    knobs = {"mixing": "a2a", "moe": "ep"}
    mesh_shape = {"model": n, "data": 1}
    specs = {
        "granite_train": dict(arch=arch + suffix, over={}, mesh=mesh_shape,
                              strategy=strategy, knobs=knobs,
                              shape=["train_4k", train["seq"], 8, "train"]),
        "zamba2_decode": dict(arch="zamba2-2.7b" + suffix,
                              over={"attn_impl": "naive", "ssm_impl": "jnp"},
                              mesh=mesh_shape, strategy=strategy, knobs=knobs,
                              shape=["decode_32k", decode["cache_len"],
                                     decode["batch"], "decode"])}
    recs = cs._dryrun_children(
        specs, ROOT / "build" / f"dryrun_check_{strategy}")
    for name, card in (("granite_train", train), ("zamba2_decode", decode)):
        got = recs[name]["ledger"]
        if got != card["ledger"]:
            raise AssertionError(
                f"{name}: the dry-run's ledger {got} differs from rank 0's "
                f"{card['ledger']}")
        res[f"dryrun {name}"] = {
            "entries": len(got),
            "calls": sum(e["calls"] + e["mirrored_calls"]
                         + e.get("recomputed_calls", 0)
                         for e in got.values()),
            "wire_bytes": sum(e["wire_bytes"] + e["mirrored_wire_bytes"]
                              + e.get("recomputed_wire_bytes", 0)
                              for e in got.values()),
            "memory": recs[name]["memory"], "cost": recs[name]["cost"],
            "roofline": recs[name]["roofline"],
            "trace_s": recs[name]["compile_seconds"]}
        print(f"dry-run {name} ({strategy}, world {n}): ledger equal to "
              f"rank 0's, {res[f'dryrun {name}']['entries']} entries, "
              f"{res[f'dryrun {name}']['calls']:.0f} calls, "
              f"{res[f'dryrun {name}']['wire_bytes'] / 1e9:.4f} GB on the "
              f"wire", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "lm_sharded.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--only", choices=("training", "serving"),
                    help="run the training and scoring part or the "
                         "serving part alone (default: both)")
    ap.add_argument("--strategy", default="neutron_tp",
                    choices=("neutron_tp", "megatron"))
    ap.add_argument("--train", nargs="+", default=[a for a, _ in TRAIN],
                    choices=[a for a, _ in TRAIN])
    ap.add_argument("--dryrun-check", action="store_true",
                    help="hold the dry-run's ledgers against the cards' "
                         "(instead of the parts)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import distributed as RD
    ctx = RD.initialize(device=args.device)
    dev = torch.device(ctx.device)
    lead = ctx.process_id == 0
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res = {}
    try:
        mesh = make_host_mesh(model=ctx.num_processes, data=1)
        n = mesh.size
        if args.dryrun_check:
            res.update(dryrun_part(mesh, n, dev, args.small, lead,
                                   args.strategy))
        elif args.only != "serving":
            res.update(training_part(mesh, n, dev, args.small, lead,
                                     args.strategy, [(a, b) for a, b in TRAIN
                                                     if a in args.train]))
        if args.only != "training" and not args.dryrun_check:
            res.update(serving_part(mesh, n, dev, args.small, lead,
                                    args.strategy))
    finally:
        RD.shutdown()

    if lead:
        if dev.type == "cuda":
            res["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
            print(res["card"])
        res["seconds"] = time.perf_counter() - t0
        res["ranks"] = ctx.num_processes
        res["strategy"] = args.strategy
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
        print(json.dumps({k: v for k, v in res.items() if k != "kernels"}
                         , default=str)[:6000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
