#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device  — needs a CUDA device; prints the card's name and power limit
             and turns TF32 off for matmul and cuDNN;
2. build   — compiles the block-sparse SpMM kernel from the checkout's
             sources (``build/torch_kernels/``);
3. kernel  — the kernel against its plain PyTorch version on the card:
             bs ∈ {32, 64, 128} × d ∈ {8, 41, 128, 200} on rectangular
             plans (forward and transposed tiles), a stacked plan's padded
             instance, an empty plan, and forward + autograd backward
             through ``aggregate_plan``; each case held to
             max|Δ| ≤ 1e-5·(1 + max|ref|);
4. train   — the port's main path: decoupled-pipelined TP GCN training on
             reddit_like(scale=1.0, seed=0) (n=23 000, 602 features, 41
             classes; hidden 128, 2 layers, 4 chunks, blocksparse at
             bs=128, AdamW lr 1e-2 wd 5e-4) over a 1-rank NCCL group:
             3 warm-up + 10 timed steps with finite, falling loss, the
             kernel launched on every step; then the step-0 loss and grads
             recomputed with the plain version on the card and with the
             segment backend, each held within rtol 1e-4 (per tensor,
             max|Δ| ≤ 1e-4·max|ref|);
5. timing  — one forward-chunk and one backward-chunk launch at the main
             path's shapes with CUDA events, beside the plain version,
             ``torch.sparse.mm`` on the same chunk of Â as CSR (timed
             only, never on the path) and the card's bound.

The last lines are a JSON summary of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5
PATH_RTOL = 1e-4


def _held(name: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float = KERNEL_TOL, floor: float = 1.0) -> float:
    """Hold ``got`` to max|Δ| ≤ rtol·(floor + max|want|); returns max|Δ|."""
    err = (got - want).abs().max().item() if want.numel() else 0.0
    ref = want.abs().max().item() if want.numel() else 0.0
    ok = err <= rtol * (floor + ref)
    print(f"  {name:<44} max|Δ|={err:.3e}  max|ref|={ref:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max|Δ| {err} > {rtol}·({floor}+{ref})")
    return err


def _ref_on_card(blocks, rows, cols, h, *, n_out=None):
    from repro_torch.kernels.spmm.ref import spmm_ref
    return spmm_ref(blocks, rows, cols, h, n_out=n_out)


def _rect_plan(n_rows, n_cols, e, bs, seed):
    from repro_torch.graph.format import rect_block_sparse
    rng = np.random.default_rng(seed)
    return rect_block_sparse(rng.integers(0, n_rows, e).astype(np.int32),
                             rng.integers(0, n_cols, e).astype(np.int32),
                             rng.random(e).astype(np.float32),
                             n_rows, n_cols, bs)


def kernel_cases(dev) -> float:
    """Phase 3; returns the largest max|Δ| over the cases."""
    from repro_torch.graph.format import stack_plans
    from repro_torch.kernels.spmm import ops
    from repro_torch.kernels.spmm import (aggregate_plan,
                                          block_sparse_plan_dev,
                                          spmm_block_sparse, spmm_ref)
    errs = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for bs in (32, 64, 128):
        plan = block_sparse_plan_dev(
            _rect_plan(3 * bs + 5, 7 * bs + 3, 40 * bs, bs, seed=bs), dev)
        for d in (8, 41, 128, 200):
            h = torch.randn(plan.cols_padded, d, generator=gen, device=dev)
            errs.append(_held(
                f"bs={bs} d={d} rect {plan.rows_padded}x{plan.cols_padded}",
                spmm_block_sparse(plan.blocks, plan.block_rows,
                                  plan.block_cols, h, n_out=plan.rows_padded),
                spmm_ref(plan.blocks, plan.block_rows, plan.block_cols, h,
                         n_out=plan.rows_padded)))
            g = torch.randn(plan.rows_padded, d, generator=gen, device=dev)
            errs.append(_held(
                f"bs={bs} d={d} transposed tiles",
                spmm_block_sparse(plan.blocks_t, plan.block_rows_t,
                                  plan.block_cols_t, g,
                                  n_out=plan.cols_padded),
                spmm_ref(plan.blocks_t, plan.block_rows_t, plan.block_cols_t,
                         g, n_out=plan.cols_padded)))

    sparse = _rect_plan(100, 300, 30, 64, seed=1)
    dense = _rect_plan(100, 300, 5000, 64, seed=2)
    padded = block_sparse_plan_dev(stack_plans([sparse, dense]),
                                   dev).instance(0)
    if sparse.nnzb >= dense.nnzb or padded.blocks[-1].any():
        raise AssertionError("stacked case has no padding tiles")
    h = torch.randn(padded.cols_padded, 41, generator=gen, device=dev)
    errs.append(_held("bs=64 d=41 stack_plans instance with padding",
                      spmm_block_sparse(padded.blocks, padded.block_rows,
                                        padded.block_cols, h,
                                        n_out=padded.rows_padded),
                      spmm_ref(padded.blocks, padded.block_rows,
                               padded.block_cols, h,
                               n_out=padded.rows_padded)))

    before = spmm_block_sparse.launches
    empty = torch.zeros(0, 32, 32, device=dev)
    idx = torch.zeros(0, dtype=torch.int32, device=dev)
    out = spmm_block_sparse(empty, idx, idx, torch.randn(64, 41, device=dev),
                            n_out=96)
    if out.shape != (96, 41) or out.any() or \
            spmm_block_sparse.launches != before:
        raise AssertionError("empty plan must launch nothing, give zeros")
    print(f"  {'empty plan (nnzb=0)':<44} zeros, no launch  ok")

    for bs, d in ((64, 41), (128, 200)):
        plan = block_sparse_plan_dev(
            _rect_plan(2 * bs + 7, 5 * bs + 1, 30 * bs, bs, seed=7 + bs),
            dev)
        h = torch.randn(plan.n_cols, d, generator=gen, device=dev,
                        requires_grad=True)
        cot = torch.randn(plan.rows_padded, d, generator=gen, device=dev)
        got = aggregate_plan(plan, h)
        (got_g,) = torch.autograd.grad(got, h, cot)
        with mock.patch.object(ops, "spmm_block_sparse", _ref_on_card):
            want = aggregate_plan(plan, h)
            (want_g,) = torch.autograd.grad(want, h, cot)
        errs.append(_held(f"bs={bs} d={d} aggregate_plan forward",
                          got.detach(), want.detach()))
        errs.append(_held(f"bs={bs} d={d} aggregate_plan backward",
                          got_g, want_g))
    return max(errs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train(dev):
    """Phase 4; returns (bundle, data, launches, median step ms)."""
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.graph.synthetic import reddit_like
    from repro_torch.kernels.spmm import ops, spmm_block_sparse
    from repro_torch.params import tree_leaves
    from repro_torch.runtime import TPMesh

    t0 = time.perf_counter()
    data = reddit_like(scale=1.0, seed=0)
    bundle = D.prepare_bundle(data, n_workers=1, n_chunks=4,
                              agg="blocksparse", agg_block_size=128,
                              device=dev)
    torch.cuda.synchronize()
    plan = bundle.graph.bsp
    dens = plan.nnzb / ((plan.rows_padded // plan.bs)
                        * (plan.cols_padded // plan.bs))
    print(f"  graph n={data.graph.n} E={data.graph.e} "
          f"features={data.features.shape[1]} classes={data.num_classes}; "
          f"plan {plan.nnzb} tiles/chunk of bs={plan.bs} (density "
          f"{dens:.4f}, {data.graph.e / (4 * plan.nnzb):.1f} edges/tile); "
          f"prepared in {time.perf_counter() - t0:.1f} s")

    mesh = TPMesh()
    cfg = D.padded_gnn_config(data, bundle, hidden_dim=128, num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                         mode="decoupled_pipelined")
    params, state = params0, opt.init(params0)
    losses, ms = [], []
    spmm_block_sparse.launches = 0
    for i in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss = step(params, state)
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        print(f"  step {i:2d} {'warm-up' if i < 3 else 'timed  '} "
              f"loss {losses[-1]:.6f}  {ms[-1]:.2f} ms")
    launches = spmm_block_sparse.launches
    median_ms = statistics.median(ms[3:])
    print(f"  median step {median_ms:.2f} ms over 10 timed steps; "
          f"spmm_block_sparse launches {launches} "
          f"({launches / 13:.0f} per step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} → "
                             f"{losses[-1]}")
    if launches != 13 * 16:
        raise AssertionError(f"expected 16 kernel launches per step "
                             f"(2 rounds × 4 chunks × fwd+bwd), got "
                             f"{launches} in 13 steps")
    _, val_acc = evaluate(params, "val")
    print(f"  val accuracy after 13 steps {val_acc.item():.4f}")
    profile = _profile_step(step, params, state)

    vg = D.make_tp_value_and_grad(cfg, bundle, mesh,
                                  mode="decoupled_pipelined")
    loss_k, grads_k = vg(params0, bundle.train_mask)
    with mock.patch.object(ops, "spmm_block_sparse", _ref_on_card):
        loss_p, grads_p = vg(params0, bundle.train_mask)
    loss_s, grads_s = D.make_tp_value_and_grad(
        cfg, bundle, mesh, mode="decoupled_pipelined", agg="segment")(
            params0, bundle.train_mask)
    if abs(loss_k.item() - losses[0]) > PATH_RTOL * abs(losses[0]):
        raise AssertionError("step-0 loss differs from the first step's")
    for other, lo, go in (("plain", loss_p, grads_p),
                          ("segment", loss_s, grads_s)):
        _held(f"step-0 loss, kernel vs {other}", loss_k, lo, PATH_RTOL,
              0.0)
        for i, (a, b) in enumerate(zip(tree_leaves(grads_k),
                                       tree_leaves(go))):
            _held(f"step-0 grad {i} {tuple(a.shape)}, kernel vs {other}",
                  a, b, PATH_RTOL, 0.0)
    return bundle, data, launches, median_ms, profile


def _profile_step(step, params, state) -> dict:
    """Device busy time and the top kernels of one more training step
    under ``torch.profiler`` (diagnostic: the wall time includes the
    profiler's own cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(f"  profiled step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} "
          f"ms wall (idle share {1 - busy_ms / wall_ms:.3f})")
    for name, ms, count in kernels[:6]:
        print(f"    {ms:9.3f} ms  {count:4d}×  {name[:70]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "top": [[n[:70], ms, c] for n, ms, c in kernels[:6]]}


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(blocks, n_in, n_out, d):
    """Least time the card could take: every input byte read once and the
    output written once, and the fp32 operations the tiles' nonzero
    entries need (2 per nonzero per output column)."""
    nnzb = blocks.shape[0]
    nbytes = 4 * (blocks.numel() + 2 * nnzb + n_in * d + n_out * d)
    flops = 2 * int(torch.count_nonzero(blocks).item()) * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def timing(bundle, data, dev):
    """Phase 5: returns the forward-chunk numbers and the max|Δ| there."""
    from repro_torch.kernels.spmm import spmm_block_sparse, spmm_ref
    plan = bundle.graph.bsp.instance(0)
    cs = bundle.graph.chunked.chunk_size
    d = bundle.graph.c_padded
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(plan.cols_padded, d, generator=gen, device=dev)
    g = torch.randn(plan.rows_padded, d, generator=gen, device=dev)

    def fwd():
        return spmm_block_sparse(plan.blocks, plan.block_rows,
                                 plan.block_cols, h, n_out=plan.rows_padded)

    def fwd_plain():
        return spmm_ref(plan.blocks, plan.block_rows, plan.block_cols, h,
                        n_out=plan.rows_padded)

    def bwd():
        return spmm_block_sparse(plan.blocks_t, plan.block_rows_t,
                                 plan.block_cols_t, g,
                                 n_out=plan.cols_padded)

    def bwd_plain():
        return spmm_ref(plan.blocks_t, plan.block_rows_t, plan.block_cols_t,
                        g, n_out=plan.cols_padded)

    err = _held(f"main-path forward chunk (d={d})", fwd(), fwd_plain())
    err = max(err, _held(f"main-path backward chunk (d={d})", bwd(),
                         bwd_plain()))

    # chunk 0 of Â as CSR (rows [0, cs), all source columns) — the library
    # yardstick, never on the port's path
    gr = data.graph
    e_hi = int(gr.indptr[cs])
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([gr.dst[:e_hi], gr.src[:e_hi]]).astype(
            np.int64)), torch.from_numpy(gr.weight[:e_hi]),
        (plan.rows_padded, plan.cols_padded)).coalesce()
    a_csr = coo.to_sparse_csr().to(dev)

    def lib():
        return torch.sparse.mm(a_csr, h)

    lib_err = (lib() - fwd()).abs().max().item()
    print(f"  torch.sparse.mm vs kernel on chunk 0: max|Δ|={lib_err:.3e}")

    rows = {}
    for name, k, p, n_in, n_out, blocks in (
            ("forward", fwd, fwd_plain, plan.cols_padded, plan.rows_padded,
             plan.blocks),
            ("backward", bwd, bwd_plain, plan.rows_padded, plan.cols_padded,
             plan.blocks_t)):
        nnzb = blocks.shape[0]
        k_ms, p_ms = _time_ms(k, 20), _time_ms(p, 5)
        k_ms2 = _time_ms(k, 20)
        bound_ms, by, nbytes, flops = _bound(blocks, n_in, n_out, d)
        rows[name] = dict(ms=min(k_ms, k_ms2), ms_runs=[k_ms, k_ms2],
                          plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                          nnzb=nnzb, n_in=n_in, n_out=n_out, bytes=nbytes,
                          flops=flops)
        print(f"  {name} chunk: {nnzb} tiles, {n_in}→{n_out} rows, d={d}: "
              f"kernel {k_ms:.4f} / {k_ms2:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.4f} GFLOP on the nonzeros)")
    lib_ms = _time_ms(lib, 20)
    print(f"  torch.sparse.mm (CSR, {e_hi} nonzeros) forward chunk: "
          f"{lib_ms:.4f} ms")
    rows["forward"]["library_ms"] = lib_ms
    return rows, err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on a CUDA GPU only", file=sys.stderr)
        return 1
    import torch.distributed as dist
    from repro_torch.kernels.spmm import spmm as spmm_mod

    print("[1/5] device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"  {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  tf32 off: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    print("[2/5] build")
    t0 = time.perf_counter()
    spmm_mod.build()
    print(f"  spmm_block_sparse built (sm_90a) in "
          f"{time.perf_counter() - t0:.1f} s")

    print("[3/5] kernel against its plain version")
    case_err = kernel_cases(dev)

    print("[4/5] main path: decoupled-pipelined TP GCN training")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        bundle, data, launches, step_ms, profile = train(dev)
        print("[5/5] kernel timing at the main path's shapes")
        rows, path_err = timing(bundle, data, dev)
    finally:
        dist.destroy_process_group()

    fwd = rows["forward"]
    print(json.dumps({"timing": rows, "step_ms": step_ms,
                      "profile": profile, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "spmm_block_sparse", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm_block_sparse.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:64",
        "held_against": "ref.spmm_ref", "launches": launches,
        "max_abs_err": max(case_err, path_err),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
