#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device   — needs a CUDA device; prints the card's name and power limit
              and turns TF32 off for matmul and cuDNN;
2. build    — compiles every kernel of the port (SpMM, flash attention,
              SSD) from the checkout's sources in one build
              (``build/torch_kernels/``) and prints the seconds;
3. spmm     — the nonzero-balanced SpMM kernel, on the compressed arrays
              ``block_sparse_plan_dev`` derives from each plan's tiles,
              against the plain version on the dense tiles (``spmm_ref``):
              bs ∈ {32, 64, 128} × d ∈ {8, 41, 128, 200} on rectangular
              plans, forward and transposed; a skewed plan (one row of
              5 000 nonzeros over 79 warp segments, 500 empty rows, rows
              straddling segments) whose repeat launches must be bitwise
              equal; a stacked plan's padded instance; an empty plan (no
              launch, zeros); and forward + autograd backward through
              ``aggregate_plan`` against the plain version on its arrays;
              each case held to max|Δ| ≤ 1e-5·(1 + max|ref|);
4. flash    — the flash-attention kernels against their plain version:
              every bf16 case through the tensor-core kernel and every fp32
              case through the FMA kernel (launch counts per variant), GQA
              groups g ∈ {1, 2, 4, 8}, causal and not, window, softcap,
              ragged Sq ≠ Skv, hd ∈ {36, 64, 80, 128, 256}, hdv ≠ hd; fp32
              held to 1e-5·(1 + max|ref|), bf16 per element to |Δ| ≤
              2^-7·|ref| + 1e-3 (both round the same fp32 math to bf16
              once, so they differ by at most one bf16 ulp);
5. ssd      — the SSD intra-chunk kernel against its plain version:
              Q ∈ {16, 64, 256}, P ∈ {32, 64}, N ∈ {32, 64, 128}, H > 1
              with B/C shared, held to 1e-4·(1 + max|ref|) (the kernel's
              prefix sum adds in another order; exp(cs) at |cs| ~ 1e2);
              and the full ``ssd_chunked_fused`` against ``ssd_chunked``
              and ``ssd_dense_ref`` with S not a multiple of Q;
6. gcn      — the GCN main path: decoupled-pipelined TP GCN training on
              reddit_like(scale=1.0, seed=0) (n=23 000, 602 features, 41
              classes; hidden 128, 2 layers, 4 chunks, blocksparse at
              bs=128, AdamW lr 1e-2 wd 5e-4) over a 1-rank NCCL group:
              3 warm-up + 10 timed steps with finite, falling loss, the
              SpMM kernel launched on every step; then the step-0 loss and
              grads recomputed with the plain version on the card and with
              the segment backend, each held within rtol 1e-4 (per tensor,
              max|Δ| ≤ 1e-4·max|ref|);
7. spmm-t   — the forward and the backward chunk at the GCN path's
              shapes: the kernel held against the plain version on chunk
              0's tiles and on its arrays, a repeat launch bitwise equal,
              and ``torch.sparse.mm`` on torch's CSR of the same tiles
              (held to 1e-5·(1 + max|ref|); timed only, never on the path);
              kernel and library timed as device time (``torch.profiler``,
              min of two runs of 20 after a warm-up; the SpMM's includes
              the memset of its flags, printed apart), beside the CUDA-event
              time of a call, the plain version and the bound of these
              inputs (nonzeros, row pointers, h once, output once);
8. serve    — the LM main path: Zamba2-2.7B at full width and depth
              (2.06 B parameters, random weights from seed 0 drawn on the
              card), bf16, ``attn_impl="flash"``, ``ssm_impl="fused"``:
              ``generate`` of 2 prompts × 2048 tokens from
              ``SyntheticLM(32000, seed=0)`` + 32 greedy steps, 9 flash
              launches in prefill (all of the tensor-core kernel) and none
              in decode; then prefill and
              decode timed (medians) and one prefill profiled;
9. score    — ``forward`` + ``lm_loss`` on 2 × 2048 tokens with targets
              under ``torch.no_grad()``: 9 flash (tensor-core) and 45 SSD
              launches, a
              finite loss; timed and profiled;
10. fp32    — the same weights in fp32 on a 1 × 512 prompt: the kernel
              path against the same path with both plain versions patched
              in on the card — prefill logits within 1e-4·max|ref|,
              identical greedy tokens over 8 steps, scoring loss within
              1e-5 relative; and the bf16 scoring loss of phase 9 beside
              its plain-version twin (printed, not gated);
11. lm-t    — the flash kernel at (2, 32, 2048, 80) causal held against
              its plain version in fp32 (1e-5·(1 + max|ref|)) and in bf16
              (per element, as phase 4); one bf16 launch there timed beside
              its plain version, ``scaled_dot_product_attention`` on the
              same tensors (held for agreement to 1e-2·(1 + max|ref|): it
              rounds the softmax weights to bf16; timed only, never on the
              path) and its bound; one SSD launch at (2, 2048, 80, 64),
              N=64, Q=256 beside its plain version and its bound.

The last lines are a JSON summary of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  In the summary's
``kernels`` line, ``ms_by`` says how each row's ``ms`` and ``library_ms``
were timed: ``"profiler"`` (device time from ``torch.profiler``) or
``"events"`` (CUDA events over back-to-back calls); ``plain_ms`` and the
SpMM's ``event_ms`` are always CUDA events.
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
PEAK_BF16_FLOP_PER_S = 989e12
KERNEL_TOL = 1e-5
BF16_ULP = 2.0 ** -7   # bf16 spacing relative to the value
BF16_ATOL = 1e-3       # per-element floor for outputs near 0
SDPA_TOL = 1e-2        # SDPA rounds the softmax weights to bf16
SSD_TOL = 1e-4         # prefix sums in another order, exp(cs) at |cs| ~ 1e2
PATH_RTOL = 1e-4
# the port's kernels, as their names appear in a profile
PORT_KERNELS = ("spmm_csr_kernel", "flash_fwd", "ssd_intra_chunk_kernel")


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


def _held_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a bf16 result per element, |Δ| ≤ 2^-7·|want| + 1e-3: one bf16
    ulp of the value, for two roundings of the same fp32 math.  Returns
    max|Δ|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    worst = (diff / (BF16_ULP * want.abs() + BF16_ATOL)).max().item()
    err = diff.max().item()
    ok = worst <= 1.0
    print(f"  {name:<44} max|Δ|={err:.3e}  worst |Δ|/(2^-7·|ref|+1e-3)="
          f"{worst:.3f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: |Δ| exceeds 2^-7·|ref| + 1e-3 "
                             f"(worst ratio {worst})")
    return err


def _rect_plan(n_rows, n_cols, e, bs, seed):
    from repro_torch.graph.format import rect_block_sparse
    rng = np.random.default_rng(seed)
    return rect_block_sparse(rng.integers(0, n_rows, e).astype(np.int32),
                             rng.integers(0, n_cols, e).astype(np.int32),
                             rng.random(e).astype(np.float32),
                             n_rows, n_cols, bs)


def _skewed_plan(seed=11):
    """3 000 × 20 000 at bs=128: destination row 11 has 5 000 sources (it
    spans 79 kernel segments), rows 1 000–1 499 are empty, the other rows
    get ≈ 6 random sources each, so many rows straddle two segments."""
    from repro_torch.graph.format import rect_block_sparse
    rng = np.random.default_rng(seed)
    hub = rng.choice(20000, 5000, replace=False).astype(np.int32)
    dst = rng.integers(0, 3000, 20000).astype(np.int32)
    dst = dst[(dst < 1000) | (dst >= 1500)]
    src = rng.integers(0, 20000, dst.size).astype(np.int32)
    w = rng.random(5000 + dst.size).astype(np.float32)
    w[:5000] *= 0.015      # GCN-sized weights on the hub
    return rect_block_sparse(np.concatenate([np.full(5000, 11, np.int32), dst]),
                             np.concatenate([hub, src]), w, 3000, 20000, 128)


def _tiles(plan, t, dev, c=None):
    """A host plan's forward (t="") or transposed (t="_t") tiles on the
    card, instance c of a stack."""
    out = []
    for f in ("blocks", "block_rows", "block_cols"):
        a = getattr(plan, f + t)
        out.append(torch.from_numpy(np.ascontiguousarray(
            a if c is None else a[c])).to(dev))
    return out


def _arrays(plan_dev, t):
    return [getattr(plan_dev, f + t) for f in ("row_ptr", "col_idx", "vals")]


def kernel_cases(dev) -> float:
    """Phase 3; returns the largest max|Δ| over the cases."""
    from repro_torch.graph.format import stack_plans
    from repro_torch.kernels.spmm import ops
    from repro_torch.kernels.spmm import (aggregate_plan,
                                          block_sparse_plan_dev, spmm_csr,
                                          spmm_csr_ref, spmm_ref)
    errs = []
    gen = torch.Generator(device=dev).manual_seed(0)

    def both_ways(name, host, c=None, ds=(8, 41, 128, 200), repeat=False):
        plan = block_sparse_plan_dev(host, dev)
        plan = plan if c is None else plan.instance(c)
        for t, n_in, n_out in (("", plan.cols_padded, plan.rows_padded),
                               ("_t", plan.rows_padded, plan.cols_padded)):
            for d in ds:
                h = torch.randn(n_in, d, generator=gen, device=dev)
                got = spmm_csr(*_arrays(plan, t), h)
                errs.append(_held(
                    f"{name} d={d} {'transposed' if t else 'forward'}", got,
                    spmm_ref(*_tiles(host, t, dev, c), h, n_out=n_out)))
                if repeat and not torch.equal(got,
                                              spmm_csr(*_arrays(plan, t), h)):
                    raise AssertionError(f"{name} d={d}: a second launch "
                                         f"differs bitwise")
        return plan

    for bs in (32, 64, 128):
        both_ways(f"bs={bs} rect {3 * bs + 5}x{7 * bs + 3}",
                  _rect_plan(3 * bs + 5, 7 * bs + 3, 40 * bs, bs, seed=bs))
    skew = both_ways("skewed 3000x20000 (hub 5000, empty band)",
                     _skewed_plan(), ds=(41, 200), repeat=True)
    nnz = int(skew.row_ptr[-1])
    rows = skew.row_ptr.diff()
    print(f"  {'skewed case':<44} nnz {nnz}, longest row {int(rows.max())}"
          f", {int((rows == 0).sum())} empty rows; repeat launches "
          f"bitwise equal  ok")

    sparse = _rect_plan(100, 300, 30, 64, seed=1)
    dense = _rect_plan(100, 300, 5000, 64, seed=2)
    stacked = stack_plans([sparse, dense])
    if sparse.nnzb >= dense.nnzb or stacked.blocks[0, -1].any():
        raise AssertionError("stacked case has no padding tiles")
    both_ways("bs=64 stack_plans instance with padding", stacked, c=0,
              ds=(41,))

    before = spmm_csr.launches
    empty = block_sparse_plan_dev(_rect_plan(90, 60, 0, 32, seed=3), dev)
    out = spmm_csr(*_arrays(empty, ""), torch.randn(64, 41, device=dev))
    if out.shape != (96, 41) or out.any() or spmm_csr.launches != before:
        raise AssertionError("empty plan must launch nothing, give zeros")
    print(f"  {'empty plan (no nonzero)':<44} zeros, no launch  ok")

    for bs, d in ((64, 41), (128, 200)):
        plan = block_sparse_plan_dev(
            _rect_plan(2 * bs + 7, 5 * bs + 1, 30 * bs, bs, seed=7 + bs),
            dev)
        h = torch.randn(plan.n_cols, d, generator=gen, device=dev,
                        requires_grad=True)
        cot = torch.randn(plan.rows_padded, d, generator=gen, device=dev)
        got = aggregate_plan(plan, h)
        (got_g,) = torch.autograd.grad(got, h, cot)
        with mock.patch.object(ops, "spmm_csr", spmm_csr_ref):
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
    from repro_torch.kernels.spmm import ops, spmm_csr, spmm_csr_ref
    from repro_torch.params import tree_leaves
    from repro_torch.runtime import TPMesh

    t0 = time.perf_counter()
    data = reddit_like(scale=1.0, seed=0)
    bundle = D.prepare_bundle(data, n_workers=1, n_chunks=4,
                              agg="blocksparse", agg_block_size=128,
                              device=dev)
    torch.cuda.synchronize()
    plan = bundle.graph.bsp
    nnz = plan.row_ptr[:, -1].tolist()
    print(f"  graph n={data.graph.n} E={data.graph.e} "
          f"features={data.features.shape[1]} classes={data.num_classes}; "
          f"plans of bs={plan.bs} tiles, compressed to {nnz} nonzeros per "
          f"chunk ({plan.rows_padded} rows over {plan.cols_padded} sources); "
          f"prepared in {time.perf_counter() - t0:.1f} s")

    mesh = TPMesh()
    cfg = D.padded_gnn_config(data, bundle, hidden_dim=128, num_layers=2)
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, evaluate = D.make_tp_train_fns(cfg, bundle, mesh, opt,
                                         mode="decoupled_pipelined")
    params, state = params0, opt.init(params0)
    losses, ms = [], []
    spmm_csr.launches = 0
    for i in range(13):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss = step(params, state)
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        print(f"  step {i:2d} {'warm-up' if i < 3 else 'timed  '} "
              f"loss {losses[-1]:.6f}  {ms[-1]:.2f} ms")
    launches = spmm_csr.launches
    median_ms = statistics.median(ms[3:])
    print(f"  median step {median_ms:.2f} ms over 10 timed steps; "
          f"spmm_csr launches {launches} "
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
    profile = _profile(lambda: step(params, state), "step")

    vg = D.make_tp_value_and_grad(cfg, bundle, mesh,
                                  mode="decoupled_pipelined")
    loss_k, grads_k = vg(params0, bundle.train_mask)
    with mock.patch.object(ops, "spmm_csr", spmm_csr_ref):
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


def _profile(fn, label: str) -> dict:
    """Device busy time and the top kernels of one call of ``fn`` under
    ``torch.profiler`` (diagnostic: the wall time includes the profiler's
    own cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(f"  profiled {label}: device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall (idle share {1 - busy_ms / wall_ms:.3f})")
    for name, ms, count in kernels[:8]:
        print(f"    {ms:9.3f} ms  {count:5d}×  {name[:70]}")
    port = [k for k in kernels if any(n in k[0] for n in PORT_KERNELS)]
    for name, ms, count in port:
        print(f"    port kernel: {ms:9.3f} ms  {count:5d}×  {name[:60]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "top": [[n[:70], ms, c] for n, ms, c in kernels[:8]],
            "port": [[n[:70], ms, c] for n, ms, c in port]}


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


def _device_ms(fn, iters: int) -> tuple[float, float]:
    """Device time of one call of ``fn``: the sum over the kernels and
    memsets it launches, and the memsets' part of it, from
    ``torch.profiler``, averaged over ``iters`` calls after one warm-up
    call.  For launches of a few microseconds, where CUDA events over
    back-to-back calls time the host's Python and launch cost instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / iters,
            sum(e.self_device_time_total for e in events
                if "memset" in e.key.lower()) / 1e3 / iters)


def _spmm_bound(nnz, n_in, n_out, d):
    """Least time the card could take for a sparse product with these
    inputs: the nonzeros (value and source index, 8 B each), the row
    pointers, h read once and the output written once, against the fp32
    operations the nonzeros need (2 per nonzero per column)."""
    nbytes = 8 * nnz + 4 * (n_out + 1) + 4 * n_in * d + 4 * n_out * d
    flops = 2 * nnz * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _csr_of_tiles(blocks, rows, cols, n_out, n_in):
    """torch's CSR of a plan instance's tiles (its nonzero entries, padded
    rows included): the library yardstick's input, built independently of
    the port's derivation."""
    bs = blocks.shape[-1]
    k, i, j = torch.nonzero(blocks, as_tuple=True)
    idx = torch.stack([rows.long()[k] * bs + i, cols.long()[k] * bs + j])
    return torch.sparse_coo_tensor(idx, blocks[k, i, j], (n_out, n_in),
                                   check_invariants=True).coalesce() \
        .to_sparse_csr()


def timing(bundle, data, dev):
    """Phase 7: returns the forward/backward-chunk numbers and the max|Δ|
    there."""
    from repro_torch.core.decouple import _pad_graph
    from repro_torch.graph.format import rect_block_sparse
    from repro_torch.kernels.spmm import spmm_csr, spmm_csr_ref, spmm_ref
    plan = bundle.graph.bsp.instance(0)
    cs = bundle.graph.chunked.chunk_size
    d = bundle.graph.c_padded
    # chunk 0's tiles as chunk_block_sparse builds them (its stack padding
    # is all-zero tiles, which hold no entry)
    gp = _pad_graph(data.graph, bundle.graph.n_padded)
    e_hi = int(gp.indptr[cs])
    host = rect_block_sparse(gp.dst[:e_hi], gp.src[:e_hi], gp.weight[:e_hi],
                             n_rows=cs, n_cols=gp.n, bs=plan.bs)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, err = {}, 0.0
    for name, t, n_in, n_out in (
            ("forward", "", plan.cols_padded, plan.rows_padded),
            ("backward", "_t", plan.rows_padded, plan.cols_padded)):
        arrays = _arrays(plan, t)
        nnz = int(arrays[0][-1])
        h = torch.randn(n_in, d, generator=gen, device=dev)
        tiles = _tiles(host, t, dev)

        def kern():
            return spmm_csr(*arrays, h)

        def plain():
            return spmm_csr_ref(*arrays, h)

        got = kern()
        err = max(err, _held(f"main-path {name} chunk (d={d}) vs tiles",
                             got, spmm_ref(*tiles, h, n_out=n_out)))
        err = max(err, _held(f"  vs the plain version on its arrays", got,
                             plain()))
        if not torch.equal(got, kern()):
            raise AssertionError(f"{name} chunk: a second launch differs "
                                 f"bitwise")
        a_csr = _csr_of_tiles(*tiles, n_out, n_in)
        del tiles

        def lib():
            return torch.sparse.mm(a_csr, h)

        lib_err = _held(f"  torch.sparse.mm (CSR of the tiles) vs kernel",
                        lib(), got)
        k_runs = [_device_ms(kern, 20), _device_ms(kern, 20)]
        k_ms = [t for t, _ in k_runs]
        memset_ms = min(m for _, m in k_runs)
        l_ms = [_device_ms(lib, 20)[0], _device_ms(lib, 20)[0]]
        ev_ms = _time_ms(kern, 20)
        p_ms = _time_ms(plain, 5)
        bound_ms, by, nbytes, flops = _spmm_bound(nnz, n_in, n_out, d)
        rows[name] = dict(
            ms=min(k_ms), ms_runs=k_ms, memset_ms=memset_ms,
            event_ms=ev_ms, plain_ms=p_ms,
            library_ms=min(l_ms), library_ms_runs=l_ms,
            library_err=lib_err, bound_ms=bound_ms, bound_by=by, nnz=nnz,
            n_in=n_in, n_out=n_out, bytes=nbytes, flops=flops)
        print(f"  {name} chunk: {nnz} nonzeros, {n_in}→{n_out} rows, d={d}:"
              f" kernel {k_ms[0]:.4f} / {k_ms[1]:.4f} ms device time, "
              f"the flags' memset {memset_ms:.4f} ms of it "
              f"({ev_ms:.4f} ms a call by CUDA events, host included), "
              f"plain {p_ms:.4f} ms, torch.sparse.mm {l_ms[0]:.4f} / "
              f"{l_ms[1]:.4f} ms device time; bound {bound_ms:.4f} ms by {by}"
              f" ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    return rows, err


# ---------------------------------------------------------------------------
# LM kernels and the Zamba2-2.7B path
# ---------------------------------------------------------------------------

FLASH_CASES = (
    # b, hq, hkv, sq, skv, hd, hdv, dtype, causal, window, softcap
    (2, 8, 8, 256, 256, 64, 64, torch.float32, True, None, None),
    (2, 8, 4, 300, 300, 80, 80, torch.float32, True, None, None),
    (1, 8, 2, 200, 333, 128, 128, torch.float32, False, None, None),
    (1, 8, 1, 257, 257, 256, 256, torch.float32, True, None, None),
    (2, 4, 2, 384, 384, 64, 64, torch.float32, True, 100, None),
    (2, 4, 4, 256, 256, 80, 80, torch.float32, True, None, 20.0),
    (1, 4, 2, 192, 192, 128, 64, torch.float32, True, None, None),
    (1, 4, 4, 130, 70, 64, 64, torch.float32, True, None, None),
    (2, 32, 32, 512, 512, 80, 80, torch.bfloat16, True, None, None),
    (1, 16, 2, 300, 300, 128, 128, torch.bfloat16, True, None, None),
    (1, 8, 4, 256, 400, 256, 256, torch.bfloat16, False, None, None),
    (1, 8, 2, 256, 256, 64, 32, torch.bfloat16, True, 64, 30.0),
    (2, 4, 2, 384, 384, 64, 64, torch.bfloat16, True, 100, None),
    (2, 4, 4, 256, 256, 80, 80, torch.bfloat16, True, None, 20.0),
    (1, 4, 2, 192, 192, 128, 64, torch.bfloat16, True, None, None),
    (1, 4, 4, 130, 70, 64, 64, torch.bfloat16, True, None, None),
    (1, 4, 2, 100, 100, 36, 20, torch.bfloat16, True, None, None),
    (1, 8, 1, 257, 257, 256, 256, torch.bfloat16, True, None, None),
)

SSD_CASES = (
    # b, s, h, p, n, q
    (2, 64, 4, 32, 32, 16),
    (2, 256, 3, 64, 64, 64),
    (1, 512, 5, 64, 128, 256),
    (2, 256, 2, 32, 128, 64),
    (1, 768, 4, 64, 64, 256),
    (2, 128, 8, 32, 64, 16),
)


def flash_cases(dev) -> float:
    """Phase 4; returns the largest max|Δ| over the cases."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd, flash_ref
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = []
    from repro_torch.kernels.flash_attn.flash import VARIANTS
    for b, hq, hkv, sq, skv, hd, hdv, dt, causal, win, cap in FLASH_CASES:
        q = torch.randn(b, hq, sq, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, skv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, skv, hdv, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=win, softcap=cap)
        before = dict(flash_attention_bhsd.launches_by_variant)
        got = flash_attention_bhsd(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = {key: n - before[key] for key, n in
               flash_attention_bhsd.launches_by_variant.items()}
        if ran != {key: int(key == VARIANTS[dt]) for key in ran}:
            raise AssertionError(f"{dt} case launched {ran}, expected the "
                                 f"{VARIANTS[dt]} kernel once")
        name = (f"{str(dt)[6:]} g={hq // hkv} {sq}x{skv} hd={hd}/{hdv} "
                f"{'causal' if causal else 'full'}"
                f"{f' win={win}' if win else ''}"
                f"{f' cap={cap:g}' if cap else ''}")
        want = flash_ref(q, k, v, **kw)
        errs.append(_held(name, got, want) if dt == torch.float32
                    else _held_bf16(name, got, want))
    return max(errs)


def _ssd_inputs(b, s, h, p, n, gen, dev):
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bm = torch.randn(b, s, n, generator=gen, device=dev) / math.sqrt(n)
    cm = torch.randn(b, s, n, generator=gen, device=dev) / math.sqrt(n)
    return x, dt, a, bm, cm


def ssd_cases(dev) -> float:
    """Phase 5; returns the largest max|Δ| over the cases."""
    from repro_torch.kernels.ssd import (ssd_chunked_fused, ssd_dense_ref,
                                         ssd_intra_chunk, ssd_intra_chunk_ref)
    from repro_torch.nn.ssm import ssd_chunked
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = []
    for b, s, h, p, n, q in SSD_CASES:
        args = _ssd_inputs(b, s, h, p, n, gen, dev)
        y, st = ssd_intra_chunk(*args, chunk=q)
        torch.cuda.synchronize()
        y_r, st_r = ssd_intra_chunk_ref(*args, chunk=q)
        name = f"B={b} S={s} H={h} P={p} N={n} Q={q}"
        errs.append(_held(f"{name} y_intra", y, y_r, SSD_TOL))
        errs.append(_held(f"{name} states", st, st_r, SSD_TOL))
    args = _ssd_inputs(2, 600, 4, 64, 64, gen, dev)
    y, final = ssd_chunked_fused(*args, 256)
    y_c, final_c = ssd_chunked(*args, 256)
    errs.append(_held("ssd_chunked_fused S=600 Q=256 vs ssd_chunked", y,
                      y_c, SSD_TOL))
    errs.append(_held("  final state vs ssd_chunked", final, final_c,
                      SSD_TOL))
    errs.append(_held("ssd_chunked_fused S=600 Q=256 vs ssd_dense_ref", y,
                      ssd_dense_ref(*args), SSD_TOL))
    return max(errs)


def _zero_lm_counts():
    from repro_torch.kernels.flash_attn import flash
    from repro_torch.kernels.ssd import ssd_intra_chunk
    flash.reset_launches()
    ssd_intra_chunk.launches = 0


def _read_lm_counts():
    """(flash launches, SSD launches) since the last zeroing; every flash
    launch of the bf16 model paths must be the tensor-core kernel's."""
    from repro_torch.kernels.flash_attn import flash_attention_bhsd as fl
    from repro_torch.kernels.ssd import ssd_intra_chunk
    if fl.launches != fl.launches_by_variant["mma_bf16"]:
        raise AssertionError(f"flash launches {fl.launches_by_variant} are "
                             f"not all the tensor-core kernel's")
    return fl.launches, ssd_intra_chunk.launches


def _plain_lm_kernels():
    """Both LM kernels' plain versions patched in on the card (the
    cross-check only; no entry point falls back to them)."""
    from contextlib import ExitStack

    from repro_torch.kernels.flash_attn import flash_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    stack = ExitStack()
    stack.enter_context(mock.patch.object(flash_ops, "flash_attention_bhsd",
                                          flash_ref))
    stack.enter_context(mock.patch.object(ssd_ops, "ssd_intra_chunk",
                                          ssd_intra_chunk_ref))
    return stack


def _expect(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: expected {want}, got {got}")


def serve(dev):
    """Phase 8: Zamba2-2.7B full width, bf16, generate + timing."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.transformer import init_transformer
    from repro_torch.params import tree_leaves
    from repro_torch.serve import generate, make_serve_fns

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), attn_impl="flash",
                              ssm_impl="fused")
    t0 = time.perf_counter()
    params = init_transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.num_layers} layers "
          f"({cfg.layer_kinds().count('mamba')} mamba2, "
          f"{cfg.layer_kinds().count('shared_attn')} shared attention), "
          f"d={cfg.d_model}, {n_params} parameters (fp32 on the card), "
          f"initialised in {time.perf_counter() - t0:.1f} s; compute "
          f"{cfg.dtype}")
    n_attn = cfg.layer_kinds().count("shared_attn")   # 9 flash launches
    batch = next(SyntheticLM(cfg.vocab_size, seed=0).batches(2, 2048))
    prompt, steps = batch["tokens"], 32

    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    t = time.perf_counter()
    res = generate(params, cfg, prompt, steps, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    counts = _read_lm_counts()
    print(f"  generate 2 × 2048 + {steps} greedy steps in {gen_s:.2f} s; "
          f"launches flash {counts[0]}, ssd {counts[1]}")
    _expect("generate launches (flash, ssd)", counts, (n_attn, 0))
    if res.tokens.shape != (2, 2048 + steps) or \
            not torch.isfinite(res.prefill_logits).all():
        raise AssertionError("generate: bad token shape or non-finite "
                             "prefill logits")
    print(f"  generated tokens {res.tokens[:, 2048:2048 + 8].tolist()} …")

    prefill_fn, decode_fn = make_serve_fns(cfg)
    tokens = torch.as_tensor(prompt, device=dev)
    pre_ms, dec_ms = [], []
    with torch.no_grad():
        for _ in range(3):
            _zero_lm_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = prefill_fn(params, tokens,
                                        max_len=2048 + steps + 1)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t) * 1e3)
            _expect("prefill launches (flash, ssd)", _read_lm_counts(),
                    (n_attn, 0))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        _zero_lm_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_logits, caches = decode_fn(params, tok, caches)
            tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t) * 1e3)
        _expect("decode launches over 32 steps (flash, ssd)",
                _read_lm_counts(), (0, 0))
        prof_dec = _profile(lambda: decode_fn(params, tok, caches),
                            "decode step")
        prof = _profile(lambda: prefill_fn(params, tokens,
                                           max_len=2048 + steps), "prefill")
    peak = torch.cuda.max_memory_allocated()
    pre, dec = statistics.median(pre_ms), statistics.median(dec_ms)
    tok_s = 2 * steps / (sum(dec_ms) / 1e3)
    print(f"  prefill {pre:.2f} ms (median of {pre_ms}); decode "
          f"{dec:.3f} ms per step (median of {steps}); {tok_s:.1f} "
          f"tokens/s over the decode steps (batch 2); prefill "
          f"{2 * 2048 / (pre / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    return cfg, params, batch, {
        "params": n_params, "generate_s": gen_s, "prefill_ms": pre,
        "prefill_ms_runs": pre_ms, "decode_ms": dec, "decode_ms_runs": dec_ms,
        "decode_tokens_per_s": tok_s, "peak_bytes": peak,
        "launches": {"flash": counts[0], "ssd": counts[1]}, "profile": prof,
        "profile_decode": prof_dec}


def score(cfg, params, batch, dev):
    """Phase 9: forward + lm_loss on 2 × 2048, under no_grad."""
    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev)

    def run():
        logits, _ = T.forward(params, cfg, tokens)
        return T.lm_loss(logits, targets)

    with torch.no_grad():
        _zero_lm_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = run().item()
        first_ms = (time.perf_counter() - t) * 1e3
        counts = _read_lm_counts()
        print(f"  scoring loss {loss:.6f} (log V = "
              f"{math.log(cfg.vocab_size):.4f}); launches flash "
              f"{counts[0]}, ssd {counts[1]}; first call {first_ms:.1f} ms")
        kinds = cfg.layer_kinds()
        _expect("scoring launches (flash, ssd)", counts,
                (kinds.count("shared_attn"), kinds.count("mamba")))
        if not math.isfinite(loss):
            raise AssertionError(f"scoring loss not finite: {loss}")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run().item()
            ms.append((time.perf_counter() - t) * 1e3)
        prof = _profile(run, "scoring forward")
        with _plain_lm_kernels():
            loss_plain = run().item()
    print(f"  scoring {statistics.median(ms):.2f} ms (median of {ms}); "
          f"{2 * 2048 / (statistics.median(ms) / 1e3):.0f} tokens/s; bf16 "
          f"loss kernel vs plain versions |Δ|={abs(loss - loss_plain):.3e} "
          f"(plain {loss_plain:.6f}; not gated)")
    return {"loss": loss, "loss_plain": loss_plain, "ms": statistics.median(ms),
            "ms_runs": ms, "launches": {"flash": counts[0], "ssd": counts[1]},
            "profile": prof}


def cross_check_fp32(cfg, params, batch, dev) -> float:
    """Phase 10: the kernel path against the plain versions, fp32."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompt = batch["tokens"][:1, :512]
    tokens = torch.as_tensor(prompt, device=dev)
    targets = torch.as_tensor(batch["targets"][:1, :512], device=dev)

    def run():
        res = generate(params, cfg32, prompt, 8, device=dev)
        with torch.no_grad():
            logits, _ = T.forward(params, cfg32, tokens)
            loss = T.lm_loss(logits, targets).item()
        return res, loss

    res_k, loss_k = run()
    with _plain_lm_kernels():
        res_p, loss_p = run()
    err = _held("fp32 prefill logits 1×512, kernels vs plain",
                res_k.prefill_logits, res_p.prefill_logits, PATH_RTOL, 0.0)
    if not np.array_equal(res_k.tokens, res_p.tokens):
        raise AssertionError(f"fp32 greedy tokens differ: "
                             f"{res_k.tokens[:, 512:]} vs "
                             f"{res_p.tokens[:, 512:]}")
    print(f"  fp32 greedy tokens identical over 8 steps: "
          f"{res_k.tokens[0, 512:].tolist()}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  fp32 scoring loss 1×512: kernels {loss_k:.7f}, plain "
          f"{loss_p:.7f}, relative |Δ| {rel:.2e}  "
          f"{'ok' if rel <= 1e-5 else 'FAIL'}")
    if rel > 1e-5:
        raise AssertionError(f"fp32 scoring loss differs by {rel:.2e}")
    return err


def lm_timing(dev):
    """Phase 11: one flash and one SSD launch at the LM path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import flash_attention_bhsd, flash_ref
    from repro_torch.kernels.ssd import ssd_intra_chunk, ssd_intra_chunk_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    b, h, s, hd = 2, 32, 2048, 80
    q32, k32, v32 = (torch.randn(b, h, s, hd, generator=gen, device=dev)
                     for _ in range(3))
    err = _held("flash at (2,32,2048,80) fp32 causal vs plain",
                flash_attention_bhsd(q32, k32, v32), flash_ref(q32, k32, v32))
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    del q32, k32, v32
    err = max(err, _held_bf16("flash at (2,32,2048,80) bf16 causal vs plain",
                              flash_attention_bhsd(q, k, v),
                              flash_ref(q, k, v)))
    lib_err = _held("  scaled_dot_product_attention vs kernel",
                    F.scaled_dot_product_attention(q, k, v, is_causal=True)
                    .float(), flash_attention_bhsd(q, k, v).float(),
                    SDPA_TOL)
    pairs = s * (s + 1) // 2
    flops = b * h * pairs * 2 * (hd + hd)
    nbytes = 2 * 4 * b * h * s * hd
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_bf16 = flops / PEAK_BF16_FLOP_PER_S * 1e3
    t_fp32 = flops / PEAK_FP32_FLOP_PER_S * 1e3
    k_ms = _time_ms(lambda: flash_attention_bhsd(q, k, v), 10)
    p_ms = _time_ms(lambda: flash_ref(q, k, v), 3)
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    k_ms2 = _time_ms(lambda: flash_attention_bhsd(q, k, v), 10)
    bound = max(t_bytes, t_bf16)
    rows["flash"] = dict(
        ms=min(k_ms, k_ms2), ms_runs=[k_ms, k_ms2], plain_ms=p_ms,
        library_ms=l_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_bf16 else "operations",
        bytes=nbytes, flops=flops, bound_fp32_ms=t_fp32, max_abs_err=err,
        library_err=lib_err)
    print(f"  flash (2,32,2048,80) bf16 causal: kernel {k_ms:.4f} / "
          f"{k_ms2:.4f} ms, plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms; "
          f"bound {bound:.4f} ms by operations at the bf16 tensor-core "
          f"peak ({flops / 1e9:.2f} GFLOP; {t_fp32:.4f} ms at the fp32 "
          f"peak; bytes {nbytes / 1e6:.1f} MB, {t_bytes:.4f} ms)")

    bsz, s, h, p, n, qc = 2, 2048, 80, 64, 64, 256
    args = _ssd_inputs(bsz, s, h, p, n, gen, dev)
    y, st = ssd_intra_chunk(*args, chunk=qc)
    y_r, st_r = ssd_intra_chunk_ref(*args, chunk=qc)
    err = max(_held("ssd at (2,2048,80,64) N=64 Q=256 y_intra vs plain", y,
                    y_r, SSD_TOL),
              _held("  states vs plain", st, st_r, SSD_TOL))
    nc = s // qc
    tri = qc * (qc + 1) // 2
    flops = bsz * nc * (h * (2 * tri * p + 2 * qc * p * n) + 2 * tri * n)
    nbytes = 4 * (2 * bsz * s * h * p + bsz * s * h + h + 2 * bsz * s * n
                  + bsz * nc * h * p * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    k_ms = _time_ms(lambda: ssd_intra_chunk(*args, chunk=qc), 10)
    p_ms = _time_ms(lambda: ssd_intra_chunk_ref(*args, chunk=qc), 3)
    k_ms2 = _time_ms(lambda: ssd_intra_chunk(*args, chunk=qc), 10)
    bound = max(t_bytes, t_ops)
    rows["ssd"] = dict(
        ms=min(k_ms, k_ms2), ms_runs=[k_ms, k_ms2], plain_ms=p_ms,
        library_ms=None, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops, max_abs_err=err)
    print(f"  ssd (2,2048,80,64) N=64 Q=256: kernel {k_ms:.4f} / "
          f"{k_ms2:.4f} ms, plain {p_ms:.4f} ms; bound {bound:.4f} ms by "
          f"{rows['ssd']['bound_by']} ({flops / 1e9:.3f} GFLOP fp32 in the "
          f"lower-triangular products and the states, {t_ops:.4f} ms; "
          f"{nbytes / 1e6:.1f} MB, {t_bytes:.4f} ms)")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on a CUDA GPU only", file=sys.stderr)
        return 1
    import torch.distributed as dist
    from repro_torch.kernels import build as kbuild

    print("[1/11] device")
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

    print("[2/11] build")
    t0 = time.perf_counter()
    kbuild.build()
    build_s = time.perf_counter() - t0
    print(f"  {', '.join(p.name for p in kbuild.SOURCES)} built (sm_90a, "
          f"one load, one nvcc per source) in {build_s:.1f} s")

    print("[3/11] spmm kernel against its plain version")
    spmm_err = kernel_cases(dev)
    print("[4/11] flash kernel against its plain version")
    flash_err = flash_cases(dev)
    print("[5/11] ssd kernel against its plain version")
    ssd_err = ssd_cases(dev)

    print("[6/11] GCN main path: decoupled-pipelined TP GCN training")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        bundle, data, launches, step_ms, profile = train(dev)
        print("[7/11] spmm timing at the GCN path's shapes")
        rows, path_err = timing(bundle, data, dev)
    finally:
        dist.destroy_process_group()
    del bundle, data
    torch.cuda.empty_cache()

    print("[8/11] LM main path, serving: Zamba2-2.7B generate")
    cfg, params, batch, serve_info = serve(dev)
    print("[9/11] LM main path, scoring: forward + lm_loss")
    score_info = score(cfg, params, batch, dev)
    print("[10/11] fp32 cross-check at full width, kernels vs plain")
    fp32_err = cross_check_fp32(cfg, params, batch, dev)
    del params
    torch.cuda.empty_cache()
    print("[11/11] flash and ssd timing at the LM path's shapes")
    lm_rows = lm_timing(dev)

    fwd, bwd = rows["forward"], rows["backward"]
    fl, sd = lm_rows["flash"], lm_rows["ssd"]
    print(json.dumps({"timing": rows, "step_ms": step_ms, "profile": profile,
                      "build_s": build_s, "serve": serve_info,
                      "score": score_info, "lm_timing": lm_rows,
                      "fp32_logits_err": fp32_err,
                      "card": card}))
    print(json.dumps({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm_csr.cu",
        "replaces": "src/repro/kernels/spmm/spmm.py:64",
        "held_against": "ref.spmm_ref (tiles), ref.spmm_csr_ref",
        "launches": launches, "max_abs_err": max(spmm_err, path_err),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "ms_by": "profiler",
        "event_ms": fwd["event_ms"], "backward_ms": bwd["ms"],
        "backward_library_ms": bwd["library_ms"]}, {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attn/flash.py:105",
        "held_against": "ref.flash_ref",
        "launches": serve_info["launches"]["flash"]
        + score_info["launches"]["flash"],
        "max_abs_err": max(flash_err, fl["max_abs_err"]),
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"], "ms_by": "events"}, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:61",
        "held_against": "ref.ssd_intra_chunk_ref",
        "launches": serve_info["launches"]["ssd"]
        + score_info["launches"]["ssd"],
        "max_abs_err": max(ssd_err, sd["max_abs_err"]),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": None, "ms_by": "events"}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
