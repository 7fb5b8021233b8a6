#!/usr/bin/env python3
"""The port's multihost path on N GPUs of one machine, one process a card
over NCCL: the placement, the ledger and the audit at N > 1, which
``chip_smoke.py`` on one card cannot reach.

    scripts/launch_multihost_torch.sh -n 4 -t 900 -- \\
        python3 scripts/torch_multihost_nccl.py [--out FILE]

Every process joins through the env contract
(``runtime/distributed.py::initialize``), builds ``reddit_like(scale=1.0,
seed=0)`` (V = 23 000, 602 features, 41 classes) and runs four paths,
each on bundles placed per rank (``mesh=``; blocksparse at bs=128, 4
chunks): GCN decoupled-pipelined, naive and the DP halo-exchange
baseline on the pure-TP mesh of all N ranks, and GCN decoupled-pipelined
on a hybrid (data=2, model=N/2) mesh; hidden 128, 2 layers, AdamW.  Per
path and rank:

* the placed node arrays' rows and bytes, against the unplaced bundle's;
* 3 warm-up + 10 timed steps: finite, falling loss, the median step
  (host clock around ``torch.cuda.synchronize``), SpMM launches a step;
* one step audited (``analysis/audit.py``: the profiler's census against
  the ledger, clean, the backward's collectives on autograd's thread) and
  its ledger's wire bytes;
* step 0's loss and grads against the single-device forward of the whole
  graph on the rank's own card in float64 (``decoupled_forward`` /
  ``coupled_forward``; on the unpadded graph for DP): the loss within
  rtol 1e-6, each grad per tensor within 1e-3·max|ref|.  The grads'
  tolerance is wider than the loss's because of ReLU's kink: a
  pre-activation within rounding of 0 takes either side of it depending
  on the order of a sum, and one such flip moves a first-layer weight
  gradient by one vertex's contribution — far more than float32
  rounding, while the loss, continuous there, hardly moves.  Against a
  float32 single-device step, which sums in yet another order, the
  first-layer gradients of a path can flip for that reason alone.

Every rank writes its results next to ``--out``; after a barrier rank 0
holds the ledgers equal across ranks, prints one JSON line with the
card's name and power limit, and writes ``--out``.  Exits non-zero if a
hold fails.  ``--device cpu --scale 0.02`` runs the same on gloo
processes (a rehearsal on the host).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-3      # module docstring: ReLU-kink flips
PATHS = ("decoupled_pipelined", "naive", "dp", "hybrid_decoupled_pipelined")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bundle(path, data, mesh, dev):
    from repro_torch.core import decouple as D
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M

    kw = dict(agg="blocksparse", agg_block_size=128, device=dev)
    if path == "dp":
        bundle = DP.prepare_dp_bundle(data, mesh=mesh, **kw)
        cfg = M.GNNConfig(in_dim=data.features.shape[1], hidden_dim=128,
                          num_classes=data.num_classes, num_layers=2)
    else:
        bundle = D.prepare_bundle(data, mesh=mesh, n_chunks=4, **kw)
        cfg = D.padded_gnn_config(data, bundle, hidden_dim=128,
                                  num_layers=2)
    return bundle, cfg


def _fns(path, cfg, bundle, mesh, opt=None):
    from repro_torch.core import decouple as D
    from repro_torch.gnn import dp_baseline as DP
    if path == "dp":
        return (DP.make_dp_value_and_grad(cfg, bundle, mesh) if opt is None
                else DP.make_dp_train_fns(cfg, bundle, mesh, opt))
    mode = "naive" if path == "naive" else "decoupled_pipelined"
    return (D.make_tp_value_and_grad(cfg, bundle, mesh, mode=mode)
            if opt is None
            else D.make_tp_train_fns(cfg, bundle, mesh, opt, mode=mode))


def _single_device(path, data, cfg, mesh, dev):
    """params → (loss, grads) of the path's model on the whole graph on
    this rank's card, in float64."""
    from repro_torch.core import decouple as D
    from repro_torch.gnn import layers as L
    from repro_torch.gnn import models as M
    from repro_torch.params import tree_leaves, tree_map
    if path == "dp":
        edges = L.edge_list_dev(data.graph, dev)
        x, labels, mask = (torch.from_numpy(a).to(dev) for a in (
            data.features, data.labels.astype(np.int64),
            data.train_mask.astype(np.float32)))
    else:
        whole = D.prepare_bundle(data, n_workers=mesh.size, n_chunks=4,
                                 n_replicas=mesh.data_size, device=dev)
        edges, x, labels, mask = (whole.graph.edges, whole.features,
                                  whole.labels, whole.train_mask)
    edges = dataclasses.replace(edges, weight=edges.weight.double())
    x, mask = x.double(), mask.double()
    fwd = M.coupled_forward if path in ("naive", "dp") else \
        M.decoupled_forward

    def vg(params):
        p = tree_map(lambda t: t.double().requires_grad_(), params)
        loss_sum, _, cnt = M.masked_loss_and_acc(fwd(p, cfg, edges, x),
                                                 labels, mask,
                                                 data.num_classes)
        loss = loss_sum / torch.clamp(cnt, min=1.0)
        return loss, torch.autograd.grad(loss, tree_leaves(p),
                                         allow_unused=True,
                                         materialize_grads=True)

    return vg


def run_path(path, data, dev) -> dict:
    from repro_torch import optim
    from repro_torch.analysis import audit as A
    from repro_torch.core import decouple as D
    from repro_torch.gnn import models as M
    from repro_torch.kernels.spmm import spmm_csr
    from repro_torch.params import tree_leaves
    from repro_torch.runtime import TPMesh, hybrid_mesh
    from repro_torch.runtime.telemetry import collect_comm

    mesh = (hybrid_mesh(data=2) if path.startswith("hybrid")
            else TPMesh())
    t0 = time.perf_counter()
    bundle, cfg = _bundle(path, data, mesh, dev)
    _sync(dev)
    prep_s = time.perf_counter() - t0
    rows = bundle.features.shape[-2] if path == "dp" else \
        bundle.features.shape[0]
    placed = D.node_array_bytes(bundle)
    if path == "dp":
        g = bundle.graph
        whole_rows = g.k * g.n_local_max
        per_row = 4 * data.features.shape[1] + 8 + 12
    else:
        whole_rows, per_row = bundle.n_padded, \
            4 * bundle.in_dim_padded + 8 + 12
    params0 = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = optim.adamw(1e-2, weight_decay=5e-4)
    step, _ = _fns(path, cfg, bundle, mesh, opt)
    params, state = params0, opt.init(params0)
    losses, ms = [], []
    spmm_csr.launches = 0
    for _ in range(13):
        _sync(dev)
        t = time.perf_counter()
        params, state, loss = step(params, state)
        losses.append(loss.item())
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    launches = spmm_csr.launches
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{path}: losses {losses}")
    with collect_comm() as ledger:
        _, census = A.census(step, params, state)
    A.assert_clean(census, ledger, tag=path)
    if dev.type == "cuda" and set(census.threads.get("backward", ())) & \
            set(census.threads.get("forward", ())):
        raise AssertionError(f"{path}: backward collectives on the "
                             f"caller's thread {census.threads}")
    # step 0 against one device holding the whole graph, in float64
    got = _fns(path, cfg, bundle, mesh)(params0, bundle.train_mask)
    want = _single_device(path, data, cfg, mesh, dev)(params0)
    diffs = []
    for i, (a, b, tol) in enumerate(
            [(got[0], want[0], LOSS_RTOL)]
            + [(a, b, GRAD_RTOL) for a, b in zip(tree_leaves(got[1]),
                                                   want[1])]):
        ref = b.abs().max().item()
        diff = (a.double() - b).abs().max().item() / ref
        if diff > tol:
            raise AssertionError(f"{path}: step-0 tensor {i} differs from "
                                 f"one device by {diff:.3e}·max|ref|")
        diffs.append(diff)
    return {"mesh": {a: mesh.shape[a] for a in mesh.data_axes}
            | {mesh.axis: mesh.size},
            "rows": rows, "whole_rows": whole_rows,
            "placed_bytes": placed, "unplaced_bytes": whole_rows * per_row,
            "prepare_s": prep_s, "launches_per_step": launches / 13,
            "median_ms": statistics.median(ms[3:]), "step_ms": ms,
            "loss_first": losses[0], "loss_last": losses[-1],
            "census": census.as_dict(), "threads": census.threads,
            "ledger": ledger.as_dict(),
            "wire_bytes_train": ledger.wire_bytes(train=True),
            "rel_diff_vs_single_device_f64": diffs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "multihost_nccl.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    from repro_torch.graph.synthetic import reddit_like
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = dist.initialize(device=args.device)
    dev = torch.device(ctx.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        data = reddit_like(scale=args.scale, seed=0)
        res = {"process_id": ctx.process_id,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
        for path in PATHS:
            res[path] = run_path(path, data, dev)
        Path(f"{out}.rank{ctx.process_id}").write_text(json.dumps(res))
        # the barrier: every rank's file is written
        C.psum(torch.zeros(1, device=dev), axis="barrier")
        _sync(dev)
        if not ctx.is_coordinator:
            return 0
        ranks = [json.loads(Path(f"{out}.rank{r}").read_text())
                 for r in range(ctx.num_processes)]
        for path in PATHS:
            ledgers = [r[path]["ledger"] for r in ranks]
            if any(led != ledgers[0] for led in ledgers):
                raise AssertionError(f"{path}: the ranks' ledgers differ")
        card = (subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
            if dev.type == "cuda" else "cpu")
        summary = {"processes": ctx.num_processes, "card": card,
                   "ranks": ranks}
        out.write_text(json.dumps(summary))
        for path in PATHS:
            r0 = ranks[0][path]
            print(f"{path}: mesh {r0['mesh']}; rows {r0['rows']} of "
                  f"{r0['whole_rows']}, {r0['placed_bytes']} node-array "
                  f"bytes a rank against {r0['unplaced_bytes']} unplaced; "
                  f"{r0['launches_per_step']:.0f} SpMM launches a step; "
                  f"median step by rank "
                  f"{[round(r[path]['median_ms'], 2) for r in ranks]} ms; "
                  f"{r0['wire_bytes_train']:.0f} wire bytes a step a rank; "
                  f"census {r0['census']}; step 0 against one device in "
                  f"float64, loss then grads, worst rank: "
                  f"{[f'{max(d):.1e}' for d in zip(*(r[path]['rel_diff_vs_single_device_f64'] for r in ranks))]}; "
                  f"{card}")
        print(json.dumps({p: {k: ranks[0][p][k] for k in (
            "median_ms", "wire_bytes_train", "placed_bytes",
            "unplaced_bytes", "launches_per_step")} for p in PATHS}))
        return 0
    finally:
        dist.shutdown()


if __name__ == "__main__":
    sys.exit(main())
