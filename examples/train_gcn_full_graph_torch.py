"""End-to-end run of the PyTorch port: distributed full-graph GCN/GAT
training (the paper's workload) with NeutronTP tensor parallelism.

    PYTHONPATH=src python examples/train_gcn_full_graph_torch.py \
        [--model gcn] [--n 20000] [--epochs 100] \
        [--mode decoupled_pipelined] [--device cuda]

Launched alone it trains on one device over a 1-rank process group.
Launched by ``torchrun`` (``PYTHONPATH=src torchrun --nproc_per_node 4
examples/train_gcn_full_graph_torch.py``) its ranks train together: NCCL
with one card each, gloo with ``--device cpu``.  Trains on a Reddit-like
synthetic graph (power-law SBM, 41 classes — Table 1 proportions), logs
epoch time and accuracy, saves and restores a checkpoint, and reports the
per-worker balance property.
"""
import argparse
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint, optim
from repro_torch.core import decouple as D
from repro_torch.gnn import models as M
from repro_torch.graph import sbm_power_law
from repro_torch.runtime import TPMesh


def init_group(device: str, single_device: bool = False) -> str:
    """Open the process group and return this rank's device: the world
    ``torchrun`` started (its ``RANK``/``WORLD_SIZE`` environment), else —
    or with ``single_device`` — one rank on a free local port.  NCCL for a
    CUDA device, gloo for the CPU."""
    cuda = device.startswith("cuda")
    launched = "WORLD_SIZE" in os.environ and not single_device
    if cuda:
        dev = torch.device(device)
        if launched:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        device = str(dev)
    backend = "nccl" if cuda else "gloo"
    if launched:
        dist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    return device


def train(args, device: str) -> None:
    k, rank = dist.get_world_size(), dist.get_rank()

    def say(text):
        if rank == 0:
            print(text, flush=True)

    say(f"devices: {k}  mode: {args.mode}")
    data = sbm_power_law(n=args.n, num_classes=args.classes,
                         feat_dim=args.feat_dim, avg_degree=12, seed=0)
    say(f"graph: V={data.graph.n} E={data.graph.e} "
        f"ftr={args.feat_dim} classes={args.classes}")

    bundle = D.prepare_bundle(data, n_workers=k, n_chunks=args.chunks,
                              device=device)
    cfg = D.padded_gnn_config(data, bundle, model=args.model,
                              hidden_dim=args.hidden,
                              num_layers=args.layers)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device)
    opt = optim.adamw(args.lr, weight_decay=5e-4)
    train_step, evaluate = D.make_tp_train_fns(cfg, bundle, TPMesh(), opt,
                                               mode=args.mode)
    opt_state = opt.init(params)

    # the paper's load-balance property, by construction:
    say(f"per-worker aggregation load: E×D/N = "
        f"{data.graph.e}×{cfg.hidden_dim}/{k} on every worker "
        f"(imbalance 1.00)")

    times = []
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state)
        if device.startswith("cuda"):
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        if epoch % max(1, args.epochs // 10) == 0:
            _, va = evaluate(params, "val")
            say(f"epoch {epoch:4d}  loss {loss.item():.4f}  "
                f"val {va.item():.3f}  {times[-1]*1e3:.0f} ms/epoch")

    _, test_acc = evaluate(params, "test")
    say(f"test accuracy: {test_acc.item():.3f}  "
        f"median epoch: {np.median(times)*1e3:.0f} ms")

    # the parameters are replicated: rank 0 writes, every rank restores
    if rank == 0:
        checkpoint.save(args.ckpt, params,
                        metadata={"model": args.model,
                                  "test_acc": test_acc.item()})
    dist.barrier()
    restored = checkpoint.restore(args.ckpt, params)
    _, acc2 = evaluate(restored, "test")
    if abs(acc2.item() - test_acc.item()) >= 1e-6:
        raise RuntimeError(f"test accuracy {acc2.item()} after the "
                           f"checkpoint round trip, {test_acc.item()} "
                           f"before")
    say(f"checkpoint round-trip OK → {args.ckpt}.npz")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat",
                                                       "sage", "gin"])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--feat-dim", type=int, default=302)
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--mode", default="decoupled_pipelined",
                    choices=["decoupled", "decoupled_pipelined", "naive"])
    ap.add_argument("--ckpt", default="results/gcn_full_graph")
    ap.add_argument("--single-device", action="store_true",
                    help="one rank, even under torchrun")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = init_group(args.device, args.single_device)
    try:
        train(args, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
