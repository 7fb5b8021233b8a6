"""Quickstart of the PyTorch port: NeutronTP GNN tensor parallelism in
~60 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

Runs on one device over a 1-rank process group (the collectives
degenerate); for a real multi-worker run, launch it with ``torchrun``:

    PYTHONPATH=src torchrun --nproc_per_node 4 examples/quickstart_torch.py
"""
import argparse

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.core import decouple as D
from repro_torch.gnn import models as M
from repro_torch.graph import sbm_power_law
from repro_torch.runtime import TPMesh
from train_gcn_full_graph_torch import init_group


def main(device: str):
    n_workers = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *_: None)
    say(f"workers: {n_workers}")

    # 1. a synthetic power-law graph with planted communities
    data = sbm_power_law(n=4096, num_classes=8, feat_dim=64,
                         avg_degree=12, seed=0)
    say(f"graph: {data.graph.n} vertices, {data.graph.e} edges")

    # 2. NeutronTP bundle: graph replicated, features dim-shardable,
    #    chunk schedule + per-chunk communication plan precomputed
    bundle = D.prepare_bundle(data, n_workers=n_workers, n_chunks=4,
                              device=device)

    # 3. a decoupled 2-layer GCN (paper §4.1) trained with tensor
    #    parallelism: L NN rounds → split → L aggregations → gather
    cfg = D.padded_gnn_config(data, bundle, model="gcn", hidden_dim=64,
                              num_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device)
    opt = optim.adamw(1e-2)
    train_step, evaluate = D.make_tp_train_fns(
        cfg, bundle, TPMesh(), opt, mode="decoupled_pipelined")

    opt_state = opt.init(params)
    for epoch in range(1, 51):
        params, opt_state, loss = train_step(params, opt_state)
        if epoch % 10 == 0:
            _, val_acc = evaluate(params, "val")
            say(f"epoch {epoch:3d}  loss {loss.item():.4f}  "
                f"val acc {val_acc.item():.3f}")
    _, test_acc = evaluate(params, "test")
    say(f"test accuracy: {test_acc.item():.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = init_group(ap.parse_args().device)
    try:
        main(device)
    finally:
        dist.destroy_process_group()
