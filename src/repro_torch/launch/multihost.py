"""Multi-host full-graph GNN training over ``torch.distributed``.

One program, run once per process; every process executes the same code
on the same seed and drives one device.  The flow is the single-host
path — mesh from ``runtime.mesh`` (:class:`~repro_torch.runtime.TPMesh` /
:func:`~repro_torch.runtime.hybrid_mesh` over the whole world), bundle
from ``prepare_bundle``/``prepare_dp_bundle`` placed per rank (``mesh=``),
train step from ``make_tp_train_fns`` / ``make_dp_train_fns`` — with one
step in front: :func:`repro_torch.runtime.distributed.initialize`.

Process topology — env contract (CLI flags override)
----------------------------------------------------

Every process of the job exports::

    COORDINATOR_ADDRESS=<host:port>   # the rank-0 host; all connect to it
    NUM_PROCESSES=<N>                 # identical on every process
    PROCESS_ID=<i>                    # distinct, 0..N-1; 0 = coordinator
    DIST_INIT_TIMEOUT=<seconds>       # optional connect timeout (60)

and runs ``python -m repro_torch.launch.multihost <workload args>``: one
process per GPU with NCCL (``--device cuda``, the default), or gloo on
CPU processes (``--device cpu``).  ``scripts/launch_multihost_torch.sh``
spawns N processes on one machine with a localhost coordinator.

Flags and output are the reference's (``repro.launch.multihost``), plus
``--device``: a process drives the device it names, where a JAX process
takes whatever devices its backend has.  The graph is the same
``sbm_power_law``, aggregated by segment sums (the default backend), so
no kernel runs.  Output is coordinator-only: process 0 prints the
``# multihost:`` header, one ``epoch,i,loss,ms`` row per epoch and a
final ``RESULT {json}`` line; the other processes run the same program
silently.
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="multi-host full-graph GNN training "
                    "(torch.distributed; env contract in module docstring)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: "
                         "$COORDINATOR_ADDRESS)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total processes in the job (default: "
                         "$NUM_PROCESSES, else 1)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (default: $PROCESS_ID)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="distributed-init timeout seconds (default: "
                         "$DIST_INIT_TIMEOUT, else 60)")
    ap.add_argument("--mode", default="decoupled_pipelined",
                    choices=["decoupled", "decoupled_pipelined", "naive",
                             "dp"])
    ap.add_argument("--backend", default="explicit",
                    choices=["explicit", "constraint"])
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    ap.add_argument("--data", type=int, default=1,
                    help="replica-group count: hybrid (data, model) mesh "
                         "with model = processes/data; 1 = pure TP")
    ap.add_argument("--pod", type=int, default=1,
                    help="pod axis degree for 3-axis meshes")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--feat-dim", type=int, default=128)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=7,
                    help="graph/param seed — identical on every process "
                         "(each builds the same host data and keeps only "
                         "its own rows)")
    ap.add_argument("--device", default="cuda",
                    help="this process's device: cuda (NCCL; card "
                         "PROCESS_ID modulo the visible cards) or cpu "
                         "(gloo)")
    return ap.parse_args(argv)


def build(args, mesh, device):
    """(train_step, evaluate, params) of the job on ``mesh``: the same on
    every process, from ``args.seed``."""
    import torch

    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.gnn import dp_baseline as DP
    from repro_torch.gnn import models as M
    from repro_torch.graph import sbm_power_law
    from repro_torch.runtime import distributed as dist

    data = sbm_power_law(n=args.n, num_classes=args.classes,
                         feat_dim=args.feat_dim,
                         avg_degree=args.avg_degree, seed=args.seed)
    opt = optim.adamw(args.lr)
    if args.mode == "dp":
        bundle = DP.prepare_dp_bundle(data, mesh=mesh, device=device)
        cfg = M.GNNConfig(model=args.model, in_dim=args.feat_dim,
                          hidden_dim=args.hidden,
                          num_classes=args.classes,
                          num_layers=args.layers, decoupled=False)
        fns = DP.make_dp_train_fns(cfg, bundle, mesh, opt,
                                   backend=args.backend)
    else:
        bundle = D.prepare_bundle(data, n_chunks=args.chunks, mesh=mesh,
                                  device=device)
        cfg = D.padded_gnn_config(data, bundle, model=args.model,
                                  hidden_dim=args.hidden,
                                  num_layers=args.layers)
        fns = D.make_tp_train_fns(cfg, bundle, mesh, opt, mode=args.mode,
                                  backend=args.backend)
    params = dist.replicate(M.init_params(
        cfg, torch.Generator().manual_seed(args.seed), "cpu"), mesh, device)
    return fns + (params, opt)


def run(args) -> dict:
    """Join the job (env contract and flags), train ``args.epochs`` steps,
    leave it; returns this process's result: the ``RESULT`` line's keys
    and every epoch's loss (``losses``)."""
    from repro_torch.runtime import distributed as dist

    ctx = dist.initialize(coordinator_address=args.coordinator,
                          num_processes=args.num_processes,
                          process_id=args.process_id,
                          timeout=args.timeout, device=args.device)
    try:
        return _train(args, ctx)
    finally:
        dist.shutdown()


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


def _train(args, ctx) -> dict:
    import torch

    from repro_torch.runtime import TPMesh, hybrid_mesh

    mesh = (hybrid_mesh(data=args.data, pod=args.pod)
            if args.data > 1 or args.pod > 1 else TPMesh())
    shape = {**{a: mesh.shape[a] for a in mesh.data_axes},
             mesh.axis: mesh.size}
    say = print if ctx.is_coordinator else (lambda *a, **k: None)
    say(f"# multihost: {ctx.num_processes} processes × "
        f"{ctx.local_device_count} local device = "
        f"{ctx.global_device_count} global; mesh {shape} mode={args.mode} "
        f"backend={args.backend} device={ctx.device}", flush=True)

    step, evaluate, params, opt = build(args, mesh, ctx.device)
    cuda = torch.device(ctx.device).type == "cuda"
    p, o = params, opt.init(params)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        te = time.perf_counter()
        p, o, loss = step(p, o)
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize()
        say(f"epoch,{epoch},{losses[-1]:.6f},"
            f"{(time.perf_counter() - te) * 1e3:.1f}ms", flush=True)
    wall = time.perf_counter() - t0
    _, acc = evaluate(p, "train")
    result = {
        "processes": ctx.num_processes,
        "local_devices": ctx.local_device_count,
        "global_devices": ctx.global_device_count,
        "mesh": shape, "mode": args.mode,
        "backend": args.backend, "model": args.model,
        "epochs": args.epochs, "loss_first": losses[0],
        "loss_last": losses[-1], "train_acc": acc.item(),
        "wall_s": wall,
    }
    say("RESULT " + json.dumps(result), flush=True)
    return {**result, "losses": losses}


if __name__ == "__main__":
    raise SystemExit(main())
