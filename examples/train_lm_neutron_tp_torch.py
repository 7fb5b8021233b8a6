"""Train a decoder LM with the paper's technique carried to sequence models:
token-sharded NN phase, head-sharded mixing phase, the transitions as
all-to-alls — the ``neutron_tp`` strategy — on a (data, model) mesh of
processes.

    PYTHONPATH=src python examples/train_lm_neutron_tp_torch.py \
        --device cpu --steps 20                  # 8 gloo processes
    PYTHONPATH=src python examples/train_lm_neutron_tp_torch.py \
        --device cpu --model 2 --data 2 --explicit
    scripts/launch_multihost_torch.sh -n 8 -- python3 \
        examples/train_lm_neutron_tp_torch.py    # one process per card

The port of ``examples/train_lm_neutron_tp.py``, with the same flags
(``--steps --batch --seq --full --strategy``) and mesh (data=2, model=4),
plus ``--model``/``--data`` (the mesh), ``--explicit`` (the explicit
sharder: the paper's all-to-alls, ring attention and expert-parallel MoE
by hand) and ``--device`` (default ``cuda``).  Under the env contract of
``repro_torch.launch.multihost`` (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``) each process is one rank; without it
the script starts data·model processes itself on a free localhost port.
``--strategy megatron`` is not ported and raises, naming its ROADMAP item.
"""
import argparse
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch import optim
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.runtime import distributed
from repro_torch.sharding import (MEGATRON_ITEM, ExplicitSharder, Sharder,
                                  ShardingRules)
from repro_torch.train import init_sharded_state, make_train_step


def small_cfg(full: bool) -> ArchConfig:
    if full:  # ~100M params
        return ArchConfig(name="lm-100m", arch_type="dense", num_layers=10,
                          d_model=640, num_heads=8, num_kv_heads=4,
                          d_ff=2560, vocab_size=32768, dtype="float32")
    return ArchConfig(name="lm-tiny", arch_type="dense", num_layers=4,
                      d_model=256, num_heads=8, num_kv_heads=4,
                      d_ff=1024, vocab_size=4096, dtype="float32")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--strategy", default="neutron_tp",
                    choices=["neutron_tp", "megatron", "dp"])
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--explicit", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, coordinator=None, process_id=None) -> None:
    """One rank's training loop (rank 0 prints)."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    ctx = distributed.initialize(
        coordinator, args.model * args.data if coordinator else None,
        process_id, device=args.device)
    try:
        cfg = small_cfg(args.full)
        mesh = make_host_mesh(model=args.model, data=args.data)
        rules = ShardingRules(strategy=args.strategy, data_axes=("data",))
        sharder = (ExplicitSharder if args.explicit else Sharder)(
            mesh=mesh, rules=rules)
        lead = ctx.process_id == 0
        if lead:
            print(f"arch {cfg.name}: ~{cfg.param_count() / 1e6:.0f}M "
                  f"params, mesh {mesh.shape}, strategy {args.strategy}"
                  f"{' (explicit)' if args.explicit else ''}, "
                  f"{ctx.num_processes} processes on {args.device}",
                  flush=True)
        opt = optim.adamw(3e-4 if args.full else 1e-3)
        params = T.init_transformer(cfg, seed=0, device=ctx.device)
        state = init_sharded_state(params, cfg, opt, sharder)
        del params
        step = make_train_step(cfg, opt, sharder, donate=False)
        it = SyntheticLM(cfg.vocab_size).batches(args.batch, args.seq, cfg)
        t_hist = []
        for i in range(1, args.steps + 1):
            batch = {k: torch.as_tensor(v, device=ctx.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = m["loss"].item()
            t_hist.append(time.perf_counter() - t0)
            if lead and i % max(1, args.steps // 10) == 0:
                tok_s = args.batch * args.seq / np.median(t_hist[-10:])
                print(f"step {i:4d}  loss {loss:.4f}  {tok_s:,.0f} tok/s",
                      flush=True)
        if lead:
            print(f"final loss {loss:.4f} "
                  f"(random = {np.log(cfg.vocab_size):.2f})", flush=True)
    finally:
        distributed.shutdown()


def _spawned(process_id, args, coordinator):
    run(args, coordinator, process_id)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.strategy == "megatron":
        raise NotImplementedError(MEGATRON_ITEM)
    if os.environ.get(distributed.ENV_NUM_PROCESSES):
        run(args)
        return 0
    mp.spawn(_spawned, args=(args, distributed._free_local_address()),
             nprocs=args.model * args.data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
