#!/usr/bin/env python3
"""Where the host time of the out-of-core streamed GCN step goes, on one GPU.

    python3 scripts/torch_stream_host.py

The streamed step of ``chip_smoke.py`` phase 9 (reddit_like at full width,
hidden 128, L=2, 4 chunks, blocksparse at bs=128, one rank over NCCL) is
timed at 16, 4 and 1 stripes (median of 10 steps after 3 warm-up steps,
host clock around a synchronize, the in-memory ``decoupled`` step
beside them), and five 16-stripe steps are run under ``cProfile``: the
functions with the most own time and the most time below them are
printed.  Output goes to stdout; the full profile to
``chiprun_out/stream_host_profile.txt``.
"""
from __future__ import annotations

import cProfile
import io
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402


def _median_ms(step, params, state, n=10, warm=3) -> float:
    ms = []
    for i in range(warm + n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, state)
        torch.cuda.synchronize()
        if i >= warm:
            ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch import optim
    from repro_torch.core import decouple as D
    from repro_torch.core import stream as ST
    from repro_torch.gnn import models as M
    from repro_torch.graph.synthetic import reddit_like
    from repro_torch.kernels import build as kbuild
    from repro_torch.runtime import TPMesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kbuild.build()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{CS._free_port()}", rank=0, world_size=1)
    try:
        data = reddit_like(scale=1.0, seed=0)
        mesh = TPMesh()
        opt = optim.adamw(1e-2, weight_decay=5e-4)
        steps = {}
        for stripes in (16, 4, 1):
            sb = ST.prepare_stream_bundle(data, 1, n_chunks=4,
                                          n_stripes=stripes,
                                          agg="blocksparse", device=dev)
            cfg = ST.stream_gnn_config(data, sb, hidden_dim=128,
                                       num_layers=2)
            params = M.init_params(cfg, torch.Generator().manual_seed(0),
                                   dev)
            step = CS._stream_step_fn(
                ST.make_stream_value_and_grad(cfg, sb, mesh), opt,
                sb.train_mask)
            steps[stripes] = (step, params, opt.init(params))
            mb = sb.store.stripe_nbytes / 1e6
            print(f"  {stripes:2d} stripes of {mb:.2f} MB: streamed step "
                  f"{_median_ms(step, params, opt.init(params)):.2f} ms")
        mem = D.prepare_bundle(CS._padded_data(data, sb.n_padded), 1,
                               n_chunks=4, agg="blocksparse", device=dev)
        mem_step, _ = D.make_tp_train_fns(cfg, mem, mesh, opt,
                                          mode="decoupled")
        print(f"  in-memory decoupled step "
              f"{_median_ms(mem_step, params, opt.init(params)):.2f} ms")

        step, params, state = steps[16]
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        prof.enable()
        for _ in range(5):
            step(params, state)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        stats = pstats.Stats(prof, stream=out)
        stats.sort_stats("tottime").print_stats(40)
        stats.sort_stats("cumulative").print_stats(60)
        path = ROOT / "chiprun_out" / "stream_host_profile.txt"
        path.parent.mkdir(exist_ok=True)
        path.write_text(out.getvalue())
        top = io.StringIO()
        pstats.Stats(prof, stream=top).sort_stats("tottime").print_stats(15)
        print("  5 streamed steps (16 stripes) under cProfile, by own time:")
        print(top.getvalue()[-4000:])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
