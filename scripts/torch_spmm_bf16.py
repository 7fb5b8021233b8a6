#!/usr/bin/env python3
"""The SpMM kernel's fp32 launches of one or more checkouts of the repo on
one GPU, compared bitwise and timed, and its bf16 launches where the
checkout has them.

    python3 scripts/torch_spmm_bf16.py [--out FILE] [ROOT ...]

Each ROOT (default: this checkout) runs as ``torch_roots.run_roots``
runs it: in a fresh process, in the order given, with that ROOT's
``repro_torch`` and this checkout's ``chip_smoke`` helpers.  Cases: a
(5 760 × 23 040) plan with 250 000 nonzeros at bs 128 (the GCN path's
forward chunk's shape) at d = 41 and 602, ``chip_smoke._skewed_plan`` at
d = 41 and 200, and the reference kernel bench's ``sbm_power_law(n=4096,
..., seed=7)`` at bs 128, d = 128; h drawn from one seed.  Each fp32
launch's output is hashed (sha256 of its bytes) and held against the
plain version at 1e-5·(1 + max|ref|); where ``spmm_csr`` takes bf16 h,
the same cases run with h rounded to bf16, held per element at
2^-7·|ref| + 1e-3 and their repeat launch bitwise.  Every launch is
timed as device time (``torch.profiler``, min of two runs of 20, the
flags' memset included).  Given parent, change, change, parent, the fp32
hashes of every run must agree.

Prints each run's output, the card's name and power limit, then one JSON
line per run (``--out`` writes them all to FILE).  Exits non-zero if a
run fails, the fp32 hashes differ between runs, or no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from torch_roots import card, report, run_roots

CHILD = r"""
import hashlib
from repro_torch.graph import BlockSparsePlan, block_sparse, sbm_power_law
from repro_torch.kernels.spmm import block_sparse_plan_dev, spmm_csr, spmm_csr_ref
from repro_torch.kernels.spmm import spmm as spmm_mod

bf16 = torch.bfloat16 in getattr(spmm_mod, "_ENTRIES", {{}})
g = block_sparse(sbm_power_law(n=4096, num_classes=8, feat_dim=128,
                               avg_degree=16, seed=7).graph, bs=128)
# the bench graph's forward tiles as a square plan (its transpose unused)
micro = BlockSparsePlan(
    n_rows=g.n, n_cols=g.n, rows_padded=g.n_padded, cols_padded=g.n_padded,
    bs=g.bs, block_rows=g.block_rows, block_cols=g.block_cols,
    row_first=g.row_first, blocks=g.blocks, block_rows_t=g.block_rows,
    block_cols_t=g.block_cols, row_first_t=g.row_first, blocks_t=g.blocks)
chunk = cs._rect_plan(5760, 23040, 250000, 128, seed=21)
skew = cs._skewed_plan()
cases = (("chunk", chunk, 41), ("chunk", chunk, 602), ("skewed", skew, 41),
         ("skewed", skew, 200), ("micro", micro, 128))
out = {{"root": {root!r}, "bf16": bf16, "rows": {{}}}}
for name, host, d in cases:
    plan = block_sparse_plan_dev(host, dev)
    arrays = cs._arrays(plan, "")
    gen = torch.Generator(device=dev).manual_seed(d)
    h32 = torch.randn(plan.cols_padded, d, generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16) if bf16 else (torch.float32,):
        h = h32.to(dt)
        key = f"{{name}} d={{d}} {{str(dt)[6:]}}"
        got = spmm_csr(*arrays, h)
        want = spmm_csr_ref(*arrays, h)
        err = cs._held(key, got, want) if dt == torch.float32 \
            else cs._held_bf16(key, got, want)
        if not torch.equal(got, spmm_csr(*arrays, h)):
            raise AssertionError(f"{{key}}: a second launch differs bitwise")
        runs = [cs._device_ms(lambda: spmm_csr(*arrays, h), 20)[0]
                for _ in range(2)]
        nnz = int(arrays[0][-1])
        bound = cs._spmm_bound(nnz, plan.cols_padded, plan.rows_padded, d,
                               itemsize=h.element_size())
        out["rows"][key] = dict(
            ms=min(runs), ms_runs=runs, max_abs_err=err, nnz=nnz,
            bound_ms=bound[0], bound_by=bound[1],
            sha256=hashlib.sha256(got.view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest())
        print(f"  {{key}}: {{runs[0]:.4f}} / {{runs[1]:.4f}} ms device time, "
              f"bound {{bound[0]:.4f}} ms by {{bound[1]}}")
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    card_line = card("torch_spmm_bf16")
    if card_line is None:
        return 1
    results = run_roots(CHILD, args.roots)
    if results is None:
        return 1
    report(card_line, results, args.out)
    hashes = {json.dumps({k: r["sha256"] for k, r in res["rows"].items()
                          if k.endswith("float32")}, sort_keys=True)
              for res in results}
    if len(hashes) > 1:
        print("the fp32 outputs differ between runs", file=sys.stderr)
        return 1
    print(f"fp32 outputs bitwise equal across {len(results)} runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
