"""Render dry-run JSON records into roofline tables — the port of
``repro/launch/report.py``, pure Python over the records; it reads both
packages' records (the port's dry-run writes the reference's keys).

    PYTHONPATH=src python -m repro_torch.launch.report --in results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(path: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def fmt_s(s: float) -> str:
    if s == 0:
        return "0"
    return f"{s:.2e}"


def roofline_table(recs: list[dict], mesh: str = "16x16",
                   strategy: str | None = None) -> str:
    rows = [r for r in recs if r["mesh"] == mesh
            and (strategy is None or r["strategy"] == strategy)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant |"
        " peak GiB/dev | MODEL/HLO flops | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rf = r["roofline"]
        note = _note(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} "
            f"| {fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} "
            f"| {rf['dominant']} "
            f"| {fmt_bytes(r['memory']['peak_bytes'])} "
            f"| {rf['flops_ratio']:.2f} | {note} |")
    return "\n".join(out)


def _note(r: dict) -> str:
    rf = r["roofline"]
    dom = rf["dominant"]
    cb = rf["coll_breakdown"]
    if dom == "memory":
        if r["shape"].startswith(("prefill", "train")) \
                and rf["memory_s"] > 10 * rf["compute_s"]:
            return "S×S score buffers — needs blockwise attention"
        if r["shape"].startswith("decode"):
            return "KV-cache sweep per token (expected decode regime)"
        return "activation traffic"
    if dom == "collective":
        big = max((k for k in ("all-gather", "all-reduce", "all-to-all",
                               "reduce-scatter")), key=lambda k: cb[k])
        return f"{big} dominates — resharding/overlap candidate"
    return "compute-bound (near roofline)"


def dryrun_table(recs: list[dict]) -> str:
    rows = sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = [
        "| arch | shape | mesh | strategy | compile s | peak GiB/dev |"
        " flops/dev | coll GiB/dev | a2a GiB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rf = r["roofline"]
        cb = rf["coll_breakdown"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['strategy']} "
            f"| {r['compile_seconds']:.1f} "
            f"| {fmt_bytes(r['memory']['peak_bytes'])} "
            f"| {rf['hlo_flops']:.2e} "
            f"| {fmt_bytes(rf['coll_bytes'])} "
            f"| {fmt_bytes(cb['all-to-all'])} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="path", default="results/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load_records(args.path)
    print(f"### Roofline (single-pod {args.mesh}, {len(recs)} records "
          f"total)\n")
    print(roofline_table(recs, mesh=args.mesh))
    print("\n### Dry-run census (all meshes)\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
