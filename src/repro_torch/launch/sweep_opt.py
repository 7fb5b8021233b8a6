"""Optimized-variant dry-run sweep — the port of
``repro/launch/sweep_opt.py``: every applicable (arch × shape) with the
per-shape-kind knobs of the reference's sweep, through the port's
dry-run (``launch/dryrun.py``: the per-rank program on torch's fake
backend, no card).

    PYTHONPATH=src python -m repro_torch.launch.sweep_opt \
        [--mesh single|multi|both] [--out results/dryrun_opt]

Knob selection (the reference's):
  train    → mixing=a2a, moe=ep                (naive attn: blockwise
             refuted at 4k; heads%16≠0 archs take the ring path)
  prefill  → mixing=a2a, moe=ep, logits_last, cache_seq=model,
             attn=blockwise (peak is binding at 32k)
  decode   → cache_seq=model (flash-decode-style seq-sharded cache;
             EP/ring don't apply to the 1-token step)
  long_500k→ baseline knobs (cache already seq-sharded over data)
"""
import argparse
import json
import os
import traceback

from ..configs import INPUT_SHAPES, list_archs
from .dryrun import applicable, run_combo

KNOBS = {
    "train": dict(mixing="a2a", moe="ep"),
    "prefill": dict(mixing="a2a", moe="ep", logits_last=True,
                    cache_seq="model", attn_impl="blockwise"),
    "decode": dict(cache_seq="model"),
    "long": {},
}


def knobs_for(shape_name: str) -> dict:
    if shape_name == "long_500k":
        return KNOBS["long"]
    return KNOBS[INPUT_SHAPES[shape_name].kind]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="results/dryrun_opt")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args()
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for arch in archs:
        for shape in shapes:
            if not applicable(arch, shape):
                continue
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}__{shape}__{mesh_name}__neutron_tp__opt"
                try:
                    rec = run_combo(arch, shape, multi_pod=mp,
                                    variant="opt", **knobs_for(shape))
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(rec, f, indent=2)
                    r = rec["roofline"]
                    print(f"OK   {tag}: peak "
                          f"{rec['memory']['peak_bytes']/2**30:.2f} GiB "
                          f"c={r['compute_s']:.2e} m={r['memory_s']:.2e} "
                          f"coll={r['collective_s']:.2e} "
                          f"dom={r['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\noptimized sweep complete")


if __name__ == "__main__":
    main()
