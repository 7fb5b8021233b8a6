#!/usr/bin/env python3
"""Time the fp32 flash-attention kernel of one or more checkouts of the
repo on one GPU, at the shapes the fp32 cross-checks launch it at.

    python3 scripts/torch_flash_fp32.py [--library] [--cases] [--ptxas]
        [--sweep] [--out FILE] [ROOT ...]

Each ROOT (default: this checkout) runs in a fresh process, in the order
given, with that ROOT's ``repro_torch`` (its kernels built from its own
sources into its own ``build/torch_kernels/``) and this checkout's
``chip_smoke.flash_fp32_timing``: ``chip_smoke.FLASH_FP32_ROWS``, each
shape held against the plain version at 1e-5·(1 + max|ref|) and timed
(CUDA events, two runs) beside the plain version and its bound.  To
compare two trees in one call, unpack the other under ``build/`` (``git
archive``) and give parent, change, change, parent.

``--library`` also times the library yardstick of each row (fp32 SDPA,
or the compiled ``flex_attention``); ``--cases`` first runs
``chip_smoke.flash_cases`` (phase 4: every case and the NaN holds) on
the ROOT's kernels; ``--ptxas`` compiles this checkout's
``flash_attention_tf32x3.cu`` alone with ``nvcc -Xptxas -v`` and prints
each bucket's registers, spills and stack.

``--sweep`` (instead of the ROOT runs) builds this checkout's source once
per entry of ``SWEEP`` — the bucket table with some buckets' (warps, keys
a tile, blocks an SM) replaced, or a ``-D`` flag — each into its own
library under ``build/flash_fp32_sweep/`` (plain ``nvcc``, in parallel),
prints each build's registers and spills, then holds every variant at
every row and times it, the variants in order and again in reverse.

Prints each run's output, the card's name and power limit, then one JSON
line per run (``--out`` writes them all to FILE).  Exits non-zero if a
run fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = (HERE / "src" / "repro_torch" / "kernels" / "flash_attn" / "csrc"
          / "flash_attention_tf32x3.cu")
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
        "-O3", "-std=c++17", "-Xptxas", "-v"]
CASE = re.compile(r"  REPRO_FLASH_TF32X3_CASE\((\d+), (\d+), (\d+), (\d+), "
                  r"(\d+)\)\n")

# name: ({(DK, DV): (warps, keys a tile, blocks an SM)} replacing the
# source's entries, extra nvcc flags): the committed table and the
# alternatives it was chosen over at the rows' buckets
SWEEP = {
    "committed": ({}, []),
    "one_s_set": ({}, ["-DREPRO_FLASH_TF32X3_S_SETS=1"]),
    "warps4": ({(80, 80): (4, 64, 2), (192, 128): (4, 16, 2)}, []),
    "bkv32_80": ({(80, 80): (4, 32, 3)}, []),
    "warps8_192": ({(192, 128): (8, 16, 1)}, []),
    "warps2_192": ({(192, 128): (2, 32, 2)}, []),
}

CHILD = r"""
import json, sys, time, torch
sys.path.insert(0, {src!r})
import repro_torch
sys.path.insert(0, {here!r})
import chip_smoke as cs
from repro_torch.kernels import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
print("repro_torch from", repro_torch.__file__)
t = time.perf_counter()
build.build()
print(f"built {{[p.name for p in build.SOURCES]}} in "
      f"{{time.perf_counter() - t:.1f}} s")
out = {{"root": {root!r}, "sources": [p.name for p in build.SOURCES]}}
if {cases}:
    out["cases_max_abs_err"] = cs.flash_cases(dev)
gen = torch.Generator(device=dev).manual_seed(4)
out["rows"] = cs.flash_fp32_timing(gen, dev, library={library})
print("RESULT " + json.dumps(out))
"""


def _ptxas_summary(text: str) -> list:
    """(bucket, registers, spill bytes, stack bytes) of each kernel in an
    ``-Xptxas -v`` report."""
    rows, cur = [], None
    for ln in text.splitlines():
        m = "Compiling entry" in ln and re.search(
            r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if m:
            cur = {"bucket": [int(x) for x in m.groups()]}
            rows.append(cur)
        elif cur is not None and "stack frame" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur["stack"], cur["spill"] = n[0], n[1] + n[2]
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return rows


def _ptxas() -> list:
    proc = subprocess.run(NVCC + ["-c", "-o", "/dev/null", str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return _ptxas_summary(proc.stdout + proc.stderr)


def _variant_source(overrides: dict) -> str:
    src = SOURCE.read_text()

    def sub(m):
        dk, dv, *rest = (int(x) for x in m.groups())
        w, bkv, minb = overrides.get((dk, dv), rest)
        return (f"  REPRO_FLASH_TF32X3_CASE({dk}, {dv}, {w}, {bkv}, "
                f"{minb})\n")
    out, n = CASE.subn(sub, src)
    if n < len(overrides) or n == 0:
        raise RuntimeError("the source's bucket table was not found")
    return out


def _build_sweep() -> dict:
    """Every ``SWEEP`` variant built at once: name -> (library, ptxas)."""
    root = HERE / "build" / "flash_fp32_sweep"
    root.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (overrides, flags) in SWEEP.items():
        cu = root / f"{name}.cu"
        cu.write_text(_variant_source(overrides))
        so = root / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            NVCC + flags + ["-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                            str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text[-3000:]}")
        out[name] = (so, _ptxas_summary(text))
    return out


def _variant_fn(path: Path):
    """flash_attention_bhsd's fp32 launch through one variant's library
    (causal; the same C entry and checks as the wrapper's)."""
    import torch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ctypes.CDLL(str(path)).flash_attention_fwd_f32_tf32x3
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p]
    fn.restype = ctypes.c_int

    def run(q, k, v, *, window=None, softcap=None, scale=None):
        b, hq, sq, hd = q.shape
        _, hkv, skv, hdv = v.shape
        out = torch.empty(b, hq, sq, hdv, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, skv, hd, hdv,
                 float(scale if scale is not None else hd ** -0.5), 1,
                 window or 0, float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: launch failed, cudaError {err}")
        return out
    return run


def sweep() -> dict:
    import torch
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attn import flash_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    built = _build_sweep()
    for name, (_, regs) in built.items():
        print(f"  {name}: " + "; ".join(
            f"{tuple(r['bucket'])} {r.get('registers')} regs, "
            f"{r.get('spill')} B spilled" for r in regs))
    fns = {name: _variant_fn(so) for name, (so, _) in built.items()}
    order = list(fns) + list(reversed(fns))
    result = {"ptxas": {n: r for n, (_, r) in built.items()}, "rows": {}}
    for key, shape, window, softcap, scale in cs.FLASH_FP32_ROWS:
        gen = torch.Generator(device=dev).manual_seed(4)
        b, hq, hkv, s, hd, hdv = shape
        q = torch.randn(b, hq, s, hd, generator=gen, device=dev)
        k = torch.randn(b, hkv, s, hd, generator=gen, device=dev)
        v = torch.randn(b, hkv, s, hdv, generator=gen, device=dev)
        kw = dict(window=window, softcap=softcap, scale=scale)
        want = flash_ref(q, k, v, **kw)
        row = {"shape": list(shape), "window": window, "softcap": softcap,
               "err": {}, "ms": {name: [] for name in fns}}
        for name, fn in fns.items():
            row["err"][name] = cs._held(f"{key} {name}", fn(q, k, v, **kw),
                                        want)
        del want
        iters = 20 if s * s * hq * b < 5e7 else 5
        for name in order:
            row["ms"][name].append(cs._time_ms(
                lambda: fns[name](q, k, v, **kw), iters))
        print(f"  {key}: " + ", ".join(
            f"{n} {min(t):.4f}" for n, t in row["ms"].items()) + " ms")
        result["rows"][key] = row
        del q, k, v
        torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--cases", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_fp32: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = []
    if args.ptxas:
        regs = _ptxas()
        for r in regs:
            print(f"  {tuple(r['bucket'])}: {r.get('registers')} registers, "
                  f"{r.get('spill')} B spilled, {r.get('stack')} B stack")
        results.append({"ptxas": regs})
    if args.sweep:
        results.append({"sweep": sweep()})
    else:
        for root in [r.resolve() for r in args.roots] or [HERE]:
            child = CHILD.format(src=str(root / "src"), here=str(HERE),
                                 root=str(root), cases=args.cases,
                                 library=args.library)
            proc = subprocess.run([sys.executable, "-c", child],
                                  capture_output=True, text=True)
            print(f"==== {root}\n{proc.stdout}{proc.stderr[-3000:]}")
            if proc.returncode:
                print(f"run from {root} failed (exit {proc.returncode})",
                      file=sys.stderr)
                return 1
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):]))
    print(card)
    for res in results:
        print(json.dumps({**res, "card": card}))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
