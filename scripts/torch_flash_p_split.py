"""What the P remainder costs and buys in the bf16 flash-attention kernel.

``src/repro_torch/kernels/flash_attn/csrc/flash_attention_mma.cu`` sends
the softmax weights P through the PV product as two bf16 parts (the top
16 bits and the rounded remainder).  This script builds that source twice,
as committed and with ``-DREPRO_FLASH_P_REMAINDER=0`` (P as one
round-to-nearest bf16, no remainder product), and compares the two:

- the per-element bf16 hold of ``chip_smoke.py`` phase 4,
  |Δ| ≤ 2^-7·|ref| + 1e-3 against the fp32 plain version on the same bf16
  inputs, as the worst ratio over each of its bf16 cases (the same inputs:
  its generator, seed and order) and at the path shape (2, 32, 2048, 80)
  causal;
- the time of one launch at the path shape, CUDA events over 20
  back-to-back launches, in the order split, single, single, split.

Run on a CUDA card from the root of the checkout:

    python3 scripts/torch_flash_p_split.py

The builds go to ``build/flash_p_split/``.  The last line is a JSON
object with every number printed.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "flash_attn" / "csrc"
          / "flash_attention_mma.cu")
VARIANTS = {"split": 1, "single": 0}   # REPRO_FLASH_P_REMAINDER


def _build(name: str, remainder: int):
    from torch.utils.cpp_extension import load
    out = ROOT / "build" / "flash_p_split" / name
    out.mkdir(parents=True, exist_ok=True)
    lib = ctypes.CDLL(load(
        name=f"flash_p_{name}", sources=[str(SOURCE)],
        build_directory=str(out),
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a",
                           f"-DREPRO_FLASH_P_REMAINDER={remainder}"],
        is_python_module=False))
    fn = lib.flash_attention_fwd_bf16_mma
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, q, k, v, causal, window, softcap):
    b, hq, sq, hd = q.shape
    _, hkv, skv, hdv = v.shape
    out = torch.empty(b, hq, sq, hdv, dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
             hkv, sq, skv, hd, hdv, float(hd ** -0.5), int(causal),
             window or 0, float(softcap or 0.0),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return out


def _worst(got, want) -> float:
    from chip_smoke import BF16_ATOL, BF16_ULP
    got, want = got.float(), want.float()
    return ((got - want).abs() / (BF16_ULP * want.abs() + BF16_ATOL)) \
        .max().item()


def _ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_p_split: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import FLASH_CASES
    from repro_torch.kernels.flash_attn import flash_ref
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    fns = {name: _build(name, r) for name, r in VARIANTS.items()}

    result = {"card": card, "cases": [], "path": {}}
    gen = torch.Generator(device=dev).manual_seed(2)   # as phase 4
    for b, hq, hkv, sq, skv, hd, hdv, dt, causal, win, cap in FLASH_CASES:
        q = torch.randn(b, hq, sq, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, skv, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, skv, hdv, generator=gen, device=dev).to(dt)
        if dt != torch.bfloat16:
            continue
        want = flash_ref(q, k, v, causal=causal, window=win, softcap=cap)
        worst = {name: _worst(_run(fn, q, k, v, causal, win, cap), want)
                 for name, fn in fns.items()}
        case = (f"g={hq // hkv} {sq}x{skv} hd={hd}/{hdv} "
                f"{'causal' if causal else 'full'}"
                f"{f' win={win}' if win else ''}"
                f"{f' cap={cap:g}' if cap else ''}")
        result["cases"].append({"case": case, "worst": worst})
        print(f"  {case:<36} worst ratio: split {worst['split']:.3f}, "
              f"single {worst['single']:.3f}")

    gen = torch.Generator(device=dev).manual_seed(4)   # as phase 11
    q, k, v = (torch.randn(2, 32, 2048, 80, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    want = flash_ref(q, k, v)
    worst = {name: _worst(_run(fn, q, k, v, True, None, None), want)
             for name, fn in fns.items()}
    del want
    runs = {name: [] for name in fns}
    for name in ("split", "single", "single", "split"):
        runs[name].append(_ms(lambda: _run(fns[name], q, k, v, True, None,
                                           None)))
    result["path"] = {"worst": worst, "ms_runs": runs,
                      "ms": {n: min(r) for n, r in runs.items()}}
    print(f"  (2,32,2048,80) bf16 causal: worst ratio split "
          f"{worst['split']:.3f}, single {worst['single']:.3f}; ms split "
          f"{runs['split']}, single {runs['single']}")
    result["worst_over_cases"] = {
        n: max([c["worst"][n] for c in result["cases"]] + [worst[n]])
        for n in fns}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
