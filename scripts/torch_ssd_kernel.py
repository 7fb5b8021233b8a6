"""The SSD intra-chunk kernel on its own: build it, hold it, time it.

    python3 scripts/torch_ssd_kernel.py

Run on a CUDA card from the root of the checkout.  It builds the port's
kernels (``repro_torch/kernels/build.py``), prints what ``ptxas`` reports
for ``kernels/ssd/csrc/ssd_intra_chunk.cu`` (registers, spills, shared
memory), holds ``ssd_intra_chunk`` against ``ssd_intra_chunk_ref`` on
``chip_smoke.py`` phase 5 (``ssd_cases``) and at the scoring path's shape
(2, 2048, 80, 64), N=64, Q=256, at ``SSD_TOL``, and times one launch at
that shape: device time from ``torch.profiler`` and CUDA events over
back-to-back launches, beside the bound of those inputs.

It also measures the ceiling of the kernel's instruction: a loop of
independent ``mma.sync.m16n8k8`` TF32 products with no loads, at 8 and 16
warps per SM, reported as TFLOP/s and cycles per ``mma`` per scheduler
(``clock64`` over the loop), the rate the SSD kernel's three passes run at
when nothing else holds them.

Last, it builds the kernel's source again with ``-DREPRO_SSD_PHASES=1``
(into ``build/ssd_phases/``), runs it once at the path shape and prints, for
the row-tile blocks and the state blocks, the mean ``clock64`` cycles a
block spends in each phase (thread 0's view; a phase ends at the barrier
that closes it).  The kernel's next step (resident prefetching blocks,
ROADMAP queue 2b: blocks that stay resident and prefetch their next work
item) is to hide the block start and the waits these counters measure.

To compare two versions of the kernel, run this script from each
checkout in one call (parent, change, change, parent).

The last line is a JSON object with every number printed.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
PATH_SHAPE = (2, 2048, 80, 64, 64, 256)   # b, s, h, p, n, q


def _ptxas(source: Path, name: str) -> list[str]:
    """What ptxas reports for ``source``: registers and spills of each
    instantiation."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = ROOT / "build" / "ssd_ptxas" / name
    out.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "nvcc"), *FLAGS, "-std=c++17",
         "-Xptxas", "-v", "-c", str(source), "-o", str(out / "ssd.o")],
        capture_output=True, text=True, check=True)
    return [line.strip() for line in res.stderr.splitlines()
            if "registers" in line or "spill" in line]


def _load(source: Path, name: str, flags=()) -> ctypes.CDLL:
    """``source`` built alone into build/<name>/, with its C entry's
    argument types set."""
    from torch.utils.cpp_extension import load
    out = ROOT / "build" / name
    out.mkdir(parents=True, exist_ok=True)
    lib = ctypes.CDLL(load(name=name.replace("/", "_"),
                           sources=[str(source)], build_directory=str(out),
                           extra_cuda_cflags=[*FLAGS, *flags],
                           is_python_module=False))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_chunk_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
    lib.ssd_intra_chunk_f32.restype = ctypes.c_int
    return lib


PHASES = {"row": ("prologue", "wait", "scores", "M·x", "end barrier"),
          "state": ("prologue", "wait", "products", "end barrier")}


def _phases(source: Path, inputs, q) -> dict:
    """Mean cycles per block in each phase, from one launch of a build of
    ``source`` with the phase counters on."""
    lib = _load(source, "ssd_phases", ["-DREPRO_SSD_PHASES=1"])
    fn, counters = lib.ssd_intra_chunk_f32, lib.ssd_intra_chunk_phases
    counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters.restype = ctypes.c_int
    for _ in range(2):
        _run(fn, *inputs, q)
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * 16)()
    if counters(None, 1):
        raise RuntimeError("could not zero the phase counters")
    _run(fn, *inputs, q)
    torch.cuda.synchronize()
    if counters(cycles, 0):
        raise RuntimeError("could not read the phase counters")
    out = {}
    for k, (kind, names) in enumerate(PHASES.items()):
        row = list(cycles)[8 * k: 8 * k + 8]
        blocks = max(row[6], 1)
        out[kind] = {"blocks": row[6], "total": row[5] / blocks,
                     **{n: row[i] / blocks for i, n in enumerate(names)}}
        print(f"  {kind} blocks: {row[6]}, {out[kind]['total']:.0f} cycles "
              f"each: " + ", ".join(f"{n} {out[kind][n]:.0f}"
                                    for n in names))
    return out


MMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
// kChains independent accumulators per warp, each taking one m16n8k8 TF32
// mma per iteration; cycles of the loop per block in cyc[blockIdx.x]
constexpr int kChains = 8;
__global__ void mma_peak(float* out, long long* cyc, int iters) {
  const uint32_t one = 0x3f800000u, a[4] = {one, one, one, one};
  float acc[kChains][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(one), "r"(one));
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  float s = 0.f;
  for (int k = 0; k < kChains; ++k) s += acc[k][0] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, long long* cyc, int blocks,
                               int threads, int iters, void* stream) {
  mma_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, cyc, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _mma_peak(dev) -> list[dict]:
    """TF32 mma.sync throughput with nothing but the products: one block of
    8 or 16 warps per SM, 8 independent accumulators per warp."""
    from torch.utils.cpp_extension import load
    out_dir = ROOT / "build" / "ssd_mma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_peak.cu"
    src.write_text(MMA_PEAK_SRC)
    fn = ctypes.CDLL(load(name="ssd_mma_peak", sources=[str(src)],
                          build_directory=str(out_dir),
                          extra_cuda_cflags=FLAGS,
                          is_python_module=False)).mma_peak_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    iters, rows = 4096, []
    for warps in (8, 16):
        out = torch.empty(sms * warps * 32, device=dev)
        cyc = torch.empty(sms, dtype=torch.int64, device=dev)

        def call():
            err = fn(out.data_ptr(), cyc.data_ptr(), sms, 32 * warps, iters,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_peak launch failed: {err}")

        from chip_smoke import _time_ms
        ms = _time_ms(call, 5)
        n_mma = sms * warps * iters * 8
        cycles = cyc.double().mean().item()
        rows.append({"warps_per_sm": warps, "ms": ms,
                     "tflops": n_mma * 2048 / (ms * 1e-3) / 1e12,
                     "cycles_per_mma_per_scheduler":
                         cycles / (warps * iters * 8 / 4)})
        print(f"  mma.sync m16n8k8 TF32 alone, {warps} warps per SM: "
              f"{rows[-1]['tflops']:.1f} TFLOP/s, "
              f"{rows[-1]['cycles_per_mma_per_scheduler']:.2f} cycles per "
              f"mma per scheduler")
    return rows


def _run(fn, x, dt, a, bm, cm, q):
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    y = torch.empty_like(x)
    st = torch.empty(bsz, s // q, h, p, n, device=x.device)
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
             cm.data_ptr(), y.data_ptr(), st.data_ptr(), bsz, s, h, p, n, q,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return y, st


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_kernel: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import (SSD_TOL, _device_ms, _held, _ssd_bound,
                            _ssd_inputs, _time_ms, ssd_cases)
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    from repro_torch.kernels.ssd.ssd import _kernel

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    kbuild.build()
    fn = _kernel()
    source = kbuild.SOURCES[-1]
    ptxas = _ptxas(source, "kernel")
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    for line in ptxas:
        print(f"  ptxas: {line}")

    result = {"card": card, "ptxas": ptxas, "phase5_max_abs_err":
              ssd_cases(dev)}

    # the path shape, held and timed; inputs as chip_smoke.py phase 19
    # draws them
    b, s, h, p, n, q = PATH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(4)
    _ = [torch.randn(2, 32, 2048, 80, generator=gen, device=dev)
         for _ in range(3)]   # phase 19 draws the flash inputs first
    del _
    inputs = _ssd_inputs(b, s, h, p, n, gen, dev)
    y, st = _run(fn, *inputs, q)
    y_r, st_r = ssd_intra_chunk_ref(*inputs, chunk=q)
    result["path_max_abs_err"] = max(
        _held(f"{PATH_SHAPE} y_intra", y, y_r, SSD_TOL),
        _held(f"{PATH_SHAPE} states", st, st_r, SSD_TOL))
    del y, st, y_r, st_r

    def call():
        return _run(fn, *inputs, q)

    runs = {"device_ms": [], "event_ms": []}
    for _ in range(2):
        runs["device_ms"].append(_device_ms(call, 10)[0])
        runs["event_ms"].append(_time_ms(call, 10))
    plain_ms = _time_ms(lambda: ssd_intra_chunk_ref(*inputs, chunk=q), 3)
    bound = _ssd_bound(b, s, h, p, n, q)
    result["path"] = {**runs, "plain_ms": plain_ms, **bound}
    print(f"  kernel at {PATH_SHAPE}: device {runs['device_ms']} ms, "
          f"events {runs['event_ms']} ms")
    print(f"  plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['bytes'] / 1e6:.1f} MB, "
          f"{bound['t_bytes_ms']:.4f} ms; {bound['flops'] / 1e9:.3f} GFLOP, "
          f"3 TF32 passes {bound['t_tf32x3_ms']:.4f} ms, fp32 FMA "
          f"{bound['bound_fp32_ms']:.4f} ms)")
    result["mma_peak"] = _mma_peak(dev)
    result["phases"] = _phases(source, inputs, q)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
