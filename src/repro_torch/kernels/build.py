"""The build of the port's hand-written kernels.

Each CUDA source (``<name>/csrc/*.cu``) is compiled on its first use, by
its own ``torch.utils.cpp_extension.load`` call, into its own shared
library under ``build/torch_kernels/<source stem>/`` at the root of the
checkout, so a path pays only for the kernels it runs (the GCN step's
SpMM builds in seconds; the flash sources take longer).  The sources have
a plain C interface and include no PyTorch header; each library is bound
with ``ctypes``.  Each wrapper fetches its C function with
:func:`kernel_fn`; :func:`build` builds them all.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SPMM = _KERNELS / "spmm" / "csrc" / "spmm_csr.cu"
FLASH_TF32X3 = _KERNELS / "flash_attn" / "csrc" / "flash_attention_tf32x3.cu"
FLASH_MMA = _KERNELS / "flash_attn" / "csrc" / "flash_attention_mma.cu"
SSD = _KERNELS / "ssd" / "csrc" / "ssd_intra_chunk.cu"
SOURCES = (SPMM, FLASH_TF32X3, FLASH_MMA, SSD)
BUILD_DIR = _KERNELS.parents[2] / "build" / "torch_kernels"


@functools.cache
def library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per process; ``load`` skips an unchanged
    build) into its own library and load it."""
    from torch.utils.cpp_extension import load

    out = BUILD_DIR / source.stem
    out.mkdir(parents=True, exist_ok=True)
    path = load(name=f"repro_torch_{source.stem}", sources=[str(source)],
                build_directory=str(out),
                extra_cuda_cflags=["-O3",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                is_python_module=False)
    return ctypes.CDLL(path)


def build() -> list[ctypes.CDLL]:
    """Every source's library, built where it is not yet (the checks and
    scripts that run every kernel)."""
    return [library(s) for s in SOURCES]


def kernel_fn(source: Path, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``source``'s library with its argument
    types set; every kernel entry returns the launch's ``cudaError_t`` as
    an int."""
    fn = getattr(library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
