"""One build for every hand-written kernel of the port.

All CUDA sources (``<name>/csrc/*.cu``) are compiled together by one
``torch.utils.cpp_extension.load`` call — ninja runs one ``nvcc`` per
source in parallel — into one shared library under
``build/torch_kernels/`` at the root of the checkout, on first use.  The
sources have a plain C interface and include no PyTorch header, so the
build takes seconds; the library is bound with ``ctypes``.  Each wrapper
fetches its C function with :func:`kernel_fn`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
SOURCES = (_KERNELS / "spmm" / "csrc" / "spmm_csr.cu",
           _KERNELS / "flash_attn" / "csrc" / "flash_attention_tf32x3.cu",
           _KERNELS / "flash_attn" / "csrc" / "flash_attention_mma.cu",
           _KERNELS / "ssd" / "csrc" / "ssd_intra_chunk.cu")
BUILD_DIR = _KERNELS.parents[2] / "build" / "torch_kernels"


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per process; ``load`` skips an unchanged build) and
    load the kernel library."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(name="repro_torch_kernels",
                sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cuda_cflags=["-O3",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                is_python_module=False)
    return ctypes.CDLL(path)


def kernel_fn(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The library's C function ``name`` with its argument types set; every
    kernel entry returns the launch's ``cudaError_t`` as an int."""
    fn = getattr(build(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
