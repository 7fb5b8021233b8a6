"""TF32 rounding and the three-pass TF32 product, as the port's CUDA
kernels do their fp32 products on the tensor cores (``ssd_intra_chunk.cu``,
``flash_attention_tf32x3.cu``), emulated in torch on the CPU for the tests
of ``tests/torch_ssd_cases.py`` and ``tests/test_torch_flash_tf32x3.py``.
"""
import torch


def tf32(t):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: cvt.rna.tf32.f32, as the CUDA kernel rounds its operands.
    A NaN stays NaN, as in the kernel's hi part (the add alone would carry
    the mantissa of a NaN such as 0x7fffffff into the sign bit)."""
    t = t.contiguous()
    rounded = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(t.isnan(), t, rounded)


def one_pass(a, b):
    return tf32(a) @ tf32(b)


def three_pass(a, b):
    """The kernel's split: hi = tf32(v), lo = tf32(v − hi), and lo·hi +
    hi·lo + hi·hi."""
    ah, bh = tf32(a), tf32(b)
    return tf32(a - ah) @ bh + ah @ tf32(b - bh) + ah @ bh
