"""Transformer NN primitives: norms, projections, embeddings, RoPE, and
parameter initializers.

Initializers draw from an explicit ``torch.Generator`` with the JAX
package's distributions (``repro/nn/param.py::param``): normal with scale
1/√fan_in (fan_in = shape[0], or the last dim of a 1-d leaf), embeddings
at scale 1.0, zeros and ones.  The numbers differ from JAX's PRNG; parity
tests carry the reference's weights over with ``params.from_numpy_tree``.
A ``gen`` of None draws nothing: the leaves are shape-only tensors on the
meta device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param(gen: torch.Generator, shape: tuple, *, scale: float | None = None,
          init: str = "normal", dtype=torch.float32) -> torch.Tensor:
    """One parameter leaf on ``gen``'s device (meta where it is None)."""
    device = "meta" if gen is None else gen.device
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init != "normal":
        raise ValueError(init)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    v = torch.randn(shape, generator=gen, device=device)
    return (scale * v).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:                     # gemma-style (1 + w) scaling
        w = 1.0 + w
    return (x * w).to(dtype)


def init_rms_norm(gen: torch.Generator, d: int,
                  plus_one: bool = False) -> torch.Tensor:
    return param(gen, (d,), init="zeros" if plus_one else "ones")


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax default
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half
    rotation, as the reference."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (...,s,hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, scale=None, dtype=torch.float32) -> dict:
    p = {"w": param(gen, (d_in, d_out), scale=scale, dtype=dtype)}
    if bias:
        p["b"] = param(gen, (d_out,), init="zeros", dtype=dtype)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    return param(gen, (vocab, d), scale=1.0, dtype=dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.float32) -> dict:
    return {"gate": init_dense(gen, d, d_ff, dtype=dtype),
            "up": init_dense(gen, d, d_ff, dtype=dtype),
            "down": init_dense(gen, d_ff, d, dtype=dtype)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    return dense(p["down"], activation(act)(dense(p["gate"], x))
                 * dense(p["up"], x))
