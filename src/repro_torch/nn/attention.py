"""Attention: grouped-query attention (GQA) for training-free full-sequence
use, prefill and decode — the subset of the JAX package's
``repro/nn/attention.py`` that the port runs.

MLA, the sliding-window ring cache and ``attention_blockwise`` are ROADMAP
queue 1 items 19 and 20; the sharding hooks of the reference are dropped
(the port runs the LM on one card).

Decode cache: :class:`KVCache`, dense (B, S_max, H_kv, hd) k/v.  Decode
writes the new token's k/v into the cache tensors in place (JAX returns
new arrays; in place saves a copy of the whole cache per step) and returns
a cache with the advanced length that shares those tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attn.ops import flash_attention
from . import layers as nl


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported (ROADMAP queue 1 item "
            f"20)")
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": nl.param(gen, (d, hq, hd)),
         "wk": nl.param(gen, (d, hkv, hd)),
         "wv": nl.param(gen, (d, hkv, hd)),
         "wo": nl.param(gen, (hq, hd, d))}
    if cfg.qkv_bias:
        p["bq"] = nl.param(gen, (hq, hd), init="zeros")
        p["bk"] = nl.param(gen, (hkv, hd), init="zeros")
        p["bv"] = nl.param(gen, (hkv, hd), init="zeros")
    return p


# ---------------------------------------------------------------------------
# Masks and core attention
# ---------------------------------------------------------------------------

def _causal_mask(sq: int, skv: int, q_offset, device=None) -> torch.Tensor:
    qi = q_offset + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    return kj <= qi


def _window_mask(sq: int, skv: int, q_offset, window: int,
                 device=None) -> torch.Tensor:
    qi = q_offset + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def attention_core(q, k, v, mask, *, softcap: Optional[float] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd) with Hq % Hkv == 0.

    Returns (B,Sq,Hq,hd_v).  ``mask`` broadcasts to (B,1,1,Sq,Skv)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    scores = nl.softcap(scores, softcap)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA forward (scoring / prefill) + decode
# ---------------------------------------------------------------------------

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.to(out.dtype).reshape(
        h * k, d)


def gqa_project_qkv(p, cfg: ArchConfig, x, positions):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = nl.apply_rope(q, positions, cfg.rope_theta)
    k = nl.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mixing_attention(cfg: ArchConfig, q, k, v, *,
                      window: Optional[int] = None,
                      scale: Optional[float] = None):
    """Causal full-sequence attention, naive or through the flash kernel."""
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap, scale=scale)
    sq = q.shape[1]
    mask = (_window_mask(sq, sq, 0, window, q.device) if window
            else _causal_mask(sq, sq, 0, q.device))[None]
    return attention_core(q, k, v, mask, softcap=cfg.attn_softcap,
                          scale=scale)


def gqa_attention(p, cfg: ArchConfig, x, positions, *,
                  window: Optional[int] = None):
    """Full-sequence attention (scoring / prefill without a cache)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _mixing_attention(cfg, q, k, v, window=window)
    return _out_proj(out, p["wo"])


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # (B, S_max, H_kv, hd)
    v: torch.Tensor
    length: int         # valid prefix length


def gqa_prefill(p, cfg: ArchConfig, x, positions, max_len: int, *,
                window: Optional[int] = None):
    """Full-sequence attention that also materializes the decode cache."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _mixing_attention(cfg, q, k, v, window=window)
    y = _out_proj(out, p["wo"])
    b, sq = x.shape[:2]
    kc = k.new_zeros((b, max_len) + k.shape[2:])
    vc = v.new_zeros((b, max_len) + v.shape[2:])
    kc[:, :sq] = k
    vc[:, :sq] = v
    return y, KVCache(k=kc, v=vc, length=sq)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.float32, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def gqa_decode(p, cfg: ArchConfig, x, cache: KVCache):
    """One-token decode against a dense cache.  x: (B, 1, D).  Writes the
    token's k/v into ``cache.k``/``cache.v`` in place."""
    pos = cache.length
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = gqa_project_qkv(p, cfg, x, positions)
    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    skv = cache.k.shape[1]
    mask = (torch.arange(skv, device=x.device)[None, :] <= pos)[None]
    out = attention_core(q, cache.k, cache.v, mask,
                         softcap=cfg.attn_softcap)
    y = _out_proj(out, p["wo"])
    return y, KVCache(k=cache.k, v=cache.v, length=pos + 1)
