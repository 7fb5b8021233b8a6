"""Attention: grouped-query attention (GQA, with biases, softcap and a
sliding window) and DeepSeek's multi-head latent attention (MLA) for
scoring, prefill and decode — the port of ``repro/nn/attention.py``.

Full-sequence attention runs naive (dense scores), ``blockwise`` (an
online-softmax scan over KV blocks, plain torch) or ``flash`` (the CUDA
kernel, :mod:`..kernels.flash_attn`).  The full-sequence functions take
the reference's ``shard`` hook (:data:`~repro_torch.nn.shard.no_shard` on
one card): under a :class:`~repro_torch.sharding.specs.Sharder` the
mixing phase runs head-sharded between the paper's split and gather
(:func:`_mixing_attention`).  So does a sharded prefill's, which then
builds each cache in its ``cache_shardings`` layout from the prompt's
token layout (``Sharder.to_cache``).  A sharded decode step runs the NN
phase on the rank's batch block, replicated over the model axis; q and
the new k/v move to the cache's layout (a slice of the heads where they
are sharded), the rank that holds the token's slot writes it, and
attention over a sequence split over ranks is a split softmax: each rank
takes, in fp32 over its own slots, its max, sum and output (the softcap
before the max), and one gather of those partials over the cache's
sequence axis merges them (:func:`_split_softmax`).  No decode step
gathers a cache.

Under the megatron strategy the NN phase is Megatron's: the activations
hold the rank's batch block with the whole sequence, replicated over the
model axis; q, k and v come from the rank's column shards of wq, wk and
wv, so they are head-local and no mixing-phase transition runs (k and v
whole where the kv heads do not divide the axis, the rank's kv groups
sliced out: :func:`_kv_for_local_q`); the output projection is
row-parallel, its partial outputs summed over the model axis
(``Sharder.row_sum``).  Heads that do not divide the axis leave the whole
attention replicated, with no sum.  A decode step moves the head-local q,
k and v to the cache's layout (a gather of the heads where the cache holds
them whole, ledger op ``tp_gather``) and the output back to the rank's
heads.

Decode caches:
  * :class:`KVCache`        — dense (B, S_max, H_kv, hd) k/v;
  * :class:`WindowKVCache`  — a ring buffer of the sliding window (gemma2
                              local layers at long context);
  * :class:`MLACache`       — compressed: (B, S_max, kv_lora) latents and
                              the shared rope key (B, S_max, rope_hd).
Decode writes the new token's entries into the cache tensors in place (JAX
returns new arrays; in place saves a copy of the whole cache per step) —
the ring cache at slot ``pos % window`` — and returns a cache with the
advanced length that shares those tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attn.ops import flash_attention
from . import layers as nl
from .shard import NoShard, no_shard


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    if cfg.use_mla:
        r, rhd = cfg.kv_lora_rank, cfg.rope_head_dim
        return {
            # queries (Lite: no q-lora): per-head nope + rope parts
            "wq": nl.param(gen, (d, hq, hd + rhd), dtype=dtype),
            # compressed kv latent + shared rope key
            "wkv_a": nl.param(gen, (d, r + rhd), dtype=dtype),
            "kv_norm": nl.init_rms_norm(gen, r),
            # up-projections from the latent
            "wk_b": nl.param(gen, (r, hq, hd), dtype=dtype),
            "wv_b": nl.param(gen, (r, hq, hd), dtype=dtype),
            "wo": nl.param(gen, (hq, hd, d), dtype=dtype)}
    p = {"wq": nl.param(gen, (d, hq, hd), dtype=dtype),
         "wk": nl.param(gen, (d, hkv, hd), dtype=dtype),
         "wv": nl.param(gen, (d, hkv, hd), dtype=dtype),
         "wo": nl.param(gen, (hq, hd, d), dtype=dtype)}
    if cfg.qkv_bias:
        p["bq"] = nl.param(gen, (hq, hd), init="zeros", dtype=dtype)
        p["bk"] = nl.param(gen, (hkv, hd), init="zeros", dtype=dtype)
        p["bv"] = nl.param(gen, (hkv, hd), init="zeros", dtype=dtype)
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


def attention_blockwise(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset=0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        block_q: int = 512, block_kv: int = 1024
                        ) -> torch.Tensor:
    """Memory-efficient attention: for each query block, a scan over the KV
    blocks with a running (max, sum, acc); the S×S score matrix is never
    materialized.  q: (B,Sq,Hq,hd); k/v: (B,Skv,Hkv,hd[_v]); queries sit
    at positions ``q_offset + i``.  Returns (B,Sq,Hq,hd_v) in v.dtype,
    fp32 math, step for step the reference's scan (a fully masked block
    scores -1e30, so a later visible one wipes it through alpha = 0)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    hdv = v.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    q_pad, kv_pad = (-sq) % block_q, (-skv) % block_kv
    qp = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    kp = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    nq, nkv = qp.shape[1] // block_q, kp.shape[1] // block_kv

    qb = qp.reshape(b, nq, block_q, hkv, g, hd).float() * scale
    kb = kp.reshape(b, nkv, block_kv, hkv, hd).float()
    vb = vp.reshape(b, nkv, block_kv, hkv, hdv).float()
    q_pos = q_offset + torch.arange(nq * block_q, device=q.device).reshape(
        nq, block_q)
    k_pos = torch.arange(nkv * block_kv, device=q.device).reshape(
        nkv, block_kv)
    k_valid = k_pos < skv

    outs = []
    for qi in range(nq):
        q_i, pos_i = qb[:, qi], q_pos[qi]
        m_run = q.new_full((b, hkv, g, block_q), -torch.inf,
                           dtype=torch.float32)
        l_run = torch.zeros_like(m_run)
        acc = m_run.new_zeros((b, hkv, g, block_q, hdv))
        for kj in range(nkv):
            s = torch.einsum("bqkgh,btkh->bkgqt", q_i, kb[:, kj])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            msk = k_valid[kj][None, :]
            if causal:
                msk = msk & (k_pos[kj][None, :] <= pos_i[:, None])
            if window is not None:
                msk = msk & (k_pos[kj][None, :] > pos_i[:, None] - window)
            s = torch.where(msk, s, -1e30)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p, vb[:, kj])
            m_run = m_new
        outs.append(acc / l_run.clamp_min(1e-30)[..., None])
    out = torch.stack(outs, dim=1)                   # (B,nq,hkv,g,bq,hdv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * block_q, hq, hdv)
    return out[:, :sq].to(v.dtype)


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


def attend(cfg: ArchConfig, q, k, v, *, window: Optional[int] = None,
           scale: Optional[float] = None):
    """Causal full-sequence attention: naive, blockwise or through the
    flash kernel."""
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap, scale=scale)
    if cfg.attn_impl == "blockwise":
        return attention_blockwise(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_softcap, scale=scale,
                                   block_q=cfg.attn_block_q,
                                   block_kv=cfg.attn_block_kv)
    sq = q.shape[1]
    mask = (_window_mask(sq, sq, 0, window, q.device) if window
            else _causal_mask(sq, sq, 0, q.device))[None]
    return attention_core(q, k, v, mask, softcap=cfg.attn_softcap,
                          scale=scale)


def _kv_for_local_q(k, v, hq: int, shard):
    """k/v for this rank's q heads when the q heads are sharded and the kv
    heads whole (their count does not divide the model axis): the static
    slice of the kv groups those q heads use where the groups align with
    the shard, else each q head's kv head (MHA)."""
    m = shard.rules.model_axis
    n, r = shard.size(m), shard.index(m)
    hq_l, g = hq // n, hq // k.shape[2]
    if hq_l % g == 0 or g % hq_l == 0:
        start, width = (r * hq_l) // g, max(1, hq_l // g)
        return k.narrow(2, start, width), v.narrow(2, start, width)
    return (k.repeat_interleave(g, dim=2).narrow(2, r * hq_l, hq_l),
            v.repeat_interleave(g, dim=2).narrow(2, r * hq_l, hq_l))


def _mixing_attention(cfg: ArchConfig, q, k, v, *,
                      window: Optional[int] = None,
                      scale: Optional[float] = None,
                      shard: NoShard = no_shard):
    """Causal full-sequence attention (:func:`attend`) in the mixing
    phase's layout (on one card, q, k and v as they are).  Under a
    sharder, q, k and v arrive in the token layout: the explicit hook runs
    where it applies; else they move to the fitted ``act_heads`` /
    ``act_kv_heads`` (an all-to-all where the heads divide, an all-gather
    of the sequence where the spec replicates), and the output moves back
    to the token layout.  Under megatron q, k and v are head-local
    already (module docstring)."""
    if shard.megatron:
        if not cfg.use_mla and shard.tp(cfg.num_heads) and \
                not shard.tp(cfg.num_kv_heads):
            k, v = _kv_for_local_q(k, v, cfg.num_heads, shard)
        return attend(cfg, q, k, v, window=window, scale=scale)
    if shard.explicit_a2a is not None:
        out = shard.explicit_a2a(cfg, q, k, v, window=window, scale=scale)
        if out is not None:      # None → divisibility fallback below
            return out
    hq, hkv = q.shape[2], k.shape[2]
    qh = shard(q, "act_heads")
    kh = shard(k, "act_kv_heads")
    vh = shard(v, "act_kv_heads")
    if qh.shape[2] != hq and kh.shape[2] == hkv:
        kh, vh = _kv_for_local_q(kh, vh, hq, shard)
    out = attend(cfg, qh, kh, vh, window=window, scale=scale)
    return shard(out, "act_tokens", src="act_heads",
                 shape=(shard.batch, shard.seq, hq, out.shape[-1]))


def gqa_attention(p, cfg: ArchConfig, x, positions, *,
                  window: Optional[int] = None, shard: NoShard = no_shard):
    """Full-sequence attention (scoring / prefill without a cache)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _mixing_attention(cfg, q, k, v, window=window, shard=shard)
    return _attn_output(cfg, out, p["wo"], shard)


def _attn_output(cfg: ArchConfig, out, wo, shard: NoShard):
    """The output projection in the token layout: row-parallel under
    megatron (the rank's heads' rows, summed over the model axis)."""
    return shard.row_sum(shard(_out_proj(out, wo), "act_tokens"),
                         cfg.num_heads)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # (B, S_max, H_kv, hd)
    v: torch.Tensor
    length: int         # valid prefix length


def _padded(max_len: int):
    """Makes the dense cache from the prompt's positions (zeros after)."""
    def build(t):
        buf = t.new_zeros((t.shape[0], max_len) + t.shape[2:])
        buf[:, :t.shape[1]] = t
        return buf
    return build


def _ring(s: int, window: int):
    """Makes the ring cache from the last positions of an s-long prompt
    (at most ``window``), scattered into their slots."""
    def build(t):
        slots = torch.arange(s - t.shape[1], s, device=t.device) % window
        ring = t.new_zeros((t.shape[0], window) + t.shape[2:])
        ring[:, slots] = t
        return ring
    return build


def gqa_prefill(p, cfg: ArchConfig, x, positions, max_len: int, *,
                window: Optional[int] = None, long_context: bool = False,
                shard: NoShard = no_shard):
    """Full-sequence attention that also materializes the decode cache: the
    window's ring cache for a windowed layer at ``long_context``, else the
    dense one.  Under a sharder x is the rank's block of the token layout
    and the cache the rank's shards (module docstring)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions)
    out = _mixing_attention(cfg, q, k, v, window=window, shard=shard)
    y = _attn_output(cfg, out, p["wo"], shard)
    b, s = shard.batch or x.shape[0], shard.seq or x.shape[1]
    kl = (2,) if shard.tp(cfg.num_kv_heads) else ()
    if window and long_context:
        shape, keep = (b, window, cfg.num_kv_heads, k.shape[3]), \
            min(s, window)
        build = _ring(s, window)
        return y, WindowKVCache(
            k=shard.to_cache(k, "k", shape, build, keep, kl),
            v=shard.to_cache(v, "v", shape, build, keep, kl), length=s,
            window=window)
    shape, build = (b, max_len, cfg.num_kv_heads, k.shape[3]), \
        _padded(max_len)
    return y, KVCache(k=shard.to_cache(k, "k", shape, build, local=kl),
                      v=shard.to_cache(v, "v", shape, build, local=kl),
                      length=s)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.float32, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def _merged(o, m, l, lay):
    """The softmax-weighted sum from each rank's partial output ``o``
    (unnormalised), max ``m`` and sum ``l`` over its own slots, fp32, by
    one gather over the cache's sequence axis."""
    parts = lay.partials(torch.cat([o, m, l], dim=-1))
    hv = o.shape[-1]
    mx = parts[..., hv:hv + 1]
    w = torch.exp(mx - mx.amax(dim=0))
    return (w * parts[..., :hv]).sum(dim=0) / (w * parts[..., hv + 1:]).sum(
        dim=0)


def _split_softmax(s, vals, eq: str, lay):
    """softmax(s) contracted with ``vals`` by ``eq`` (the probabilities
    first), where s (..., S_l), masked and softcapped, fp32, holds this
    rank's slots of a sequence split over ``lay.split``'s ranks."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum(eq, p, vals)
    return _merged(o, m, p.sum(dim=-1, keepdim=True), lay)


def _gqa_decode(p, cfg: ArchConfig, x, cache, shard: NoShard, *,
                ring: bool):
    """One-token decode against the dense (``ring`` False) or the ring
    cache, written in place at slot ``pos`` (``pos % window``)."""
    pos = cache.length
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = gqa_project_qkv(p, cfg, x, positions)
    b, hd = shard.batch or x.shape[0], q.shape[3]
    extent = cache.window if ring else shard.cache_len or cache.k.shape[1]
    lay = shard.cache_layout("k", (b, extent, cfg.num_kv_heads, hd))
    heads = {0: 0, 2: 2}
    ql = (2,) if shard.tp(cfg.num_heads) else ()
    kl = (2,) if shard.tp(cfg.num_kv_heads) else ()
    q = lay.take(q, heads, ql, op="tp_gather")
    k_new, v_new = (lay.take(t, heads, kl, op="tp_gather")
                    for t in (k_new, v_new))
    slot = pos % cache.window if ring else pos
    skv = cache.k.shape[1]
    j = lay.local_slot(slot, skv)
    if j is not None:
        cache.k[:, j] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, j] = v_new[:, 0].to(cache.v.dtype)
    idx = lay.offset(skv) + torch.arange(skv, device=x.device)
    if ring:
        # a slot is valid iff it holds one of the last `window` tokens
        age = (slot - idx) % cache.window                   # 0 = newest
        valid = age <= min(pos, cache.window - 1)
    else:
        valid = idx <= pos
    if lay.split is None:
        out = attention_core(q, cache.k, cache.v, valid[None, None],
                             softcap=cfg.attn_softcap)
    else:
        bl, hkv = q.shape[0], cache.k.shape[2]
        qg = q.reshape(bl, 1, hkv, q.shape[2] // hkv, hd)
        sc = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          cache.k.float()) * hd ** -0.5
        sc = torch.where(valid, nl.softcap(sc, cfg.attn_softcap), -1e30)
        out = _split_softmax(sc, cache.v.float(), "bkgst,btkh->bkgsh", lay)
        out = out.permute(0, 3, 1, 2, 4).reshape(bl, 1, -1, out.shape[-1])
        out = out.to(cache.v.dtype)
    out = lay.give(out, heads, local=ql)
    return shard.row_sum(_out_proj(out, p["wo"]), cfg.num_heads), pos + 1


def gqa_decode(p, cfg: ArchConfig, x, cache: KVCache, *,
               shard: NoShard = no_shard):
    """One-token decode against a dense cache.  x: (B, 1, D).  Writes the
    token's k/v into ``cache.k``/``cache.v`` in place."""
    y, length = _gqa_decode(p, cfg, x, cache, shard, ring=False)
    return y, KVCache(k=cache.k, v=cache.v, length=length)


# ---- sliding-window ring cache --------------------------------------------

@dataclasses.dataclass
class WindowKVCache:
    k: torch.Tensor     # (B, window, H_kv, hd) ring buffer
    v: torch.Tensor
    length: int         # total tokens seen
    window: int


def _fill_window_cache(k, v, window: int) -> WindowKVCache:
    """The last ``window`` positions scattered into their ring slots."""
    s = k.shape[1]
    build = _ring(s, window)
    start = max(0, s - window)
    return WindowKVCache(k=build(k[:, start:]), v=build(v[:, start:]),
                         length=s, window=window)


def init_window_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device="cuda") -> WindowKVCache:
    w = cfg.sliding_window
    shape = (batch, w, cfg.num_kv_heads, cfg.head_dim)
    return WindowKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device),
                         length=0, window=w)


def gqa_decode_windowed(p, cfg: ArchConfig, x, cache: WindowKVCache, *,
                        shard: NoShard = no_shard):
    """One-token decode against the O(window) ring cache; writes the token's
    k/v into slot ``pos % window`` in place."""
    y, length = _gqa_decode(p, cfg, x, cache, shard, ring=True)
    return y, WindowKVCache(k=cache.k, v=cache.v, length=length,
                            window=cache.window)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-latent attention
# ---------------------------------------------------------------------------

def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.head_dim + cfg.rope_head_dim) ** -0.5


def _mla_q(p, cfg: ArchConfig, x, positions):
    qfull = _proj_heads(x, p["wq"])
    q_nope = qfull[..., : cfg.head_dim]
    q_rope = nl.apply_rope(qfull[..., cfg.head_dim:], positions,
                           cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, cfg: ArchConfig, x, positions):
    kv_a = x @ p["wkv_a"].to(x.dtype)
    c_kv = nl.rms_norm(kv_a[..., : cfg.kv_lora_rank], p["kv_norm"].float())
    k_rope = nl.apply_rope(kv_a[..., None, cfg.kv_lora_rank:], positions,
                           cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_full(p, cfg: ArchConfig, x, positions, shard: NoShard = no_shard):
    """Full-sequence MLA: keys and values decompressed from the latents,
    the shared rope key broadcast over the heads, attention at the scale
    of the hd + rope_hd query width (hd_v = hd).  Returns (y, c_kv,
    k_rope).  Under megatron wkv_a is replicated and wq, wk_b, wv_b and
    wo hold the rank's heads."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = _proj_heads(c_kv, p["wk_b"])
    v = _proj_heads(c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        b, s, k_nope.shape[2], cfg.rope_head_dim)], dim=-1)
    out = _mixing_attention(cfg, q, k, v, scale=_mla_scale(cfg),
                            shard=shard)
    return _attn_output(cfg, out, p["wo"], shard), c_kv, k_rope


def mla_attention(p, cfg: ArchConfig, x, positions, *,
                  shard: NoShard = no_shard):
    """Full-sequence MLA (scoring / prefill without a cache)."""
    return _mla_full(p, cfg, x, positions, shard)[0]


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor      # (B, S_max, kv_lora_rank) compressed latents
    k_rope: torch.Tensor    # (B, S_max, rope_head_dim) shared rope key
    length: int


def mla_prefill(p, cfg: ArchConfig, x, positions, max_len: int, *,
                shard: NoShard = no_shard):
    """MLA prefill: full-sequence attention and the compressed cache."""
    y, c_kv, k_rope = _mla_full(p, cfg, x, positions, shard)
    b, s = shard.batch or x.shape[0], shard.seq or x.shape[1]
    build = _padded(max_len)
    return y, MLACache(
        c_kv=shard.to_cache(c_kv, "c_kv", (b, max_len, cfg.kv_lora_rank),
                            build),
        k_rope=shard.to_cache(k_rope, "k_rope",
                              (b, max_len, cfg.rope_head_dim), build),
        length=s)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.float32, device="cuda") -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype,
                           device=device),
        length=0)


def mla_decode(p, cfg: ArchConfig, x, cache: MLACache, *,
               shard: NoShard = no_shard):
    """One-token MLA decode on the compressed cache, written in place.

    The absorbed-matmul trick: the queries are pulled into latent space
    (q·W_kb), so attention runs against the (S, r) latents directly and
    the cache stays compressed; the output leaves latent space through
    W_vb.  Under a sharder the latents' sequence may be split over ranks
    (a split softmax, module docstring); the latent dim never is.  Under
    megatron the queries are the rank's heads: where the latents' sequence
    is split over the model axis, every head's latent query is gathered
    (ledger op ``tp_gather``), each rank scores its slots for all of them,
    and keeps its heads' output after the merge."""
    pos = cache.length
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    b = shard.batch or x.shape[0]
    lay = shard.cache_layout("c_kv", (b, shard.cache_len or
                                      cache.c_kv.shape[1], cfg.kv_lora_rank))
    q_nope, q_rope, c_new, kr_new = (lay.take(t, {0: 0}) for t in (
        q_nope, q_rope, c_new, kr_new))
    s_l = cache.c_kv.shape[1]
    j = lay.local_slot(pos, s_l)
    if j is not None:
        cache.c_kv[:, j] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[:, j] = kr_new[:, 0].to(cache.k_rope.dtype)
    c_kv = cache.c_kv.float()
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(x.dtype))
    every = shard.tp(cfg.num_heads) and lay.spec[1] == \
        shard.rules.model_axis
    if every:
        q_lat = shard.col_gather(q_lat.movedim(2, -1), cfg.num_heads
                                 ).movedim(-1, 2)
        q_rope = shard.col_gather(q_rope.movedim(2, -1), cfg.num_heads
                                  ).movedim(-1, 2)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             cache.k_rope.float())) * _mla_scale(cfg)
    mask = lay.offset(s_l) + torch.arange(s_l, device=x.device) <= pos
    scores = torch.where(mask, scores, -1e30)
    if lay.split is None:
        out_lat = torch.einsum("bhst,btr->bshr",
                               torch.softmax(scores, dim=-1), c_kv)
    else:
        out_lat = _split_softmax(scores, c_kv, "bhst,btr->bhsr",
                                 lay).transpose(1, 2)
    out_lat = lay.give(out_lat, {0: 0})
    if every:
        out_lat = shard.tp_block(out_lat, 2, cfg.num_heads)
    out = torch.einsum("bshr,rhk->bshk", out_lat.to(x.dtype),
                       p["wv_b"].to(x.dtype))
    y = shard.row_sum(_out_proj(out, p["wo"]), cfg.num_heads)
    return y, MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope,
                       length=pos + 1)
