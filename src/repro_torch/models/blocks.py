"""Per-layer blocks and layer grouping for the decoder: the port of
``repro/models/blocks.py``.

A config's layers are grouped into repeating *units*; the model loops over
the repeats:

  dense archs     → unit ("dense",) × L           (gemma2: ("local","global"))
  deepseek        → 1 dense layer + unit ("moe",) × 26
  mamba2          → unit ("mamba",) × 48
  zamba2          → unit ("mamba",)*5 + ("shared_attn",) × 9 groups, the
                    shared_attn parameters weight-tied across groups

``post_norm`` (gemma2) adds norms after attention and after the MLP, and
makes every norm of the block scale by (1 + w).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..nn import attention as attn
from ..nn import layers as nl
from ..nn import moe as moe_lib
from ..nn import ssm as ssm_lib
from ..nn.shard import NoShard, no_shard


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    unit: tuple[str, ...]   # block kinds within one repeat
    repeats: int            # number of repeats


def layer_groups(cfg: ArchConfig) -> list[GroupSpec]:
    kinds = cfg.layer_kinds()
    groups: list[GroupSpec] = []
    i = 0
    if cfg.moe and cfg.first_dense_layers:
        groups.append(GroupSpec(("dense",) * cfg.first_dense_layers, 1))
        i = cfg.first_dense_layers
    rest = kinds[i:]
    if not rest:
        return groups
    # the shortest repeating unit of the remaining pattern
    for unit_len in range(1, len(rest) + 1):
        if len(rest) % unit_len:
            continue
        unit = tuple(rest[:unit_len])
        if all(tuple(rest[j:j + unit_len]) == unit
               for j in range(0, len(rest), unit_len)):
            groups.append(GroupSpec(unit, len(rest) // unit_len))
            return groups
    groups.append(GroupSpec(tuple(rest), 1))
    return groups


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
               dtype=torch.float32) -> dict:
    if kind == "mamba":
        return {"norm": nl.init_rms_norm(gen, cfg.d_model),
                "mixer": ssm_lib.init_mamba2(gen, cfg, dtype)}
    p = {"attn_norm": nl.init_rms_norm(gen, cfg.d_model,
                                       plus_one=cfg.post_norm),
         "attn": attn.init_attention(gen, cfg, dtype),
         "mlp_norm": nl.init_rms_norm(gen, cfg.d_model,
                                      plus_one=cfg.post_norm)}
    if cfg.post_norm:   # gemma2: extra post-block norms
        p["attn_post_norm"] = nl.init_rms_norm(gen, cfg.d_model,
                                               plus_one=True)
        p["mlp_post_norm"] = nl.init_rms_norm(gen, cfg.d_model,
                                              plus_one=True)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = nl.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _norm(w, x, cfg: ArchConfig):
    return nl.rms_norm(x, w.float(), cfg.norm_eps, plus_one=cfg.post_norm)


def _window(cfg: ArchConfig, kind: str):
    return cfg.sliding_window if kind == "local" else None


def _attn_out(p: dict, cfg: ArchConfig, x, a):
    """The residual after attention output ``a`` (post-normed under
    ``post_norm``)."""
    if cfg.post_norm:
        a = _norm(p["attn_post_norm"], a, cfg)
    return x + a


def _ffn(p: dict, cfg: ArchConfig, kind: str, x, *, dropless=False,
         shard: NoShard = no_shard):
    """The MLP or MoE half of a block on the residual x.  Returns (x,
    aux_loss)."""
    h = shard(_norm(p["mlp_norm"], x, cfg), "act_tokens")
    aux = x.new_zeros((), dtype=torch.float32)
    if kind == "moe":
        m, aux = moe_lib.moe_apply(p["moe"], cfg, h, dropless=dropless,
                                   shard=shard)
    else:
        m = nl.mlp(p["mlp"], h, cfg.act, shard, cfg.d_ff)
    if cfg.post_norm:
        m = _norm(p["mlp_post_norm"], m, cfg)
    return x + m, aux


def apply_block(p: dict, cfg: ArchConfig, kind: str, x, positions, *,
                shard: NoShard = no_shard):
    """Full-sequence block application (scoring, training).  Returns (x,
    aux_loss).  Under a sharder x is this rank's block of the token
    layout, ``positions`` its global positions."""
    if kind == "mamba":
        return x + ssm_lib.mamba2_forward(p["mixer"], cfg,
                                          _norm(p["norm"], x, cfg),
                                          shard=shard), \
            x.new_zeros((), dtype=torch.float32)
    h = _norm(p["attn_norm"], x, cfg)
    if cfg.use_mla:
        a = attn.mla_attention(p["attn"], cfg, h, positions, shard=shard)
    else:
        a = attn.gqa_attention(p["attn"], cfg, h, positions,
                               window=_window(cfg, kind), shard=shard)
    return _ffn(p, cfg, kind, _attn_out(p, cfg, x, a), shard=shard)


def apply_block_prefill(p: dict, cfg: ArchConfig, kind: str, x, positions,
                        max_len: int, *, long_context: bool = False,
                        shard: NoShard = no_shard):
    """Full-sequence block that also materializes the decode cache.
    Returns (x, cache); under a sharder the rank's token block and cache
    shards."""
    if kind == "mamba":
        y, cache = ssm_lib.mamba2_prefill(p["mixer"], cfg,
                                          _norm(p["norm"], x, cfg),
                                          shard=shard)
        return x + y, cache
    h = _norm(p["attn_norm"], x, cfg)
    if cfg.use_mla:
        a, cache = attn.mla_prefill(p["attn"], cfg, h, positions, max_len,
                                    shard=shard)
    else:
        a, cache = attn.gqa_prefill(p["attn"], cfg, h, positions, max_len,
                                    window=_window(cfg, kind),
                                    long_context=long_context, shard=shard)
    return _ffn(p, cfg, kind, _attn_out(p, cfg, x, a), shard=shard)[0], \
        cache


# ---------------------------------------------------------------------------
# Decode-step application (single token, per-layer cache)
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.float32, device="cuda",
                     long_context: bool = False):
    """Cache of one block.  ``long_context`` puts gemma2's local layers on
    the O(window) ring buffer."""
    if kind == "mamba":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
    if cfg.use_mla:
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind == "local" and long_context and cfg.sliding_window:
        return attn.init_window_cache(cfg, batch, dtype, device)
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device)


def apply_block_decode(p: dict, cfg: ArchConfig, kind: str, x, cache, *,
                       shard: NoShard = no_shard):
    """One-token step.  Returns (x, new_cache).  A local layer on the dense
    cache attends to every cached token, with no window: the reference's
    decode does the same.  Under a sharder x is the rank's batch block,
    replicated over the model axis, and the cache the rank's shards."""
    if kind == "mamba":
        y, cache = ssm_lib.mamba2_decode(p["mixer"], cfg,
                                         _norm(p["norm"], x, cfg), cache,
                                         shard=shard)
        return x + y, cache
    h = _norm(p["attn_norm"], x, cfg)
    if cfg.use_mla:
        a, cache = attn.mla_decode(p["attn"], cfg, h, cache, shard=shard)
    elif isinstance(cache, attn.WindowKVCache):
        a, cache = attn.gqa_decode_windowed(p["attn"], cfg, h, cache,
                                            shard=shard)
    else:
        a, cache = attn.gqa_decode(p["attn"], cfg, h, cache, shard=shard)
    x = _attn_out(p, cfg, x, a)
    return _ffn(p, cfg, kind, x, dropless=True, shard=shard)[0], cache
