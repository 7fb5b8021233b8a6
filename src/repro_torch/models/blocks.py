"""Per-layer blocks and layer grouping for the decoder: the port of
``repro/models/blocks.py`` for the kinds ``mamba``, ``dense`` and
``shared_attn``.

A config's layers are grouped into repeating *units* (zamba2: unit
("mamba",)*5 + ("shared_attn",) × 9 groups, the shared_attn parameters
weight-tied across groups); the model loops over the repeats.  The kinds
``moe``, ``local``/``global`` and the ``post_norm`` branches raise until
ported (ROADMAP queue 1 items 21 and 23).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..nn import attention as attn
from ..nn import layers as nl
from ..nn import ssm as ssm_lib

KINDS = ("mamba", "dense", "shared_attn")


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


def _check(cfg: ArchConfig, kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} is not ported (moe: ROADMAP "
            f"queue 1 item 21; local/global: item 23)")
    if cfg.post_norm:
        raise NotImplementedError(
            f"{cfg.name}: post_norm blocks are not ported (ROADMAP queue 1 "
            f"item 23)")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    _check(cfg, kind)
    if kind == "mamba":
        return {"norm": nl.init_rms_norm(gen, cfg.d_model),
                "mixer": ssm_lib.init_mamba2(gen, cfg)}
    return {"attn_norm": nl.init_rms_norm(gen, cfg.d_model),
            "attn": attn.init_attention(gen, cfg),
            "mlp_norm": nl.init_rms_norm(gen, cfg.d_model),
            "mlp": nl.init_mlp(gen, cfg.d_model, cfg.d_ff)}


def _norm(w, x, cfg: ArchConfig):
    return nl.rms_norm(x, w.float(), cfg.norm_eps, plus_one=cfg.post_norm)


def apply_block(p: dict, cfg: ArchConfig, kind: str, x, positions):
    """Full-sequence block application (scoring).  Returns x."""
    _check(cfg, kind)
    if kind == "mamba":
        return x + ssm_lib.mamba2_forward(p["mixer"], cfg,
                                          _norm(p["norm"], x, cfg))
    x = x + attn.gqa_attention(p["attn"], cfg, _norm(p["attn_norm"], x, cfg),
                               positions)
    return x + nl.mlp(p["mlp"], _norm(p["mlp_norm"], x, cfg), cfg.act)


def apply_block_prefill(p: dict, cfg: ArchConfig, kind: str, x, positions,
                        max_len: int):
    """Full-sequence block that also materializes the decode cache.
    Returns (x, cache)."""
    _check(cfg, kind)
    if kind == "mamba":
        y, cache = ssm_lib.mamba2_prefill(p["mixer"], cfg,
                                          _norm(p["norm"], x, cfg))
        return x + y, cache
    a, cache = attn.gqa_prefill(p["attn"], cfg, _norm(p["attn_norm"], x, cfg),
                                positions, max_len)
    x = x + a
    return x + nl.mlp(p["mlp"], _norm(p["mlp_norm"], x, cfg), cfg.act), cache


# ---------------------------------------------------------------------------
# Decode-step application (single token, per-layer cache)
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.float32, device="cuda"):
    _check(cfg, kind)
    if kind == "mamba":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device)


def apply_block_decode(p: dict, cfg: ArchConfig, kind: str, x, cache):
    """One-token step.  Returns (x, new_cache)."""
    _check(cfg, kind)
    if kind == "mamba":
        y, cache = ssm_lib.mamba2_decode(p["mixer"], cfg,
                                         _norm(p["norm"], x, cfg), cache)
        return x + y, cache
    a, cache = attn.gqa_decode(p["attn"], cfg, _norm(p["attn_norm"], x, cfg),
                               cache)
    x = x + a
    return x + nl.mlp(p["mlp"], _norm(p["mlp_norm"], x, cfg), cfg.act), cache
