"""Mixture-of-Experts: top-k router and capacity-bounded sort-based
dispatch — the port of ``repro/nn/moe.py`` on one card.

Tokens go to an expert-major layout (E, C, D), the experts' FFNs run as
batched matmuls, and each token sums its experts' outputs weighted by its
renormalised router probabilities.  No (T, E, C) one-hot: the (T·k)
assignments are sorted by expert (stably), each one's rank within its
expert comes from a ``searchsorted`` baseline, and assignments past the
capacity are dropped (combine weight 0), as in Switch/GShard.

The reference's ``ep_moe`` and ``shard`` hooks are dropped, as the port
dropped the other sharding hooks.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from . import layers as nl


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> dict:
    """The router stays fp32 whatever ``dtype`` is, as in the reference."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": nl.param(gen, (d, e)),
         "gate": nl.param(gen, (e, d, f), scale=1.0 / math.sqrt(d),
                          dtype=dtype),
         "up": nl.param(gen, (e, d, f), scale=1.0 / math.sqrt(d),
                        dtype=dtype),
         "down": nl.param(gen, (e, f, d), scale=1.0 / math.sqrt(f),
                          dtype=dtype)}
    if cfg.num_shared_experts:
        p["shared"] = nl.init_mlp(gen, d,
                                  cfg.moe_d_ff * cfg.num_shared_experts,
                                  dtype=dtype)
    return p


def capacity(cfg: ArchConfig, tokens: int, dropless: bool = False) -> int:
    """Slots per expert: ``int(max(1, ceil(T·k/E)·cf))`` with cf the
    config's ``moe_capacity_factor``, or T dropless."""
    if dropless:
        return tokens
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return int(max(1, -(-tokens * k // e) * cfg.moe_capacity_factor))


def route(p: dict, cfg: ArchConfig, xf: torch.Tensor):
    """xf (T, D) → fp32 router probabilities (T, E), and the top-k experts'
    renormalised weights and indices, each (T, k)."""
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              dropless: bool = False):
    """x: (B, S, D) → (y, aux_loss).

    Routing: fp32 softmax → top-k, renormalised.  Capacity from
    ``cfg.moe_capacity_factor``; ``dropless=True`` sets
    C = T (the decode path: the same answer whatever the routing of the
    other tokens).  ``aux_loss`` is Switch's load-balance loss (eq. 4),
    E·Σ_e mean router mass · fraction of assignments."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(t, d)

    probs, top_p, top_e = route(p, cfg, xf)

    # ---- load-balance auxiliary loss (Switch eq. 4) ----
    counts = torch.zeros(t, e, device=x.device).scatter_add_(
        1, top_e, torch.ones_like(top_p))
    aux = e * torch.sum(probs.mean(dim=0) * (counts.mean(dim=0) / k))

    # ---- sort-based dispatch ----
    cap = capacity(cfg, t, dropless)
    fe = top_e.reshape(-1)                                          # (T·k,)
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    st = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    sp = top_p.reshape(-1)[order]
    first = torch.searchsorted(se, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - first[se]   # rank in expert
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)
    buf = x.new_zeros((e, cap, d))
    buf.index_put_((se, pos_c), torch.where(keep[:, None], xf[st], 0).to(
        x.dtype), accumulate=True)

    # ---- batched expert FFN ----
    act = nl.activation(cfg.act)
    h = act(torch.bmm(buf, p["gate"].to(x.dtype))) \
        * torch.bmm(buf, p["up"].to(x.dtype))
    y_buf = torch.bmm(h, p["down"].to(x.dtype))                     # (E,C,D)

    # ---- combine ----
    gathered = y_buf[se, pos_c] * (sp * keep)[:, None].to(x.dtype)
    yf = x.new_zeros((t, d)).index_add_(0, st, gathered)
    if "shared" in p:
        yf = yf + nl.mlp(p["shared"], xf, cfg.act)
    return yf.reshape(b, s, d), aux

