"""Mixture-of-Experts: top-k router and capacity-bounded sort-based
dispatch — the port of ``repro/nn/moe.py`` on one card.

Tokens go to an expert-major layout (E, C, D), the experts' FFNs run as
batched matmuls, and each token sums its experts' outputs weighted by its
renormalised router probabilities.  No (T, E, C) one-hot: the (T·k)
assignments are sorted by expert (stably), each one's rank within its
expert comes from a ``searchsorted`` baseline, and assignments past the
capacity are dropped (combine weight 0), as in Switch/GShard.

Under a sharder (``moe_apply``'s ``shard``) x is this rank's block of
the token layout and the expert weights its own experts (E/n where the
experts shard over the model axis).  The load-balance loss's sums (router
mass, assignment counts, token count) are summed over every rank before
the product, which is not a sum of per-rank pieces.  The explicit
sharder's ``ep_moe`` dispatches locally; otherwise the routing decisions
and the token rows are gathered over the token layout's axes, every rank
dispatches every token as the unsharded layer does (so its drops are the
unsharded layer's), runs its own experts, gathers the expert outputs over
the model axis and keeps its own tokens' combination.  Under megatron
every model rank holds its batch block's whole sequence: the dispatch
spans the data axes (the reference's global capacity and drops), each
rank combines its own experts' outputs for its tokens, and those partial
outputs are summed over the model axis (``Sharder.row_sum``), as are the
shared experts' (row-parallel, :func:`repro_torch.nn.layers.mlp`).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from . import layers as nl
from .shard import NoShard, no_shard


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


def _aux(cfg: ArchConfig, probs, top_p, top_e, shard):
    """Switch's load-balance loss (eq. 4), E·Σ_e mean router mass ·
    fraction of assignments; under a sharder from sums over every rank."""
    t, e, k = probs.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    counts = torch.zeros(t, e, device=probs.device).scatter_add_(
        1, top_e, torch.ones_like(top_p))
    if not shard.active:
        return e * torch.sum(probs.mean(dim=0) * (counts.mean(dim=0) / k))
    sums = shard.psum_all(torch.cat([probs.sum(dim=0), counts.sum(dim=0),
                                     probs.new_full((1,), t)]))
    n_tok = sums[-1]
    return e * torch.sum(sums[:e] / n_tok * (sums[e:2 * e] / n_tok / k))


def _dispatch(cfg: ArchConfig, top_e, top_p, cap: int):
    """The sort-based dispatch of (T, k) assignments: (sorted expert,
    token, weight, slot, kept) of each assignment."""
    t, k = top_e.shape
    e = cfg.num_experts
    dev = top_e.device
    fe = top_e.reshape(-1)                                          # (T·k,)
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    st = torch.arange(t, device=dev).repeat_interleave(k)[order]
    sp = top_p.reshape(-1)[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - first[se]        # rank in expert
    keep = pos < cap
    return se, st, sp, torch.where(keep, pos, cap - 1), keep


def _buffer(cfg: ArchConfig, xf, se, st, pos_c, keep, cap: int):
    """The expert-major buffer (E, C, D) of the kept assignments' rows."""
    buf = xf.new_zeros((cfg.num_experts, cap, xf.shape[-1]))
    return buf.index_put_((se, pos_c), torch.where(keep[:, None], xf[st], 0)
                          .to(xf.dtype), accumulate=True)


def _experts(p: dict, cfg: ArchConfig, buf):
    """The batched expert FFNs on an expert-major buffer (E, C, D)."""
    act = nl.activation(cfg.act)
    h = act(torch.bmm(buf, p["gate"].to(buf.dtype))) \
        * torch.bmm(buf, p["up"].to(buf.dtype))
    return torch.bmm(h, p["down"].to(buf.dtype))


def moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              dropless: bool = False, shard: NoShard = no_shard):
    """x: (B, S, D) → (y, aux_loss).

    Routing: fp32 softmax → top-k, renormalised.  Capacity from
    ``cfg.moe_capacity_factor``; ``dropless=True`` sets
    C = T (the decode path: the same answer whatever the routing of the
    other tokens).  ``aux_loss`` is Switch's load-balance loss (eq. 4),
    E·Σ_e mean router mass · fraction of assignments."""
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_tok
    xf = x.reshape(t, d)
    probs, top_p, top_e = route(p, cfg, xf)
    aux = _aux(cfg, probs, top_p, top_e, shard)
    y = None
    if not dropless and shard.ep_moe is not None:
        y = shard.ep_moe(p, cfg, x, top_e.reshape(b, s, k),
                         top_p.reshape(b, s, k), cfg.moe_capacity_factor)
    if y is None:
        y = _dispatched(p, cfg, x, top_e.reshape(b, s, k),
                        top_p.reshape(b, s, k), dropless, shard)
        y = shard.row_sum(y, cfg.num_experts)
    if "shared" in p:
        y = y + nl.mlp(p["shared"], xf, cfg.act, shard, cfg.moe_d_ff
                       * cfg.num_shared_experts).reshape(b, s, d)
    return y, aux


def _dispatched(p: dict, cfg: ArchConfig, x, top_e, top_p, dropless,
                shard):
    """The routed experts' output of x's tokens by the sort-based dispatch
    of every token.  Under a sharder (module docstring) the routing and
    the token rows are gathered over the token layout's axes first, the
    rank runs its own experts (``p``'s), their outputs are gathered over
    the model axis, and the rank keeps its own tokens' combination; under
    megatron the rank's tokens' combination of its own experts' outputs
    (partial: the caller sums it over the model axis)."""
    big_b, big_s = shard.batch or x.shape[0], shard.seq or x.shape[1]
    t, d, k = big_b * big_s, x.shape[-1], cfg.num_experts_per_tok
    xg = shard(x, "act_global").reshape(t, d)
    te = shard(top_e, "act_global").reshape(t, k)
    tp = shard(top_p, "act_global").reshape(t, k)
    cap = capacity(cfg, t, dropless)
    se, st, sp, pos_c, keep = _dispatch(cfg, te, tp, cap)
    buf = _buffer(cfg, xg, se, st, pos_c, keep, cap)
    e_l = p["gate"].shape[0]
    wsp = (sp * keep)[:, None].to(x.dtype)
    if shard.tp(cfg.num_experts):
        lo = shard.index(shard.rules.model_axis) * e_l
        own = (se >= lo) & (se < lo + e_l)
        y_buf = _experts(p, cfg, buf[lo: lo + e_l])
        gathered = y_buf[(se - lo).clamp(0, e_l - 1), pos_c] * torch.where(
            own[:, None], wsp, 0)
        yf = x.new_zeros((t, d)).index_add_(0, st, gathered)
        return shard(yf.reshape(big_b, big_s, d), "act_tokens",
                     src="act_global")
    if e_l == cfg.num_experts:
        y_buf = _experts(p, cfg, buf)                               # (E,C,D)
    else:
        lo = shard.index(shard.rules.model_axis) * e_l
        y_buf = shard.move(_experts(p, cfg, buf[lo: lo + e_l]),
                           (shard.rules.model_axis, None, None),
                           (None, None, None))
    gathered = y_buf[se, pos_c] * wsp
    yf = x.new_zeros((t, d)).index_add_(0, st, gathered)
    return shard(yf.reshape(big_b, big_s, d), "act_tokens",
                 src="act_global")
