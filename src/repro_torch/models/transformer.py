"""Decoder-only LM: the port of ``repro/models/transformer.py`` for all ten
configs (every block kind: dense, moe, local/global, mamba2 and zamba2's
weight-tied shared attention block; the vision and audio configs' modality
prefix).

The parameter tree is the reference's value tree: ``{"embed",
"final_norm", "head", "mm_proj", "shared_block", "groups"}``, ``groups``
one list per layer group of per-unit-position entries, stacked along a
leading repeats axis when the group repeats, with ``{}`` placeholders at
the ``shared_attn`` positions.  Python loops over the repeats replace
``lax.scan``.  :func:`forward` (scoring, training) and :func:`prefill`
pre-cast the weights to the compute dtype as the reference does;
:func:`decode_step` does not, and relies on the in-block casts, as the
reference.  Under a gradient, :func:`forward` checkpoints each repeat of a
repeated group (``remat``), as the reference's ``jax.checkpoint`` of its
scan body.

Multimodal (vlm/audio) configs take precomputed frontend embeddings (the
stub frontend), projected by ``mm_proj`` and placed before the token
embeddings by :func:`assemble_inputs`; positions run over prefix and
tokens.

Under a sharder (``repro_torch.sharding``), :func:`forward` runs this
rank's part of a (data, model) mesh's program on parameter shards: the
token layout in, the blocks' weights gathered at use (and again in a
checkpoint's recompute), the logits of the rank's tokens out.
:func:`prefill` runs the same program and returns the rank's shards of
the caches (``cache_shardings``' layouts); :func:`decode_step` takes the
global token batch, runs the rank's batch block with the NN phase
replicated over the model axis, gathers the weights at use (each
block's shards and the head's cast to the compute dtype before the
gather, as ``_cast_compute`` casts them: the same values as the in-block
casts, half the bytes in bf16) and returns the rank's block of the logits
and its cache shards.  Under the megatron strategy the blocks' weights and
the vocab-split embedding and head keep their model shards at use (only
the FSDP shards are gathered): the input embedding is a masked lookup of
the rank's rows summed over the model axis (``nn.layers.embed``), and the
head's vocab-split logits are gathered whole over the model axis before
the softcap, the padding mask and the loss (:func:`unembed`; ledger op
``tp_gather``) — the loss is the plain log-softmax of whole logits, not a
vocab-parallel one.

Decode caches mirror the group structure; :func:`decode_step` writes the
new token's state into the cache tensors in place (see
``nn/attention.py``) and returns caches with the advanced length.  A
cache's tensor fields are stacked over a group's repeats; its other fields
(``length``, a ring cache's ``window``) are shared by the repeats.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..configs.base import ArchConfig
from ..nn import layers as nl
from ..nn.shard import NoShard, no_shard
from ..params import tree_map
from ..runtime import telemetry
from . import blocks as B

_KEEP_F32 = ("router", "norm")   # routing logits + norm scales stay fp32
REMAT = (True, False, "dots")
# remat="dots" keeps the outputs of plain matmuls (the projections) and
# recomputes the rest, batched products (attention's, the experts') too:
# the torch form of ``dots_with_no_batch_dims_saveable``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_transformer(cfg: ArchConfig, seed: int = 0, device="cuda",
                     dtype=torch.float32) -> dict:
    """Parameters drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, in the reference's tree layout, in ``dtype`` but for the
    leaves the reference keeps fp32 (norms, the MoE router, mamba2's decay
    rates and skip).  A repeated block is drawn one repeat at a time into
    its stacked leaves.  Modality configs get ``mm_proj``, a dense
    (d_model, d_model) projection of the prefix without bias.  On the
    meta device nothing is drawn: the tree's shapes and dtypes alone."""
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": nl.init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                   dtype),
        "final_norm": nl.init_rms_norm(gen, cfg.d_model,
                                       plus_one=cfg.post_norm),
    }
    if not cfg.tie_embeddings:
        params["head"] = nl.param(gen, (cfg.d_model, cfg.padded_vocab),
                                  dtype=dtype)
    if cfg.modality:
        params["mm_proj"] = nl.init_dense(gen, cfg.d_model, cfg.d_model,
                                          dtype=dtype)
    if cfg.hybrid_attn_every:
        params["shared_block"] = B.init_block(gen, cfg, "shared_attn",
                                              dtype)
    groups = []
    for g in B.layer_groups(cfg):
        unit = []
        for kind in g.unit:
            if kind == "shared_attn":
                unit.append({})          # weight-tied → placeholder
                continue
            first = B.init_block(gen, cfg, kind, dtype)
            if g.repeats == 1:
                unit.append(first)
                continue
            stacked = tree_map(
                lambda t: t.new_empty((g.repeats,) + t.shape), first)
            for r in range(g.repeats):
                blk = first if r == 0 else B.init_block(gen, cfg, kind, dtype)
                tree_map(lambda dst, src: dst[r].copy_(src), stacked, blk)
            unit.append(stacked)
        groups.append(unit)
    params["groups"] = groups
    return params


def _cast_compute(tree, dtype: torch.dtype, key: Optional[str] = None):
    """Pre-cast fp32 weights of ndim ≥ 2 to the compute dtype, outside the
    layer loop, as the reference does.  Leaves whose innermost dict key
    names a router or a norm stay fp32 (so do stacked 1-d leaves that are
    not: the reference casts those too)."""
    if dtype == torch.float32:
        return tree
    if isinstance(tree, dict):
        return {k: _cast_compute(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_compute(v, dtype, key) for v in tree)
    if tree.dtype != torch.float32 or tree.dim() < 2 or \
            (key is not None and any(t in key for t in _KEEP_F32)):
        return tree
    return tree.to(dtype)


def _rep(tree, r: int):
    """Repeat ``r`` of a stacked tree (views)."""
    return tree_map(lambda t: t[r], tree)


def assemble_inputs(params, cfg: ArchConfig, tokens: torch.Tensor,
                    prefix_embeddings: Optional[torch.Tensor] = None,
                    shard: NoShard = no_shard) -> torch.Tensor:
    """tokens (B, S_t) [+ prefix (B, P, D)] → embeddings (B, P + S_t, D),
    fp32: a modality config's prefix through ``mm_proj`` in fp32, before
    the token embeddings, the whole scaled by √d."""
    x = _embed(params, cfg, tokens, shard)
    if cfg.modality:
        if prefix_embeddings is None:
            raise ValueError(f"{cfg.name} needs frontend embeddings "
                             f"(prefix_embeddings of (B, "
                             f"{cfg.num_prefix_embeddings}, {cfg.d_model}))")
        pre = nl.dense(params["mm_proj"], prefix_embeddings.float())
        x = torch.cat([pre, x], dim=1)
    return x * math.sqrt(float(cfg.d_model))


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor,
           shard: NoShard = no_shard) -> torch.Tensor:
    """fp32 rows of the table (gathered first, then widened: the same
    values as the reference's widen-then-gather, without an fp32 copy of
    the table)."""
    return nl.embed(params["embed"], tokens, shard,
                    cfg.padded_vocab).float()


def _groups(params, cfg: ArchConfig, dtype: torch.dtype):
    """(group spec, each repeat's unit of block params) for every layer
    group in order, weights pre-cast; a ``shared_attn`` position holds the
    shared block."""
    shared = (_cast_compute(params["shared_block"], dtype)
              if cfg.hybrid_attn_every else None)
    for gspec, gp in zip(B.layer_groups(cfg), params["groups"]):
        cast = [_cast_compute(p, dtype) if p else {} for p in gp]
        reps = [cast] if gspec.repeats == 1 else \
            [[_rep(p, r) for p in cast] for r in range(gspec.repeats)]
        yield gspec, [[shared if kind == "shared_attn" else p
                       for kind, p in zip(gspec.unit, unit)]
                      for unit in reps]


def _sharded_groups(params, cfg: ArchConfig, dtype: torch.dtype, specs):
    """:func:`_groups` of a tree of shards, each repeat's unit beside its
    leaves' :class:`~repro_torch.sharding.specs.ParamSpec` (a stacked
    leaf's without its repeats dim)."""
    for (gspec, reps), gs in zip(_groups(params, cfg, dtype),
                                 specs["groups"]):
        if gspec.repeats > 1:
            gs = [tree_map(lambda sp: sp.rep(), s) for s in gs]
        us = [specs["shared_block"] if kind == "shared_attn" else s
              for kind, s in zip(gspec.unit, gs)]
        yield gspec, [(unit, us) for unit in reps]


def _unit_step(cfg: ArchConfig, kinds, unit, positions, x, *,
               shard: NoShard = no_shard, specs=None):
    """One repeat of a group's unit: (x, the unit's summed aux loss).
    Under a sharder each block's shards are gathered here, at use (and
    again in a checkpoint's recompute)."""
    aux_sum = x.new_zeros((), dtype=torch.float32)
    for i, (kind, p_blk) in enumerate(zip(kinds, unit)):
        if specs is not None:
            p_blk = shard.gather(p_blk, specs[i])
        x, aux = B.apply_block(p_blk, cfg, kind, x, positions, shard=shard)
        aux_sum = aux_sum + aux
    return x, aux_sum


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(step, remat: Union[bool, str], sharded: bool = False):
    """``step`` under activation checkpointing where a gradient is being
    recorded (``remat`` True: recompute the whole unit in the backward;
    ``"dots"``: keep the plain matmuls' outputs); as is otherwise, so a
    forward under ``no_grad`` runs once.  ``sharded``: the recompute reruns
    the unit's collectives, every one of them (no early stop, so every
    rank reruns the same calls), recorded as recomputed calls into the
    ledgers the forward saw (``telemetry.recompute_scope``)."""
    if not remat or not torch.is_grad_enabled():
        return step
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    if not sharded:
        return functools.partial(checkpoint, step, use_reentrant=False, **kw)
    seen = []

    def counted(x):
        if not seen:
            seen.append(telemetry.active_ledgers())
            return step(x)
        with telemetry.recompute_scope(seen[0]):
            return step(x)

    def run(x):
        with set_checkpoint_early_stop(False):
            return checkpoint(counted, x, use_reentrant=False, **kw)
    return run


def _inputs(params, cfg: ArchConfig, tokens, prefix_embeddings, shard,
            dtype):
    """(top-level leaves, the input embeddings in the compute dtype, their
    positions, the sharder bound to the global batch and length, the
    groups of :func:`_groups` with each unit's leaf specs — or None
    unsharded).  Under a sharder: the top-level leaves gathered, the
    global batch's rank block in the token layout at global positions."""
    if not shard.active:
        x = assemble_inputs(params, cfg, tokens, prefix_embeddings).to(dtype)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        groups = ((g, [(unit, None) for unit in reps])
                  for g, reps in _groups(params, cfg, dtype))
        return params, x, positions, shard, groups
    specs = shard.param_specs(cfg)
    top = {k: shard.gather(params[k], specs[k]) for k in _TOP
           if k in params}
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    if prefix_embeddings is not None:
        prefix_embeddings = torch.as_tensor(prefix_embeddings,
                                            device=tokens.device)
    x = assemble_inputs(top, cfg, shard.take_batch(tokens),
                        shard.take_batch(prefix_embeddings), shard).to(dtype)
    shard = shard.bound(tokens.shape[0], x.shape[1])
    x = shard(x, "act_tokens", src="act_seq")
    positions = shard.positions(*x.shape[:2], x.device)
    return top, x, positions, shard, _sharded_groups(params, cfg, dtype,
                                                     specs)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeddings: Optional[torch.Tensor] = None, *,
            shard: NoShard = no_shard, remat: Union[bool, str] = True,
            return_final_hidden: bool = False):
    """Full-sequence forward (scoring, training).  Returns (logits
    (B, P + S, V), aux_loss), aux_loss the sum of the MoE layers'
    load-balance losses (fp32); with ``return_final_hidden``, (the final
    norm's output (B, P + S, D) in fp32, aux_loss) and no unembedding.

    ``remat`` (True | False | ``"dots"``) applies where grad mode is on:
    each repeat of a repeated group (groups of one repeat are not) runs
    under ``torch.utils.checkpoint``, as the reference checkpoints its scan
    body.

    Under a :class:`~repro_torch.sharding.specs.Sharder` ``shard``,
    ``params`` are this rank's shards (``sharding.specs.place_params``)
    and ``tokens`` / ``prefix_embeddings`` the global batch; the logits
    returned are this rank's block of the token layout (its batch block,
    its sequence block, every vocab id: ``Sharder.unshard`` gathers them)
    and aux_loss the global one: the embedding, final norm, head and
    prefix projection gathered for the whole forward, each block's
    weights at use; the input in the token layout at global positions
    (prefix and tokens counted together)."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r} is not one of {REMAT}")
    dtype = compute_dtype(cfg)
    top, x, positions, shard, groups = _inputs(
        params, cfg, tokens, prefix_embeddings, shard, dtype)
    aux_total = x.new_zeros((), dtype=torch.float32)
    for gspec, reps in groups:
        for unit, unit_specs in reps:
            step = functools.partial(_unit_step, cfg, gspec.unit, unit,
                                     positions, shard=shard,
                                     specs=unit_specs)
            if gspec.repeats > 1:
                step = _rematted(step, remat, shard.active)
            x, aux = step(x)
            aux_total = aux_total + aux
    x = nl.rms_norm(x, top["final_norm"].float(), cfg.norm_eps,
                    plus_one=cfg.post_norm)
    if return_final_hidden:
        return x, aux_total
    return unembed(top, cfg, x, shard), aux_total


# gathered whole for the whole sharded forward
_TOP = ("embed", "final_norm", "head", "mm_proj")


def unembed(params, cfg: ArchConfig, x: torch.Tensor,
            shard: NoShard = no_shard) -> torch.Tensor:
    """fp32 logits, softcapped and with the padded ids masked.  Without a
    gradient both run in place (the (B, S, V) buffer is the largest of a
    long prefill); where the logits take part in a gradient the softcap
    runs out of place (tanh's backward reads its output), with the same
    values.  Under megatron a vocab-split head (or tied table) gives the
    rank's vocab block, gathered whole over the model axis in the compute
    dtype first (module docstring)."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    logits = shard.col_gather(logits, cfg.padded_vocab).float()
    if cfg.logit_softcap is not None:      # nl.softcap's ops
        if logits.requires_grad:
            logits = nl.softcap(logits, cfg.logit_softcap)
        else:
            logits.div_(cfg.logit_softcap).tanh_().mul_(cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # pad ids can never be predicted or contribute to the lse
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits.masked_fill_(pad, -1e30)
    return logits


def _tensor_fields(cache) -> list[str]:
    """The cache's tensor fields (not ``length``, nor a ring's ``window``)."""
    return [f.name for f in dataclasses.fields(cache)
            if torch.is_tensor(getattr(cache, f.name))]


def _stack_caches(caches: list):
    """One cache of a repeated unit position from its per-repeat caches."""
    first = caches[0]
    return dataclasses.replace(first, **{
        name: torch.stack([getattr(c, name) for c in caches])
        for name in _tensor_fields(first)})


def _rep_cache(stacked, r: int):
    """Repeat ``r`` of a stacked cache (views of its tensors)."""
    return dataclasses.replace(stacked, **{
        name: getattr(stacked, name)[r] for name in _tensor_fields(stacked)})


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeddings: Optional[torch.Tensor] = None, *,
            max_len: int, long_context: bool = False,
            shard: NoShard = no_shard, last_only: bool = False):
    """Run the prompt (behind a modality config's prefix) through the
    stack, materializing decode caches (at ``long_context``, ring caches on
    gemma2's local layers).  Returns (logits (B, P + S, V), caches), the
    caches' length P + S.  Under a sharder, as :func:`forward`: the
    rank's block of the logits' token layout and its cache shards.
    ``last_only`` unembeds the final position alone — logits (B, 1, V),
    all that decode needs, without the (B, P + S, V) buffer; under a
    sharder that splits the sequence, the rank holding the final
    position's block gives it to its model group
    (``Sharder.last_position``)."""
    dtype = compute_dtype(cfg)
    top, x, positions, shard, groups = _inputs(
        params, cfg, tokens, prefix_embeddings, shard.serving(max_len),
        dtype)
    caches = []
    for gspec, reps in groups:
        per_rep = []
        for unit, unit_specs in reps:
            unit_caches = []
            for i, (kind, p_blk) in enumerate(zip(gspec.unit, unit)):
                if unit_specs is not None:
                    p_blk = shard.gather(p_blk, unit_specs[i])
                x, c = B.apply_block_prefill(p_blk, cfg, kind, x, positions,
                                             max_len,
                                             long_context=long_context,
                                             shard=shard)
                unit_caches.append(c)
            per_rep.append(unit_caches)
        caches.append(per_rep[0] if gspec.repeats == 1 else
                      [_stack_caches([rep[u] for rep in per_rep])
                       for u in range(len(gspec.unit))])
    x = nl.rms_norm(x, top["final_norm"].float(), cfg.norm_eps,
                    plus_one=cfg.post_norm)
    if last_only:
        x = shard.last_position(x)
    return unembed(top, cfg, x, shard), caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.float32, device="cuda",
                long_context: bool = False):
    """Empty caches mirroring the group structure."""
    caches = []
    for g in B.layer_groups(cfg):
        unit_caches = []
        for kind in g.unit:
            one = B.init_block_cache(cfg, kind, batch, max_len, dtype, device,
                                     long_context)
            unit_caches.append(one if g.repeats == 1 else
                               _stack_caches([one] * g.repeats))
        caches.append(unit_caches)
    return caches


def _set_rep(stacked, r: int, new) -> None:
    """Write repeat ``r``'s new cache into the stacked cache (tensors the
    block updated in place through a view are already there)."""
    for name in _tensor_fields(stacked):
        dst, src = getattr(stacked, name)[r], getattr(new, name)
        if not src.is_set_to(dst):
            dst.copy_(src)


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, caches, *,
                shard: NoShard = no_shard):
    """token (B, 1) → (logits (B, 1, V), caches advanced by one token).

    The weights are not pre-cast (the blocks cast each use), as the
    reference.  The cache tensors are updated in place: the caches passed
    in are consumed.  Under a sharder ``params`` and ``caches`` are the
    rank's shards, ``token`` the global batch, the sharder bound to the
    caches' ``max_len`` (``Sharder.serving``, which ``make_serve_fns``
    does); the logits returned are the rank's batch block (module
    docstring)."""
    dtype = compute_dtype(cfg)
    specs = None
    top = params
    if shard.active:
        if shard.cache_len is None:
            raise ValueError(
                "a sharded decode step needs the caches' max_len, which a "
                "rank's shard does not show: pass shard=sharder.serving("
                "max_len) (make_serve_fns' closures do)")
        specs = shard.param_specs(cfg)
        top = {k: shard.gather(_cast_compute(params[k], dtype, k)
                               if k == "head" else params[k], specs[k])
               for k in _TOP if k in params and k != "mm_proj"}
        token = torch.as_tensor(token, device=params["embed"].device)
        shard = shard.bound(token.shape[0], 1)
        token = shard.take_batch(token)
    x = (_embed(top, cfg, token, shard) * math.sqrt(float(cfg.d_model))
         ).to(dtype)
    new_caches = []
    for gi, (gspec, gp, gc) in enumerate(zip(B.layer_groups(cfg),
                                             params["groups"], caches)):
        new_gc = list(gc)
        for r in range(gspec.repeats):
            for u, (kind, p_blk) in enumerate(zip(gspec.unit, gp)):
                sp = None if specs is None else specs["groups"][gi][u]
                if kind == "shared_attn":
                    p_blk = params["shared_block"]
                    sp = None if specs is None else specs["shared_block"]
                elif gspec.repeats > 1:
                    p_blk = _rep(p_blk, r)
                    if sp is not None:
                        sp = tree_map(lambda t: t.rep(), sp)
                if sp is not None:
                    p_blk = shard.gather(_cast_compute(p_blk, dtype), sp)
                if gspec.repeats == 1:
                    x, new_gc[u] = B.apply_block_decode(p_blk, cfg, kind, x,
                                                        gc[u], shard=shard)
                    continue
                x, c_new = B.apply_block_decode(p_blk, cfg, kind, x,
                                                _rep_cache(gc[u], r),
                                                shard=shard)
                _set_rep(gc[u], r, c_new)
        if gspec.repeats > 1:
            new_gc = [dataclasses.replace(c, length=c.length + 1)
                      for c in gc]
        new_caches.append(new_gc)
    x = nl.rms_norm(x, top["final_norm"].float(), cfg.norm_eps,
                    plus_one=cfg.post_norm)
    return unembed(top, cfg, x, shard), new_caches


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy with vocab-dim reductions only."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.take_along_dim(logits, targets[..., None].long(),
                                      dim=-1)[..., 0]
    return (lse - true_logit).mean()
