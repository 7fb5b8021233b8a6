"""Mamba2 (SSD — state-space duality) mixing layer [arXiv:2405.21060]: the
port of ``repro/nn/ssm.py``.

The chunked SSD cuts the sequence into chunks: within a chunk the dual
(quadratic) form, and a small recurrence carries the (H, P, N) state
between chunks.  ``ssm_impl="jnp"`` runs :func:`ssd_chunked` in plain
torch ops; ``"fused"`` runs the intra-chunk part through the CUDA kernel
(:func:`repro_torch.kernels.ssd.ssd_chunked_fused`).  As in the reference,
:func:`mamba2_prefill` always runs :func:`ssd_chunked`.

Under a sharder (:func:`mamba2_forward`'s ``shard``) the block's input is
this rank's block of the token layout.  The causal conv runs there, on
the sequence shard behind the previous shard's last ``conv_kernel − 1``
positions (``Sharder.halo``: a ppermute; without it the shard boundaries
would be silently wrong); then the per-head inputs move to
``act_ssm_heads`` (an all-to-all) and the SSD runs on the local heads over
the whole sequence, with B and C, which every head shares, gathered over
the sequence; the output moves back.  :func:`mamba2_prefill` runs the
same mixing phase and leaves its two caches in their ``cache_shardings``
layouts: the final state (B, H, P, N) already head-sharded, the conv
state (B, K − 1, conv_dim) from the prompt's last K − 1 raw positions
(the last sequence shard's) sharded over the conv channels.  A decode
step convolves the rank's own channels, gathers the conv output over the
model axis (ledger op ``conv_gather``: the heads' x, and B and C whole),
updates the state of the rank's heads and gathers the heads' output.

Under the megatron strategy the block's input is the rank's batch block
with the whole sequence, replicated over the model axis, and the
parameters stay in their ``param_spec`` shards.  ``in_proj``'s model
shard is a contiguous block of the fused [z, x, B, C, dt] columns and
``conv_w`` / ``conv_b``'s one of the [x, B, C] channels, neither of them
a rank's heads; so the rank's block of the projection is gathered whole
over the model axis (ledger op ``tp_gather``, an exchange of
activations: the weights never move), the rank convolves its own
channels and the conv output is gathered (``conv_gather``); the rank
then keeps its heads' z, x and dt, and B and C whole.  The SSD runs on
the rank's heads, the gated RMSNorm's per-token mean square over
d_inner is summed over the model axis in fp32 (``tp_psum``) and
``out_proj`` is row-parallel (``tp_psum``).  Prefill leaves the final
state head-sharded and the conv state channel-sharded, as
``cache_shardings`` says; a decode step runs the same schedule on the
rank's cache shards.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd.ops import inter_chunk, pad_to_chunk, ssd_chunked_fused
from . import layers as nl
from .shard import NoShard, no_shard


def init_mamba2(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> dict:
    """The mixer's leaves; the decay rates, skip and norm stay fp32 whatever
    ``dtype`` is, as in the reference."""
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        # fused input projection → [z, x, B, C, dt]
        "in_proj": nl.param(gen, (d, 2 * di + 2 * n + nh), dtype=dtype),
        "conv_w": nl.param(gen, (cfg.conv_kernel, conv_dim),
                           scale=1.0 / cfg.conv_kernel, dtype=dtype),
        "conv_b": nl.param(gen, (conv_dim,), init="zeros", dtype=dtype),
        "a_log": nl.param(gen, (nh,), init="zeros"),
        "d_skip": nl.param(gen, (nh,), init="ones"),
        "dt_bias": nl.param(gen, (nh,), init="zeros"),
        "norm": nl.init_rms_norm(gen, di),
        "out_proj": nl.param(gen, (di, d), dtype=dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state_dim
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 shard: NoShard = no_shard) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C); kernel (K, C).  The K − 1
    positions before the sequence are zeros, or under a sharder the
    previous sequence shard's (``shard.halo``)."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = shard.halo(xbc, k - 1)
    out = sum(pad[:, i: i + s] * w[i] for i in range(k))
    return F.silu(out + b)


def _tp_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             shard: NoShard) -> torch.Tensor:
    """:func:`_causal_conv` of the whole channels ``xbc`` where megatron
    splits them: the rank's channel block convolved with its ``w`` and
    ``b``, the output gathered whole (``conv_gather``)."""
    c = xbc.shape[-1]
    if not shard.tp(c):
        return _causal_conv(xbc, w, b, shard)
    return shard.col_gather(_causal_conv(shard.tp_block(xbc, -1, c), w, b,
                                         shard), c, op="conv_gather")


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < k <= i} x[k]  (−inf above diagonal)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int):
    """SSD forward (scoring / prefill) in plain torch ops.

    x     : (B, S, H, P)   per-head inputs
    dt    : (B, S, H)      softplus'd step sizes
    a     : (H,)           negative decay rates
    b_mat : (B, S, N)      input  projection (single group)
    c_mat : (B, S, N)      output projection
    Returns (B, S, H, P) and the final state (B, H, P, N).
    """
    bsz, s_orig, h, p = x.shape
    n = b_mat.shape[-1]
    x, dt, b_mat, c_mat = pad_to_chunk(chunk, x, dt, b_mat, c_mat)
    s = x.shape[1]
    nc = s // chunk
    # head-major (B,nc,H,Q,·) layouts: every contraction a batched matmul
    xc_h = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtc_h = dt.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    da_h = dtc_h * a[:, None]                              # (B,nc,H,Q)
    l_mat = torch.exp(_segsum(da_h))                       # (B,nc,H,Q,Q)

    # intra-chunk (dual/quadratic) term: M = (C·Bᵀ) ⊙ L ⊙ dt, y = M·X
    scores = cc @ bc.transpose(-1, -2)                     # (B,nc,Q,Q)
    m_mat = scores[:, :, None] * l_mat * dtc_h[..., None, :]
    y_intra_h = m_mat @ xc_h                               # (B,nc,H,Q,P)

    # per-chunk final states: state[p,n] = Σ_k w[k]·x[k,p]·b[k,n]
    decay_to_end = torch.exp(
        torch.cumsum(da_h.flip(-1), dim=-1).flip(-1) - da_h)  # (B,nc,H,Q)
    wb = bc[:, :, None] * (decay_to_end * dtc_h)[..., None]
    states = xc_h.transpose(-1, -2) @ wb                   # (B,nc,H,P,N)

    y_inter_h, final = inter_chunk(states, da_h, cc)
    y = (y_intra_h + y_inter_h).permute(0, 1, 3, 2, 4)     # → seq-major
    return y.reshape(bsz, s, h, p)[:, :s_orig], final


def _proj_width(cfg: ArchConfig) -> int:
    """Width of the fused [z, x, B, C, dt] projection."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_state_dim + cfg.ssm_heads


def _mixer_inputs(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  shard: NoShard = no_shard):
    """in_proj → conv → (z, xbc_raw, xh, B, C, softplus'd dt, a); under
    megatron z, xh, dt and a of the rank's heads (module docstring)."""
    zxbcdt = shard.col_gather(x @ p["in_proj"].to(x.dtype),
                              _proj_width(cfg))
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _tp_conv(xbc_raw, p["conv_w"].to(x.dtype),
                   p["conv_b"].to(x.dtype), shard)
    di, n = cfg.d_inner, cfg.ssm_state_dim
    xh = xbc[..., :di].reshape(*xbc.shape[:2], cfg.ssm_heads,
                               cfg.ssm_head_dim)
    b_mat = xbc[..., di: di + n]
    c_mat = xbc[..., di + n:]
    nh = cfg.ssm_heads      # megatron: z, xh and dt of the rank's heads
    z, xh, dt = (shard.tp_block(z, -1, nh), shard.tp_block(xh, 2, nh),
                 shard.tp_block(dt, -1, nh))
    dt_sp = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    return z, xbc_raw, xh, b_mat, c_mat, dt_sp, a


def _mixer_output(p: dict, cfg: ArchConfig, x, z, xh, y,
                  shard: NoShard = no_shard, heads=None):
    d_skip = p["d_skip"] if shard.megatron else shard.local(
        p["d_skip"], "act_ssm_heads", 2, heads)
    y = (y + xh.float() * d_skip[:, None]).to(x.dtype)     # D skip
    if not shard.megatron:
        y = shard(y, "act_tokens", src="act_ssm_heads", shape=heads)
    return _gated_out(p, cfg, y.reshape(*x.shape[:2], -1), z, shard)


def _gated_out(p: dict, cfg: ArchConfig, y, z, shard: NoShard):
    """The gated RMSNorm over d_inner and ``out_proj`` of y (B, S, ·).
    Under megatron y and z hold the rank's heads' channels where the heads
    are split: the mean square summed over the model axis (fp32), the
    norm's scale cut to the rank's channels; ``out_proj`` row-parallel
    (a whole y cut to its rows where only d_inner splits)."""
    di = cfg.d_inner
    w = p["norm"].float()
    reduce = None
    if shard.tp(cfg.ssm_heads):
        w, frac = shard.tp_block(w, 0, di), y.shape[-1] / di

        def reduce(v):
            return shard.tp_sum(v * frac)
    y = nl.rms_norm(y * F.silu(z), w, cfg.norm_eps, reduce=reduce)
    if not shard.tp(cfg.ssm_heads):
        y = shard.tp_block(y, -1, di)
    return shard.row_sum(y @ p["out_proj"].to(y.dtype), di)


def _ssd(cfg: ArchConfig, xh, dt_sp, a, b_mat, c_mat):
    fn = ssd_chunked_fused if cfg.ssm_impl == "fused" else ssd_chunked
    return fn(xh.float(), dt_sp, a, b_mat.float(), c_mat.float(),
              cfg.ssm_chunk)[0]


def mamba2_forward(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                   shard: NoShard = no_shard):
    """Full-sequence mamba2 block (scoring, training).  x: (B, S, D); under
    a sharder this rank's block of the token layout (module docstring)."""
    z, _, xh, b_mat, c_mat, dt_sp, a = _mixer_inputs(p, cfg, x, shard)
    heads = (shard.batch, shard.seq, cfg.ssm_heads, cfg.ssm_head_dim)
    if not shard.megatron:
        xh, dt_sp, a, b_mat, c_mat = _to_heads(shard, heads, xh, dt_sp, a,
                                               b_mat, c_mat)
    y = _ssd(cfg, xh, dt_sp, a, b_mat, c_mat)
    return _mixer_output(p, cfg, x, z, xh, y, shard, heads)


def _to_heads(shard: NoShard, heads: tuple, xh, dt_sp, a, b_mat, c_mat):
    """The mixing phase's inputs moved from the token layout to the
    heads layout: xh and dt to ``act_ssm_heads``, a to the rank's heads,
    B and C gathered over the sequence."""
    return (shard(xh, "act_ssm_heads"),
            shard(dt_sp[..., None], "act_ssm_heads")[..., 0],
            shard.local(a, "act_ssm_heads", 2, heads),
            shard(b_mat, "act_seq"), shard(c_mat, "act_seq"))


@dataclasses.dataclass
class SSMCache:
    conv_state: torch.Tensor   # (B, K-1, conv_dim)
    ssm_state: torch.Tensor    # (B, H, P, N) fp32
    length: int


def mamba2_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                   shard: NoShard = no_shard):
    """Full-sequence mamba2 that also returns the decode cache; always the
    plain-torch :func:`ssd_chunked`, as the reference.  Under a sharder
    (module docstring) the rank's block of the token layout in and out,
    the cache the rank's shards."""
    z, xbc_raw, xh, b_mat, c_mat, dt_sp, a = _mixer_inputs(p, cfg, x, shard)
    b, s = shard.batch or x.shape[0], shard.seq or x.shape[1]
    heads = (b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    if not shard.megatron:
        xh, dt_sp, a, b_mat, c_mat = _to_heads(shard, heads, xh, dt_sp, a,
                                               b_mat, c_mat)
    y, final_state = ssd_chunked(xh.float(), dt_sp, a, b_mat.float(),
                                 c_mat.float(), cfg.ssm_chunk)
    out = _mixer_output(p, cfg, x, z, xh, y, shard, heads)
    state_shape = (b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim)
    if shard.active:   # the heads layout's (B, H) dims are the cache's
        hs = shard.spec("act_ssm_heads", heads)
        final_state = shard.move(final_state, (hs[0], hs[2], None, None),
                                 shard.cache_spec("ssm_state", state_shape))
    keep = min(s, cfg.conv_kernel - 1)
    conv_state = shard.to_cache(xbc_raw.to(x.dtype), "conv_state",
                                (b, keep, xbc_raw.shape[-1]), lambda t: t,
                                keep)
    return out, SSMCache(conv_state=conv_state, ssm_state=final_state,
                         length=s)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> SSMCache:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state_dim
    return SSMCache(
        conv_state=torch.zeros(batch, cfg.conv_kernel - 1, conv_dim,
                               dtype=dtype, device=device),
        ssm_state=torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state_dim, device=device),
        length=0)


def mamba2_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  cache: SSMCache, *, shard: NoShard = no_shard):
    """Single-token step.  x: (B, 1, D) → (B, 1, D), new cache.  Under a
    sharder the rank's batch block, replicated over the model axis, and
    the cache's shards (module docstring)."""
    zxbcdt = shard.col_gather(x @ p["in_proj"].to(x.dtype),
                              _proj_width(cfg))
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)              # (B,1,·)
    tp = shard.megatron   # the parameters are in the caches' layouts
    b, nh, hp = shard.batch or x.shape[0], cfg.ssm_heads, cfg.ssm_head_dim
    conv = shard.cache_layout("conv_state", (b, cfg.conv_kernel - 1,
                                             xbc_new.shape[-1]))
    ssm = shard.cache_layout("ssm_state", (b, nh, hp, cfg.ssm_state_dim))
    window = torch.cat([cache.conv_state, conv.take(
        xbc_new.to(cache.conv_state.dtype), {0: 0, 2: 2})], dim=1)
    w, cb = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if not tp:
        w, cb = conv.take(w, {1: 2}), conv.take(cb, {0: 2})
    conv_out = torch.einsum("bkc,kc->bc", window, w) + cb
    xbc = conv.give(F.silu(conv_out)[:, None], {0: 0, 2: 2},
                    op="conv_gather")
    di, n = cfg.d_inner, cfg.ssm_state_dim
    b_mat = xbc[..., di: di + n][:, 0].float()             # (B, N)
    c_mat = xbc[..., di + n:][:, 0].float()
    xh = ssm.take(xbc[..., :di].reshape(x.shape[0], nh, hp), {0: 0, 1: 1})
    xh = xh.float()
    dt_bias, a_log, d_skip = p["dt_bias"], p["a_log"], p["d_skip"]
    if not tp:
        dt_bias, a_log, d_skip = (ssm.take(t, {0: 1})
                                  for t in (dt_bias, a_log, d_skip))
    dt_sp = F.softplus(ssm.take(dt[:, 0], {0: 0, 1: 1}).float() + dt_bias)
    a = -torch.exp(a_log)
    decay = torch.exp(dt_sp * a)                           # (B, H)
    state = cache.ssm_state * decay[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt_sp, xh, b_mat)
    y = torch.einsum("bn,bhpn->bhp", c_mat, state)
    y = y + xh * d_skip[:, None]
    if tp:
        y = y.to(x.dtype).reshape(x.shape[0], 1, -1)
        z = shard.tp_block(z, -1, nh)
    else:
        y = ssm.give(y.to(x.dtype), {0: 0, 1: 1}).reshape(x.shape[0], 1,
                                                          di)
    out = _gated_out(p, cfg, y, z, shard)
    return out, SSMCache(conv_state=window[:, 1:], ssm_state=state,
                         length=cache.length + 1)
