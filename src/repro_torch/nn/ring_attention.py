"""Ring attention: sequence-parallel exact attention by point-to-point
rotation — the port of ``repro/nn/ring_attention.py``.

Where the heads do not divide the model axis (InternVL2's 14 heads on 4
ranks, Qwen's 20 on 16) the head-sharded mixing phase is undefined.  Ring
attention keeps the sequence sharded: each rank holds its S/n query chunk
and the K/V chunks go round the ring (n steps, two ppermutes each), with
an online softmax over the steps — the paper's inter-chunk pipeline
applied to attention.  The per-rank score working set is (S/n)² a step.

Each step's score and softmax update runs under ``torch.utils.checkpoint``
(the backward recomputes the (S/n, S/n) chunk instead of keeping n of
them), as the reference's ``jax.checkpoint`` of its step.  The rotation
stays outside the checkpoint: the chunk a step receives is the next step's
input, which is kept anyway, so the backward reruns no ppermute of its
own (a unit-level checkpoint around the whole layer still reruns them,
counted as recomputed calls in the ledger).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..runtime import collectives as C


def _ring_step(qg, k_c, v_c, m_run, l_run, acc, mask, softcap):
    """One online-softmax update of the running (max, sum, acc) with the
    K/V chunk ``k_c``, ``v_c`` under ``mask`` (sc, sc)."""
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k_c.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    alpha = torch.exp(m_run - m_new)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    l_new = l_run * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqt,btkh->bkgqh", p, v_c.float())
    return m_new, l_new, acc_new


def ring_attention_local(ql, kl, vl, group=None, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         axis: str = "model") -> torch.Tensor:
    """ql: (B, S/n, Hq, hd) this rank's query chunk, the rank's index in
    ``group`` its place in the sequence; kl/vl: (B, S/n, Hkv, hd[_v]) its
    K/V chunks.  Masks are on global positions.  Returns
    (B, S/n, Hq, hd_v) in ql.dtype."""
    b, sc, hq, hd = ql.shape
    hkv, hdv = kl.shape[2], vl.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    idx, n = C.axis_index(group), C.axis_size(group)
    dev = ql.device
    q_pos = idx * sc + torch.arange(sc, device=dev)
    qg = ql.reshape(b, sc, hkv, g, hd).float() * scale
    perm = [(i, (i + 1) % n) for i in range(n)]
    m_run = torch.full((b, hkv, g, sc), -torch.inf, device=dev)
    l_run = torch.zeros((b, hkv, g, sc), device=dev)
    acc = torch.zeros((b, hkv, g, sc, hdv), device=dev)
    k_c, v_c = kl, vl
    for r in range(n):
        src = (idx - r) % n                       # the chunk's owner
        k_pos = src * sc + torch.arange(sc, device=dev)
        mask = torch.ones(sc, sc, dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        step = _ring_step
        if torch.is_grad_enabled():
            step = lambda *a: checkpoint(_ring_step, *a,  # noqa: E731
                                         use_reentrant=False)
        m_run, l_run, acc = step(qg, k_c, v_c, m_run, l_run, acc, mask,
                                 softcap)
        if r < n - 1:
            # rank i sends its current chunk to i + 1 (receives i − 1's)
            k_c = C.ppermute(k_c, group, perm, axis=axis)
            v_c = C.ppermute(v_c, group, perm, axis=axis)
    out = acc / l_run.clamp_min(1e-30)[..., None]         # (B,hkv,g,sc,hdv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sc, hq, hdv).to(ql.dtype)
