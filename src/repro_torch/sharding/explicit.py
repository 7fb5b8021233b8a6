"""Explicit-collective sharder — the port of ``repro/sharding/explicit.py``:
the paper's gather/split as hand-scheduled collectives on the two hot
transitions.

* :meth:`ExplicitSharder.explicit_a2a` — the attention mixing phase.  q
  (and k/v when their heads divide the model axis) move seq-sharded →
  head-sharded by ONE all-to-all each (the paper's split) and back by one
  more (its gather).  GQA with kv heads that do not divide keeps k/v by an
  all-gather of the sequence and a static slice of the kv groups this
  rank's q heads use.  Heads that do not divide at all run ring attention
  (:mod:`repro_torch.nn.ring_attention`).
* :meth:`ExplicitSharder.ep_moe` — expert-parallel MoE dispatch: tokens
  routed locally (capacity from the local token count), packed per expert
  shard, ONE all-to-all to the experts' owners, the local experts, ONE
  all-to-all back.

Each returns None where it does not apply (another strategy, a model
axis of 1, a sequence or an expert count the axis does not divide), and
the caller falls back to the plain :class:`Sharder` path.  Every
collective is ``runtime/collectives.py``'s; each flag turns one
mechanism off.
"""
from __future__ import annotations

import dataclasses

from ..nn import moe as M
from ..runtime import collectives as C
from .specs import Sharder


@dataclasses.dataclass(frozen=True)
class ExplicitSharder(Sharder):
    use_a2a_mixing: bool = True
    use_ep_moe: bool = True
    use_ring: bool = True     # ring attention when heads % n != 0

    def _model(self):
        """(axis, group, n), or None where the explicit paths do not
        apply."""
        m = self.rules.model_axis
        if self.rules.strategy != "neutron_tp":
            return None
        return m, self.mesh.group_of(m), self.size(m)

    # ---- the mixing phase ----------------------------------------------

    @property
    def explicit_a2a(self):
        return self._a2a_mixing if self.use_a2a_mixing else None

    def _a2a_mixing(self, cfg, q, k, v, *, window=None, scale=None):
        """q: (B_l, S/n, Hq, hd) of the token layout → the attention
        output in the same layout, or None (the caller falls back)."""
        from ..nn.attention import attend
        from ..nn.ring_attention import ring_attention_local
        got = self._model()
        if got is None:
            return None
        m, group, n = got
        s = self.seq
        hq, hkv = q.shape[2], k.shape[2]
        if n == 1 or s % n:
            return None
        if hq % n:
            if not self.use_ring:
                return None
            return ring_attention_local(
                q, k, v, group, causal=True, window=window,
                softcap=cfg.attn_softcap, scale=scale, axis=m)
        hq_l, g = hq // n, hq // hkv
        kv_a2a = hkv % n == 0
        if not kv_a2a and g % hq_l and hq_l % g:
            return None
        # (B_l, S/n, Hq, hd) → (B_l, S, Hq/n, hd): the paper's split
        qg = C.all_to_all(q, group, split_axis=2, concat_axis=1, axis=m)
        if kv_a2a:
            kg = C.all_to_all(k, group, split_axis=2, concat_axis=1, axis=m)
            vg = C.all_to_all(v, group, split_axis=2, concat_axis=1, axis=m)
        else:
            # GQA: gather the sequence, slice the kv groups of this rank's
            # q heads
            kg = C.all_gather(k, group, axis=m, dim=1)
            vg = C.all_gather(v, group, axis=m, dim=1)
            start = (C.axis_index(group) * hq_l) // g
            nkv_l = max(1, -(-hq_l // g))
            kg = kg.narrow(2, start, nkv_l)
            vg = vg.narrow(2, start, nkv_l)
        out = attend(cfg, qg, kg, vg, window=window, scale=scale)
        # (B_l, S, Hq/n, hdv) → (B_l, S/n, Hq, hdv): the paper's gather
        return C.all_to_all(out, group, split_axis=1, concat_axis=2, axis=m)

    # ---- expert-parallel MoE -------------------------------------------

    @property
    def ep_moe(self):
        return self._ep_moe if self.use_ep_moe else None

    def _ep_moe(self, p: dict, cfg, x, top_e, top_p, capacity_factor):
        """x: (B_l, S_l, D) of the token layout; top_e/top_p (B_l, S_l, k)
        its local routing; ``p``'s experts this rank's E/n.  Returns the
        combined expert output (B_l, S_l, D), or None."""
        got = self._model()
        if got is None:
            return None
        m, group, n = got
        b_l, s_l, dm = x.shape
        e, kk = cfg.num_experts, cfg.num_experts_per_tok
        if n == 1 or e % n or self.seq % n:
            return None
        e_l = e // n
        t_l = b_l * s_l
        cap = int(max(1, -(-t_l * kk // e) * capacity_factor))
        se, st, sp, pos_c, keep = M._dispatch(
            cfg, top_e.reshape(t_l, kk), top_p.reshape(t_l, kk), cap)
        buf = M._buffer(cfg, x.reshape(t_l, dm), se, st, pos_c, keep, cap)
        # the paper's split: ONE all-to-all to the experts' owners
        recv = C.all_to_all(buf.reshape(n, e_l, cap, dm), group,
                            split_axis=0, concat_axis=0, axis=m)
        y = M._experts(p, cfg, recv.transpose(0, 1).reshape(e_l, n * cap,
                                                            dm))
        # the paper's gather: ONE all-to-all back to the senders
        yb = y.reshape(e_l, n, cap, dm).transpose(0, 1)
        back = C.all_to_all(yb, group, split_axis=0, concat_axis=0, axis=m)
        y_buf = back.reshape(e, cap, dm)
        gathered = y_buf[se, pos_c] * (sp * keep)[:, None].to(x.dtype)
        yf = x.new_zeros((t_l, dm)).index_add(0, st, gathered)
        return yf.reshape(b_l, s_l, dm)
