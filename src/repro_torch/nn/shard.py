"""The model's sharding hooks on one card.

The LM's modules take a ``shard`` argument at the reference's call sites
(``repro/nn/attention.py``, ``ssm.py``, ``moe.py``,
``models/blocks.py``, ``models/transformer.py``).  :data:`no_shard` is the
single-card default: every hook is the identity, and a module given it
runs exactly its single-card ops.  A
:class:`repro_torch.sharding.specs.Sharder` overrides the hooks for a
per-rank program on a mesh.
"""
from __future__ import annotations

import torch.nn.functional as F


class NoShard:
    """The hooks, each the identity: ``active`` is False, the explicit
    mixing and expert-parallel MoE hooks are absent, the causal conv's
    halo is zeros."""

    active = False
    explicit_a2a = None
    ep_moe = None
    batch = seq = None

    def __call__(self, x, kind, src=None, shape=None):
        return x

    def bound(self, batch: int, seq: int) -> "NoShard":
        return self

    def halo(self, x, k: int):
        """``x`` (B, S, C) behind ``k`` zero positions."""
        return F.pad(x, (0, 0, k, 0))

    def local(self, t, kind: str, dim: int, shape: tuple):
        return t


no_shard = NoShard()
