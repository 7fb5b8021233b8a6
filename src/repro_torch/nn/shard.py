"""The model's sharding hooks on one card.

The LM's modules take a ``shard`` argument at the reference's call sites
(``repro/nn/attention.py``, ``ssm.py``, ``moe.py``,
``models/blocks.py``, ``models/transformer.py``).  :data:`no_shard` is the
single-card default: every hook is the identity, and a module given it
runs exactly its single-card ops.  The serving hooks build a cache leaf
(``to_cache``) and describe its layout (``cache_layout``): here a leaf
is whole (:class:`WholeCache`).  The tensor-parallel hooks of the
megatron strategy (``tp``, ``row_sum``, ``col_gather``, ``tp_block``)
split nothing here.  A
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
    megatron = False
    explicit_a2a = None
    ep_moe = None
    batch = seq = cache_len = None

    def __call__(self, x, kind, src=None, shape=None):
        return x

    def bound(self, batch: int, seq: int) -> "NoShard":
        return self

    def halo(self, x, k: int):
        """``x`` (B, S, C) behind ``k`` zero positions."""
        return F.pad(x, (0, 0, k, 0))

    def local(self, t, kind: str, dim: int, shape: tuple):
        return t

    def serving(self, max_len: int) -> "NoShard":
        return self

    def tp(self, size: int) -> bool:
        return False

    def row_sum(self, y, size: int):
        return y

    def col_gather(self, y, size: int, op: str = "tp_gather"):
        return y

    def tp_block(self, t, dim: int, size: int):
        return t

    def to_cache(self, x, name: str, shape: tuple, build, keep=None,
                 local: tuple = ()):
        """The cache leaf: ``build`` of ``x``'s last ``keep`` positions
        (all by default)."""
        keep = x.shape[1] if keep is None else keep
        return build(x[:, x.shape[1] - keep:])

    def cache_layout(self, name: str, shape: tuple) -> "WholeCache":
        return _WHOLE


class WholeCache:
    """A cache leaf held whole (the hooks of
    :class:`repro_torch.sharding.specs.CacheLayout`, each the identity)."""

    split = None

    def take(self, t, dims: dict, local: tuple = (),
             op: str = "all_gather"):
        return t

    def give(self, t, dims: dict, op: str = "all_gather",
             local: tuple = ()):
        return t

    def offset(self, local_len: int) -> int:
        return 0

    def local_slot(self, slot: int, local_len: int):
        return slot


_WHOLE = WholeCache()
no_shard = NoShard()
