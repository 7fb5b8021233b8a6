"""Parameter trees: the weight bridge to and from numpy, and tree helpers.

A parameter tree is nested dicts, lists and tuples with tensors at the
leaves — the same structure as the JAX package's param pytrees (the GCN's
``{"layers": [{"w", "b"}, ...]}``, and the LM's value tree with its
per-group lists and ``{}`` placeholders for weight-tied blocks, which map
to themselves), so weights made there (as numpy arrays) load here
unchanged and go back the same way.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure; dict keys
    are visited in sorted order, as JAX orders a pytree's leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in visiting order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def from_numpy_tree(tree, device="cuda"):
    """numpy (or array-like) leaves → tensors on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def to_numpy_tree(tree):
    """Tensor leaves → numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
