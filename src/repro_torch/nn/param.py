"""Logical axis names of the LM's parameters: the port of
``repro/nn/param.py``.

The reference builds its parameters as ``ParamLeaf(value, names)`` and
splits them into a value tree and a names tree; the port's
``init_transformer`` builds the value tree alone.  :func:`param_names`
returns the names tree for that value tree, leaf for leaf (one logical
name, or None, per dim: "embed", "heads", "kv_heads", "mlp", "vocab",
"experts", "inner", "ssm_heads", and "layers" for the leading repeats axis
of a stacked group), and :func:`param_shapes` the leaves' global shapes.
Both walk ``init_transformer(cfg, device="meta")``, which draws nothing,
so the initializers alone define the shapes; this module holds only the
names of each leaf key.  The sharding rules
(:mod:`repro_torch.sharding.specs`) map the names to mesh axes.
"""
from __future__ import annotations

import functools

from ..configs.base import ArchConfig

# a leaf's key (a dense layer's "w" by its parent's key) → its names
_NAMES = {
    "embed": ("vocab", "embed"),
    "head": ("embed", "vocab"),
    "mm_proj.w": ("embed", None),
    # attention; MLA
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo": ("heads", None, "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    "wkv_a": ("embed", None),
    "wk_b": (None, "heads", None),
    "wv_b": (None, "heads", None),
    # the gated MLP (the MoE's shared experts too); the MoE's experts
    "gate.w": ("embed", "mlp"),
    "up.w": ("embed", "mlp"),
    "down.w": ("mlp", "embed"),
    "router": ("embed", None),
    "gate": ("experts", "embed", "mlp"),
    "up": ("experts", "embed", "mlp"),
    "down": ("experts", "mlp", "embed"),
    # mamba2
    "in_proj": ("embed", "inner"),
    "conv_w": (None, "inner"),
    "conv_b": ("inner",),
    "a_log": ("ssm_heads",),
    "d_skip": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "out_proj": ("inner", "embed"),
}


def _names(path: tuple, ndim: int, stacked: bool) -> tuple:
    key = path[-1]
    if key == "w":
        key = f"{path[-2]}.w"
    names = ("embed",) if key.endswith("norm") else _NAMES[key]
    if stacked:
        names = ("layers",) + names
    if len(names) != ndim:
        raise ValueError(f"leaf {'/'.join(map(str, path))}: {ndim} dims, "
                         f"names {names}")
    return names


def _walk(fn, tree, path=(), stacked=False):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (k,), stacked)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, path + (i,), stacked)
                for i, v in enumerate(tree)]
    return fn(path, tree, stacked)


@functools.lru_cache(maxsize=None)
def _meta_params(cfg: ArchConfig) -> dict:
    from ..models import transformer as T
    return T.init_transformer(cfg, device="meta")


def param_names(cfg: ArchConfig) -> dict:
    """The logical-axis names tree of ``init_transformer(cfg)``'s value
    tree: the reference's ``split_params(...)[1]``."""
    from ..models import blocks as B
    params = dict(_meta_params(cfg))
    groups = params.pop("groups")
    out = _walk(lambda p, t, st: _names(p, t.dim(), st), params)
    out["groups"] = [
        _walk(lambda p, t, st: _names(p, t.dim(), st), unit, ("groups", i),
              stacked=g.repeats > 1)
        for i, (g, unit) in enumerate(zip(B.layer_groups(cfg), groups))]
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """The global shape of every leaf of ``init_transformer(cfg)``."""
    return _walk(lambda p, t, st: tuple(t.shape), _meta_params(cfg))
