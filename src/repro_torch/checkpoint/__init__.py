"""Checkpointing: one ``.npz`` of leaves and a JSON manifest, in the JAX
package's format.

A tree of parameters or optimizer state (nested dicts, lists, tuples,
``None`` and :class:`repro_torch.optim.OptState`, with tensors, numpy
arrays or Python scalars at the leaves) is saved as ``<path>.npz``, whose
``leaf_<i>`` arrays are the leaves in the order JAX flattens the same
tree, and ``<path>.manifest.json``, which holds the leaf count, the tree's
structure as JAX prints its treedef (``str(treedef)``, e.g.
``PyTreeDef({'layers': [{'b': *, 'w': *}]})``) and the caller's
metadata.  A parameter checkpoint saved by either package therefore
restores in the other.

What :func:`restore` validates, in order:

1. **leaf count** — the manifest's ``n_leaves`` against the template's;
2. **tree structure** — the stored treedef string against the
   template's: a tree of the same arity and another structure (a renamed
   key, a list that became a tuple) is refused instead of restoring
   leaves into the wrong slots;
3. **each leaf's shape and dtype** against the template leaf, errors
   naming the leaf's path as ``jax.tree_util.keystr`` prints it (e.g.
   ``['layers'][0]['w']``).

Restored leaves go to the template leaf's device; a template leaf that
is a numpy array comes back as one, and one that is a Python scalar as a
Python scalar.  Values are not checksummed.

Single process only: :func:`save` refuses a ``DTensor`` leaf that is not
replicated on every mesh dim, since this rank holds only its shard.

Departure from the reference: optimizer state restores only in the
package that saved it.  The port's ``OptState.count`` is a Python ``int``
(saved as NumPy makes it, a 0-d int64 array), the reference's an int32
array, so the reference refuses the port's count by its dtype check.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..optim import OptState


def _map(node, fn, path: str = "") -> tuple[Any, str]:
    """(``node`` with each leaf replaced by ``fn(path, leaf)``, its treedef
    as JAX spells it), leaves visited in JAX's order: dict keys sorted,
    ``None`` a node with no leaf, an ``OptState`` JAX's registered
    dataclass of (count, mu, nu)."""
    if node is None:
        return None, "None"
    if isinstance(node, dict):
        kids = {k: _map(node[k], fn, f"{path}[{k!r}]") for k in sorted(node)}
        return ({k: t for k, (t, _) in kids.items()},
                "{" + ", ".join(f"{k!r}: {d}" for k, (_, d) in kids.items())
                + "}")
    if type(node) in (list, tuple):
        kids = [_map(c, fn, f"{path}[{i}]") for i, c in enumerate(node)]
        inner = ", ".join(d for _, d in kids)
        if isinstance(node, list):
            return [t for t, _ in kids], f"[{inner}]"
        return (tuple(t for t, _ in kids),
                f"({inner}{',' if len(kids) == 1 else ''})")
    if isinstance(node, OptState):
        kids = [_map(getattr(node, f), fn, f"{path}.{f}")
                for f in ("count", "mu", "nu")]
        return (OptState(*(t for t, _ in kids)),
                f"CustomNode(OptState[()], [{', '.join(d for _, d in kids)}])")
    return fn(path or "<root>", node), "*"


def _flatten(tree: Any) -> tuple[list[str], list, str]:
    """(leaf paths, leaves, ``str(treedef)``) of ``tree``, as JAX gives
    them for the same tree."""
    paths: list[str] = []
    leaves: list = []

    def visit(path, leaf):
        paths.append(path)
        leaves.append(leaf)

    _, treedef = _map(tree, visit)
    return paths, leaves, f"PyTreeDef({treedef})"


def _host_array(path: str, leaf) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        if not all(p.is_replicate() for p in leaf.placements):
            raise ValueError(
                f"checkpoint.save: leaf {path} is a DTensor laid out "
                f"{leaf.placements}, not replicated, so this rank holds "
                f"only its shard.  This module is single-process: save "
                f"replicated state, or gather the leaf first "
                f"(DTensor.full_tensor()).")
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    paths, leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": _host_array(p, leaf)
              for i, (p, leaf) in enumerate(zip(paths, leaves))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz_path(path), **arrays)
    manifest = {"n_leaves": len(leaves), "treedef": treedef,
                "metadata": metadata or {}}
    with open(_manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=2)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return np.dtype(str(leaf.dtype).removeprefix("torch."))
    return np.dtype(leaf.dtype)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the kind of leaf ``leaf`` is, on its device."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(leaf.device)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return arr
    return arr.item()


def restore(path: str, template: Any) -> Any:
    """Restore into the structure of ``template`` (leaf count, treedef,
    per-leaf shapes and dtypes validated — module docstring)."""
    t_paths, t_leaves, treedef = _flatten(template)
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(t_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has "
            f"{len(t_leaves)}")
    if manifest["treedef"] != treedef:
        raise ValueError(
            f"checkpoint tree structure differs from template — same leaf "
            f"count but different treedef, so leaves would restore into "
            f"the wrong slots.\n  stored:   {manifest['treedef']}\n"
            f"  template: {treedef}")
    leaves = []
    with np.load(_npz_path(path)) as npz:
        for i, (p, tl) in enumerate(zip(t_paths, t_leaves)):
            arr = npz[f"leaf_{i}"]
            if hasattr(tl, "shape") and tuple(arr.shape) != tuple(tl.shape):
                raise ValueError(
                    f"leaf {p} (index {i}): checkpoint shape {arr.shape} != "
                    f"template {tuple(tl.shape)}")
            if hasattr(tl, "dtype") and arr.dtype != _np_dtype(tl):
                raise ValueError(
                    f"leaf {p} (index {i}): checkpoint dtype {arr.dtype} != "
                    f"template {_np_dtype(tl)} — a silent cast here would "
                    f"corrupt training state (e.g. int step counters "
                    f"restored as floats)")
            leaves.append(_like(arr, tl))
    it = iter(leaves)
    return _map(template, lambda _, __: next(it))[0]


def load_metadata(path: str) -> dict:
    with open(_manifest_path(path)) as f:
        return json.load(f)["metadata"]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"
