"""Distribution strategies for the LM — the port of
``repro/sharding/specs.py`` — and the per-rank sharder that runs them.

The paper's scheme maps onto sequence models as: tokens = vertices,
attention or SSM mixing = graph aggregation, MLP or MoE = the vertex-wise
NN ops.

``neutron_tp``  the NN phase runs token-sharded on the model axis
                (``act_tokens``: (data, model, None)); the mixing phase
                head-sharded with the whole sequence on each rank
                (``act_heads``: (data, None, model, None)).  The
                transitions between the two are the paper's split and
                gather all-to-alls.
``dp``          the model axis unused: pure data parallelism.
``megatron``    activations sequence-replicated, heads and FFN columns
                sharded.  Its specs are here; running it is not ported
                (:data:`MEGATRON_ITEM`).

Parameters are laid out the same way in every strategy: logical axis →
mesh axis with a divisibility guard, FSDP of the d_model dim over the data
axes, heads, FFN, experts and vocab over the model axis.  Specs are the
plain tuples of :mod:`repro_torch.runtime.constraint` (an entry per dim:
None, an axis name, or a tuple of names outermost first); a mesh is
anything with a ``shape`` mapping of axis name → size, in practice
:func:`repro_torch.runtime.mesh.hybrid_mesh`'s ``TPMesh``.

PyTorch has no partitioner, so :class:`Sharder` runs a per-rank program
on local shards, and every layout transition that a spec names is a
collective of ``runtime/collectives.py`` (the staging of
``constraint.move_local``):

* the NN phase holds the rank's block of the batch and of the sequence
  (``act_tokens`` fitted by :func:`_fit_spec`: a dim the axis does not
  divide stays whole);
* parameters are stored as their ``param_spec`` shards
  (:func:`place_params`) and gathered whole at use — an expert leaf keeps
  its model shard — through the choke point's all-gather (ledger op
  ``param_gather``), whose backward reduce-scatters each rank its
  gradient shard; the gradients of the axes a parameter is replicated
  over are summed after the backward (:meth:`Sharder.reduce_grads`);
* the mixing phase moves q, k and v to the fitted ``act_heads`` /
  ``act_kv_heads`` and back (an all-to-all where the heads divide, an
  all-gather of the sequence where the spec replicates, a slice where the
  heads are sharded and the sequence was whole);
* the loss and the MoE load-balance sums are summed over every rank
  before their quotients are taken.

A replicated activation carries, on each rank, that rank's share of its
cotangent: the loss sums count every rank's tokens, replicas included, so
the gradients summed over all ranks are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..nn import param as nparam
from ..nn.shard import NoShard
from ..params import tree_leaves, tree_map
from ..runtime import collectives as C
from ..runtime import constraint as K

# logical param axis → model-parallel mesh axis candidates
_MODEL_AXES = {"vocab", "heads", "kv_heads", "mlp", "experts", "inner",
               "ssm_heads"}
_FSDP_AXES = {"embed"}

SERVING_ITEM = ("sharded LM serving is not ported (ROADMAP queue 1 item "
                "29): prefill, decode, generate and the cache layouts run "
                "on one card")
MEGATRON_ITEM = ("the megatron strategy is not ported (ROADMAP queue 1 "
                 "item 30): the port runs neutron_tp and dp")
_CACHE_KINDS = ("cache_seq", "cache_seq_latent")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    strategy: str = "neutron_tp"       # neutron_tp | megatron | dp
    data_axes: tuple[str, ...] = ("data",)   # ("pod", "data") multi-pod
    model_axis: str = "model"

    # ---- parameters ----------------------------------------------------

    def param_axis(self, logical: Optional[str], dim: int, mesh):
        if logical in _MODEL_AXES and self.strategy != "dp":
            if dim % mesh.shape[self.model_axis] == 0:
                return self.model_axis
            return None
        if logical in _FSDP_AXES:
            n = math.prod(mesh.shape[a] for a in self.data_axes)
            if dim % n == 0:
                return self.data_axes if len(self.data_axes) > 1 \
                    else self.data_axes[0]
            # the innermost data axis alone
            if dim % mesh.shape[self.data_axes[-1]] == 0:
                return self.data_axes[-1]
        return None

    def param_spec(self, names: tuple, shape: tuple, mesh) -> tuple:
        used: set = set()
        axes = []
        for logical, dim in zip(names, shape):
            ax = self.param_axis(logical, dim, mesh)
            key = tuple(ax) if isinstance(ax, tuple) else ax
            if ax is not None and key not in used:
                axes.append(ax)
                used.add(key)
            else:
                axes.append(None)
        return tuple(axes)

    def param_shardings(self, names_tree, shapes_tree, mesh):
        """The spec of every leaf, as a tree like ``names_tree``."""
        return _map2(lambda n, s: self.param_spec(n, s, mesh), names_tree,
                     shapes_tree)

    # ---- activations ---------------------------------------------------

    def _d(self):
        return self.data_axes if len(self.data_axes) > 1 \
            else self.data_axes[0]

    def act_spec(self, kind: str, ndim: int) -> Optional[tuple]:
        if kind in _CACHE_KINDS:
            raise NotImplementedError(f"act_spec({kind!r}): {SERVING_ITEM}")
        d, m = self._d(), self.model_axis
        if self.strategy == "dp":
            m = None
        table = {
            # (B, S, D): NN phase; neutron_tp shards the sequence
            "act_tokens": (d, m if self.strategy == "neutron_tp" else None,
                           None),
            # (B, S, H, hd): mixing phase — whole sequence, heads sharded
            "act_heads": (d, None, m, None),
            "act_kv_heads": (d, None, m, None),
            "act_ssm_heads": (d, None, m, None),
            # (B, S, V): vocab-sharded logits
            "act_vocab": (d, None, m),
            # (E, C, D): expert-major MoE buffer
            "expert_buf": (m, None, None),
        }
        return table.get(kind)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _fit_spec(spec, shape: tuple, mesh) -> tuple:
    """Drop axes that do not divide their dim (kv_heads=8 on a 16-way
    model axis → replicated)."""
    fitted = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fitted.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(mesh.shape[a] for a in axes)
        fitted.append(ax if shape[i] % n == 0 else None)
    return tuple(fitted)


def cache_shardings(rules: ShardingRules, mesh, cache_shapes):
    raise NotImplementedError(f"cache_shardings: {SERVING_ITEM}")


def _axes_of(spec) -> list[str]:
    """Every mesh axis a spec names, in order."""
    out = []
    for e in spec:
        if e is not None:
            out.extend(e if isinstance(e, tuple) else (e,))
    return out


def _use_spec(names: tuple, spec: tuple, model_axis: str) -> tuple:
    """A parameter's layout at use: whole, but an expert dim keeps its
    model shard (each rank runs its own experts)."""
    return tuple(e if n == "experts" and e == model_axis else None
                 for n, e in zip(names, spec))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One leaf's stored layout (``spec``) and its layout at use
    (``use``)."""
    spec: tuple
    use: tuple

    def rep(self) -> "ParamSpec":
        """The layout of one repeat of a stacked leaf."""
        return ParamSpec(self.spec[1:], self.use[1:])


# port-only activation layouts: the rank's batch block with the whole
# sequence (the batch as it arrives, and the SSM's B and C), and every
# token (the plain MoE dispatch)
_PORT_KINDS = {"act_seq": lambda d: (d, None, None, None),
               "act_global": lambda d: (None, None, None, None)}


@dataclasses.dataclass(frozen=True)
class Sharder(NoShard):
    """The per-rank hooks of a (data, model) mesh under ``rules``.

    ``shard(x, kind, src="act_tokens", shape=None)`` moves this rank's
    ``x``, laid out as ``src``, to ``kind``'s layout, both fitted to the
    global shape ``shape`` (by default the bound batch and sequence and
    ``x``'s trailing dims).  ``bound(batch, seq)`` is the sharder of one
    forward, whose global (B, S) it knows."""

    mesh: object
    rules: ShardingRules
    batch: Optional[int] = None
    seq: Optional[int] = None

    active = True

    def __post_init__(self):
        if self.rules.strategy == "megatron":
            raise NotImplementedError(MEGATRON_ITEM)
        if self.rules.strategy not in ("neutron_tp", "dp"):
            raise ValueError(f"strategy {self.rules.strategy!r}")
        axes = (self.rules.model_axis,) + tuple(self.rules.data_axes)
        if set(axes) != set(self.mesh.shape):
            raise ValueError(
                f"rules name axes {axes} but the mesh has "
                f"{tuple(self.mesh.shape)}: build it with hybrid_mesh")

    def bound(self, batch: int, seq: int) -> "Sharder":
        return dataclasses.replace(self, batch=batch, seq=seq)

    # ---- layouts -------------------------------------------------------

    def spec(self, kind, shape: tuple) -> tuple:
        """``kind``'s spec (a kind or a spec) fitted to ``shape``."""
        if isinstance(kind, tuple):
            spec = kind
        elif kind in _PORT_KINDS:
            spec = _PORT_KINDS[kind](self.rules._d())
        else:
            spec = self.rules.act_spec(kind, len(shape))
            if spec is None:
                raise ValueError(f"the port has no layout {kind!r}")
            spec = spec + (None,) * (len(shape) - len(spec))
        return _fit_spec(spec[:len(shape)], shape, self.mesh)

    def move(self, x, src_spec, dst_spec, *, gather_op="all_gather"):
        return K.move_local(x, src_spec, dst_spec, self.mesh,
                            gather_op=gather_op)

    def __call__(self, x, kind, src="act_tokens", shape=None):
        if shape is None:
            shape = (self.batch, self.seq) + tuple(x.shape[2:])
        return self.move(x, self.spec(src, shape), self.spec(kind, shape))

    def index(self, axis: str) -> int:
        return C.axis_index(self.mesh.group_of(axis))

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def take_batch(self, t):
        """This rank's block of the global batch tensor ``t`` (dim 0),
        by ``batch_shardings``' layout."""
        if t is None:
            return None
        shape = tuple(t.shape)
        return self.move(t, (None,) * len(shape),
                         self.spec("act_seq", shape))

    def seq_sharded(self) -> bool:
        return self.spec("act_tokens", (self.batch, self.seq, 1))[1] \
            is not None

    def positions(self, b: int, s: int, device) -> torch.Tensor:
        """The global positions of this rank's (b, s) tokens."""
        off = self.index(self.rules.model_axis) * s \
            if self.seq_sharded() else 0
        return (off + torch.arange(s, device=device))[None].expand(b, s)

    def halo(self, x, k: int):
        """``x`` (B, S_l, C) of the token layout behind the ``k`` positions
        before it — the previous sequence shard's last ``k`` (a ppermute
        over the model axis), zeros on the first shard — (B, k + S_l, C).
        A shard shorter than ``k`` gathers the sequence instead."""
        m = self.rules.model_axis
        n = self.size(m)
        if not self.seq_sharded() or n == 1:
            return super().halo(x, k)
        if x.shape[1] < k:
            i, s_l = self.index(m), x.shape[1]
            full = super().halo(self(x, "act_seq"), k)
            return full[:, i * s_l: i * s_l + k + s_l]
        tail = C.ppermute(x[:, -k:], self.mesh.group_of(m),
                          [(i, (i + 1) % n) for i in range(n)], axis=m)
        if self.index(m) == 0:
            tail = tail * 0
        return torch.cat([tail, x], dim=1)

    def local(self, t, kind: str, dim: int, shape: tuple):
        """This rank's part of a whole 1-d tensor ``t`` along dim ``dim``
        of ``kind``'s layout of ``shape`` (a per-head parameter in the
        mixing phase)."""
        return self.move(t, (None,), (self.spec(kind, shape)[dim],))

    def unshard(self, x):
        """A token-layout tensor (B_l, S_l, ...) gathered whole."""
        return self(x, "act_global")

    # ---- reductions ----------------------------------------------------

    def _all_axes(self) -> tuple:
        return (self.rules.model_axis,) + tuple(self.rules.data_axes)

    def _all_group(self):
        return None if self.mesh.data_axes else self.mesh.group

    def psum_all(self, x):
        """``x`` summed over every rank of the mesh (one call)."""
        return C.psum(x, self._all_group(), axis=self._all_axes())

    # ---- parameters ----------------------------------------------------

    def param_specs(self, cfg) -> dict:
        """The :class:`ParamSpec` of every leaf of ``cfg``'s parameter
        tree."""
        key = ("_specs", cfg)
        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            names = nparam.param_names(cfg)
            specs = self.rules.param_shardings(
                names, nparam.param_shapes(cfg), self.mesh)
            cache[key] = _map2(
                lambda n, s: ParamSpec(s, _use_spec(
                    n, s, self.rules.model_axis)), names, specs)
        return cache[key]

    def gather(self, tree, specs):
        """Shards gathered to their layout at use (ledger op
        ``param_gather``)."""
        if isinstance(tree, dict):
            return {k: self.gather(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather(v, s) for v, s in zip(tree, specs))
        return self.move(tree, specs.spec, specs.use,
                         gather_op="param_gather")

    def reduce_grads(self, grads, specs):
        """Each leaf's gradient summed over the mesh axes its parameter is
        replicated on: one ``grad_psum`` per axis (and dtype) over the
        leaves that need it."""
        flat_g = tree_leaves(grads)
        flat_s = tree_leaves(_map2(lambda g, s: s, grads, specs))
        out = list(flat_g)
        for a in self._all_axes():
            idx = [i for i, s in enumerate(flat_s)
                   if a not in _axes_of(s.spec)]
            for dtype in dict.fromkeys(out[i].dtype for i in idx):
                sel = [i for i in idx if out[i].dtype == dtype]
                flat = torch.cat([out[i].reshape(-1) for i in sel])
                total = C.psum(flat, self.mesh.group_of(a), axis=a,
                               op="grad_psum")
                for i, part in zip(sel, total.split(
                        [out[i].numel() for i in sel])):
                    out[i] = part.view_as(out[i])
        it = iter(out)
        return tree_map(lambda _: next(it), grads)


def make_sharder(mesh, rules: ShardingRules) -> Sharder:
    return Sharder(mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# Placement: a whole parameter tree ↔ per-rank shards
# ---------------------------------------------------------------------------

def place_params(params, cfg, sharder: Sharder):
    """This rank's shard of every leaf of the whole tree ``params`` (the
    same on every rank: drawn from one seed, or the reference's numpy
    weights through ``params.from_numpy_tree``), by ``param_spec``;
    copies, so the whole tree can be freed."""
    specs = sharder.param_specs(cfg)
    return _map2(lambda p, s: sharder.move(
        p, (None,) * p.dim(), s.spec).clone(), params, specs)


def gather_params(shards, cfg, sharder: Sharder):
    """The whole tree from every rank's shards (no gradient)."""
    specs = sharder.param_specs(cfg)
    with torch.no_grad():
        return _map2(lambda p, s: sharder.move(
            p, s.spec, (None,) * p.dim()), shards, specs)
