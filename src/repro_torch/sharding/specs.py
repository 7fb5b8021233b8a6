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
                sharded: Megatron's column- and row-parallel NN phase
                (below).

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

Under ``megatron`` the reference is nothing but GSPMD constraints; the
port writes Megatron's schedule out.  The activations hold the rank's
batch block with the whole sequence, replicated over the model axis; a
leaf keeps the model shard of each model-parallel dim at use
(:func:`_use_spec`: heads, kv heads, FFN columns, experts, vocab, mamba2's
inner dims), so only the FSDP shards are gathered; a column-parallel
matmul (wq/wk/wv, gate/up, in_proj) gives the rank's heads or columns,
and a row-parallel one (wo, down, out_proj, the MoE combine) partial
outputs summed over the model axis (``Sharder.row_sum``:
``collectives.tp_psum``).  The share convention fixes the backward: the
sum is a replicated activation, so each rank holds a share of its
cotangent and every partial output needs the whole — the sum's backward
is a sum over the model axis too; the replicated input of a
column-parallel matmul then needs no reduction in its backward, since
each rank's cotangent is its columns' part and the parts sum to the
truth over the ranks; a model-sharded leaf's gradient is whole on its
rank and is not summed over the model axis (``reduce_grads``), a
replicated one is.  A dim the axis does not divide stays whole (the
parameter replicated, that matmul run whole with no sum).

Serving (``prefill``, ``decode_step``) stores every decode cache as
:func:`cache_shardings` lays it out: a leaf found by its field name, its
spec right-aligned (a cache stacked over a group's repeats keeps the
layout) and fitted.  ``seq_shard_cache`` picks one of the reference's
three layouts of a (B, S, H, hd) cache: False, heads over the model axis;
True, the sequence over the data axes (batch 1); ``"model"``, the
sequence over the model axis.  A prefill builds each cache from the
prompt's token layout (:meth:`Sharder.to_cache`: the positions it keeps
gathered, ledger op ``cache_place``, then the rank's block sliced); a
decode step writes the token on the rank that owns its slot and runs
attention over a split sequence as a split softmax (one gather of each
rank's partial max, sum and output, ledger op ``softmax_gather``), so no
decode step gathers a cache.  A per-rank shard does not show its global
length: the sharder carries the dense and latent caches' ``max_len``
(:meth:`Sharder.serving`; ``prefill`` binds it, ``make_serve_fns``
hands it to its decode closure).  Stated departure: under ``dp`` with
``seq_shard_cache="model"`` the reference's ``act_spec
("cache_seq_latent")`` lays the latent cache's sequence over the model
axis (the literal ``"model"`` of ``_cache_latent_spec``) while its
``cache_shardings`` replicates it there (no model axis under ``dp``);
both spec functions are copied verbatim, and the per-rank program stores
the latent cache as ``cache_shardings`` says.
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


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    strategy: str = "neutron_tp"       # neutron_tp | megatron | dp
    data_axes: tuple[str, ...] = ("data",)   # ("pod", "data") multi-pod
    model_axis: str = "model"
    # KV-cache sequence sharding: False → cache seq replicated (heads on
    # model); True → seq over data (batch 1); "model" → seq over the
    # model axis (the fix for GQA archs whose head counts do not divide
    # the model axis)
    seq_shard_cache: bool | str = False

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
            # (B, S, H, hd) decode cache
            "cache_seq": _cache_kv_spec(self.seq_shard_cache, d, m),
            # (B, S, r) MLA latent cache
            "cache_seq_latent": _cache_latent_spec(self.seq_shard_cache, d),
        }
        return table.get(kind)


def _cache_kv_spec(seq_mode, d, m) -> tuple:
    """(B, S, H, hd) cache layout for the three seq-sharding modes."""
    if seq_mode == "model":
        return (d, m, None, None)
    if seq_mode:
        return (None, d, m, None)
    return (d, None, m, None)


def _cache_latent_spec(seq_mode, d, m="model") -> tuple:
    """(B, S, r) MLA latent cache layout."""
    if seq_mode == "model":
        return (d, m, None)
    if seq_mode:
        return (None, d, None)
    return (d, None, None)


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


def _cache_leaf_specs(rules: ShardingRules) -> dict:
    """Field name → the trailing-dim spec of that decode-cache leaf."""
    d = rules._d()
    m = rules.model_axis if rules.strategy != "dp" else None
    kv = _cache_kv_spec(rules.seq_shard_cache, d, m)
    lat = _cache_latent_spec(rules.seq_shard_cache, d, m)
    return {
        # (B, S, H, hd)
        "k": kv,
        "v": kv,
        # (B, S, r)
        "c_kv": lat,
        "k_rope": lat,
        # (B, K-1, conv_dim)
        "conv_state": (d, None, m),
        # (B, H, P, N)
        "ssm_state": (d, m, None, None),
        "length": (),
    }


def _leaf_spec(by_name: dict, name: str, shape: tuple, mesh) -> tuple:
    spec = by_name.get(name)
    if spec is None:
        return ()
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    return _fit_spec(full, shape, mesh)


def _map_caches(fn, caches, *others):
    """``fn(name, leaf, *other leaves)`` on every field of every cache
    dataclass in the tree ``caches`` (lists of lists), but a ring cache's
    ``window``; a tree like ``caches``."""
    if isinstance(caches, (list, tuple)):
        return type(caches)(_map_caches(fn, c, *o)
                            for c, *o in zip(caches, *others))
    return dataclasses.replace(caches, **{
        f.name: fn(f.name, getattr(caches, f.name),
                   *(getattr(o, f.name) for o in others))
        for f in dataclasses.fields(caches) if f.name != "window"})


def cache_shardings(rules: ShardingRules, mesh, cache_shapes):
    """The spec of every leaf of a decode-cache tree (possibly stacked over
    a group's repeats; leaves are anything with a ``shape``, a ``length``
    has none), as a tree like ``cache_shapes``.  Leaves are identified by
    their field name; trailing-dim specs are right-aligned, so stacked
    caches inherit the same layout, and fitted (:func:`_fit_spec`)."""
    by_name = _cache_leaf_specs(rules)
    return _map_caches(
        lambda name, leaf: _leaf_spec(by_name, name,
                                      tuple(getattr(leaf, "shape", ())),
                                      mesh), cache_shapes)


def _axes_of(spec) -> list[str]:
    """Every mesh axis a spec names, in order."""
    out = []
    for e in spec:
        if e is not None:
            out.extend(e if isinstance(e, tuple) else (e,))
    return out


def _use_spec(names: tuple, spec: tuple, model_axis: str,
              megatron: bool = False) -> tuple:
    """A parameter's layout at use: whole, but an expert dim keeps its
    model shard (each rank runs its own experts); under megatron every
    model-parallel dim does (heads, FFN columns, experts, vocab, mamba2's
    inner dims: the rank's column or row block)."""
    keep = _MODEL_AXES if megatron else {"experts"}
    return tuple(e if n in keep and e == model_axis else None
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
    cache_len: Optional[int] = None

    active = True

    def __post_init__(self):
        if self.rules.strategy not in ("neutron_tp", "megatron", "dp"):
            raise ValueError(f"strategy {self.rules.strategy!r}")
        axes = (self.rules.model_axis,) + tuple(self.rules.data_axes)
        if set(axes) != set(self.mesh.shape):
            raise ValueError(
                f"rules name axes {axes} but the mesh has "
                f"{tuple(self.mesh.shape)}: build it with hybrid_mesh")

    def bound(self, batch: int, seq: int) -> "Sharder":
        return dataclasses.replace(self, batch=batch, seq=seq)

    def serving(self, max_len: int) -> "Sharder":
        """This sharder for caches whose dense and latent leaves hold
        ``max_len`` positions (a rank's shard does not show it)."""
        return dataclasses.replace(self, cache_len=max_len)

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

    # ---- megatron's tensor-parallel NN phase ---------------------------

    @property
    def megatron(self) -> bool:
        return self.rules.strategy == "megatron"

    def tp(self, size: int) -> bool:
        """Whether the NN phase splits a parameter dim of global ``size``
        over the model axis (megatron, and the axis divides it: the
        divisibility guard of ``param_axis``)."""
        return self.megatron and size % self.size(self.rules.model_axis) \
            == 0

    def tp_sum(self, y):
        """The partial outputs ``y`` summed over the model axis (ledger op
        ``tp_psum``)."""
        m = self.rules.model_axis
        return C.tp_psum(y, self.mesh.group_of(m), axis=m)

    def row_sum(self, y, size: int):
        """A row-parallel matmul's output ``y`` summed over the model axis
        where its contracted dim (global ``size``) is split."""
        return self.tp_sum(y) if self.tp(size) else y

    def col_gather(self, y, size: int, op: str = "tp_gather"):
        """A column-parallel matmul's output ``y`` gathered whole along its
        last dim (global ``size``) where that dim is split."""
        if not self.tp(size):
            return y
        m = self.rules.model_axis
        return C.all_gather(y, self.mesh.group_of(m), axis=m, op=op,
                            dim=y.dim() - 1)

    def tp_block(self, t, dim: int, size: int):
        """This rank's block of ``t``, whole along ``dim`` (global
        ``size``), where the NN phase splits that dim."""
        if not self.tp(size):
            return t
        width = t.shape[dim] // self.size(self.rules.model_axis)
        return t.narrow(dim, self.index(self.rules.model_axis) * width,
                        width)

    # ---- decode caches -------------------------------------------------

    def cache_spec(self, name: str, shape: tuple) -> tuple:
        """The :func:`cache_shardings` spec of a cache leaf named ``name``
        of global ``shape``."""
        return _leaf_spec(_cache_leaf_specs(self.rules), name, shape,
                          self.mesh)

    def cache_layout(self, name: str, shape: tuple) -> "CacheLayout":
        return CacheLayout(self, self.cache_spec(name, shape))

    def to_cache(self, x, name: str, shape: tuple, build, keep=None,
                 local: tuple = ()):
        """The cache leaf ``name`` of global ``shape`` from ``x`` (B_l,
        S_l, ...), this rank's block of the prompt's token layout (its
        dims ``local`` the rank's model shard: megatron's head-local k and
        v): the last ``keep`` positions (all by default) gathered whole
        over the sequence, with the batch and trailing dims as the cache
        keeps them (ledger op ``cache_place``; a sequence shard at least
        ``keep`` long sends its tail only), ``build`` run on them, this
        rank's block of the result sliced out, contiguous."""
        keep = self.seq if keep is None else keep
        src = self._local(self.spec("act_tokens", (self.batch, self.seq)
                                    + tuple(shape[2:])), local)
        dst = self.cache_spec(name, shape)
        mid = tuple(None if i == 1 or e != dst[i] else e
                    for i, e in enumerate(src))
        if src[1] is not None and x.shape[1] >= keep:
            x = x[:, x.shape[1] - keep:]
        y = self.move(x, src, mid, gather_op="cache_place")
        return self.move(build(y[:, y.shape[1] - keep:]), mid,
                         dst).contiguous().clone()

    def _local(self, spec: tuple, dims) -> tuple:
        """``spec`` with the dims ``dims`` on the model axis."""
        return tuple(self.rules.model_axis if i in dims else e
                     for i, e in enumerate(spec))

    def group_of(self, entry):
        """(process group, ledger axis label) of a spec entry: an axis, or
        the data axes together (their replica group)."""
        axes = entry if isinstance(entry, tuple) else (entry,)
        if len(axes) == 1:
            return self.mesh.group_of(axes[0]), axes[0]
        if axes != tuple(self.mesh.data_axes):
            raise NotImplementedError(f"a dim sharded over {axes}")
        return self.mesh.replica_group, axes

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
                    n, s, self.rules.model_axis, self.megatron)), names,
                specs)
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


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """A decode-cache leaf's layout on this rank (``Sharder.cache_layout``):
    ``spec``, fitted to the leaf's global shape (one repeat's, unstacked),
    dim 1 its sequence where it has one.

    ``take`` moves a decode step's tensor from the token layout at S = 1
    (the rank's batch block, every other dim whole but the tensor dims
    ``local``, the rank's model shard: megatron's head-local q, k and v;
    a tensor without a batch dim is whole) to the leaf's layout on the
    dims ``dims`` maps (tensor dim → leaf dim), ``give`` back (the gathers
    of either recorded as ``op``).  ``local_slot`` is where this rank holds
    a global sequence slot (None where another rank does), ``offset`` its
    block's first slot, and ``split`` the sequence's group where more than
    one rank shares it (else None); ``partials`` stacks every rank's ``t``
    of that group on a new dim 0 (ledger op ``softmax_gather``)."""

    shard: Sharder
    spec: tuple

    def _specs(self, t, dims: dict, local) -> tuple:
        et = self.shard.spec("act_tokens", (self.shard.batch, 1, 1))[0]
        src, dst = [None] * t.dim(), [None] * t.dim()
        for td, cd in dims.items():
            src[td] = et if cd == 0 else None
            dst[td] = self.spec[cd]
        return self.shard._local(src, local), tuple(dst)

    def take(self, t, dims: dict, local: tuple = (),
             op: str = "all_gather"):
        src, dst = self._specs(t, dims, local)
        return self.shard.move(t, src, dst, gather_op=op)

    def give(self, t, dims: dict, op: str = "all_gather",
             local: tuple = ()):
        src, dst = self._specs(t, dims, local)
        return self.shard.move(t, dst, src, gather_op=op)

    def _seq(self):
        e = self.spec[1]
        if e is None:
            return None
        group, label = self.shard.group_of(e)
        return group, label, C.axis_size(group), C.axis_index(group)

    @property
    def split(self):
        seq = self._seq()
        return seq if seq is not None and seq[2] > 1 else None

    def offset(self, local_len: int) -> int:
        seq = self._seq()
        return 0 if seq is None else seq[3] * local_len

    def local_slot(self, slot: int, local_len: int):
        j = slot - self.offset(local_len)
        return j if 0 <= j < local_len else None

    def partials(self, t):
        group, label, _, _ = self.split
        return C.all_gather(t[None], group, axis=label, op="softmax_gather",
                            dim=0)


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


def place_caches(caches, sharder: Sharder):
    """This rank's shard of every leaf of the whole decode-cache tree
    ``caches`` (the same on every rank), by :func:`cache_shardings`;
    copies."""
    specs = cache_shardings(sharder.rules, sharder.mesh, caches)
    return _map_caches(lambda name, t, s: sharder.move(
        t, (None,) * t.dim(), s).clone() if torch.is_tensor(t) else t,
        caches, specs)


def gather_caches(shards, like, sharder: Sharder):
    """The whole cache tree from every rank's shards; ``like`` is a tree
    of the whole caches' shapes (``init_caches(..., device="meta")``)."""
    specs = cache_shardings(sharder.rules, sharder.mesh, like)
    with torch.no_grad():
        return _map_caches(lambda name, t, s: sharder.move(
            t, s, (None,) * t.dim()) if torch.is_tensor(t) else t,
            shards, specs)
