"""Distributed decoupled GNN tensor parallelism (paper §3 + §4.1 + §4.2).

The execution engine behind Algorithm 1, one process per TP rank:

  vertex-sharded NN phase (L UPDATE rounds)
    → split (all-to-all)                      ┐
    → L chunk-by-chunk aggregation rounds     ├ dim-sharded, zero vertex deps
    → gather (all-to-all)                     ┘
    → masked softmax loss on local vertices (+ psum)

Three execution modes:
  * ``decoupled``            — one split + one gather per epoch (paper's DT)
  * ``decoupled_pipelined``  — split/gather partitioned into per-chunk tasks
                               interleaved with aggregation (paper's DT+IP)
  * ``naive``                — coupled layers with a split and a gather per
                               layer (the paper's "TP" baseline, Fig. 8)

GAT's propagation weights are its attention α, computed at run time: each
rank scores its own vertex rows and the two (V/N,) score halves are shared
by an all-gather (the paper's generalized decoupling, §4.1.1), and GAT
aggregates by segment sums on any bundle.

Every rank builds the same host-side bundle (:func:`prepare_bundle`) and
keeps its own vertex rows of it: with ``mesh=`` only those rows reach its
device (:func:`place_bundle`, V/N rows a rank, as the reference's global
arrays); without, the bundle holds every row and each step reads its own.
Parameters are replicated: the backward runs through the mirrored
all-to-alls, and the factories sum the parameter gradients across ranks
(``runtime.collectives`` says why).

Hybrid DP×TP (a :func:`repro_torch.runtime.hybrid_mesh`, ``data_axes``
non-empty): the vertex dim shards over every rank, model-major (rank
(m, r) holds block ``m·R + r``, :func:`repro_torch.core.tp.vertex_block`).
The NN phase runs on a rank's own rows; ``replica_gather`` builds the
model worker's contiguous V/N block for the aggregation and
``replica_slice`` returns to the replica's rows after it; the gather and
split all-to-alls stay on the model axis; the loss sums span the model
then the replica axes, and the gradients are summed over every rank.
``data_axes=()`` on a hybrid mesh is pure TP inside each replica group.

Every mode runs on two engine backends, ``backend="explicit" |
"constraint"``, as in the reference.  The explicit one is the per-rank
code above.  The constraint one (:mod:`repro_torch.runtime.constraint`)
writes the same forward on global DTensors: the NN phase on the mesh's
vertex layout, the split and gather as layout transitions run through
the same choke point, the chunk loop and the loss on local shards, and
the loss sums and gradients reduced by DTensor (``constraint.replicate``).
``decoupled_pipelined`` is an alias of ``decoupled`` under it, as in the
reference.  Both take and return plain tensors, with the same numerics and
the same all-to-all and all-gather ledger entries.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..gnn import layers as L
from ..gnn import models as M
from ..graph import format as gf
from ..graph.synthetic import GraphData
from ..params import tree_leaves, tree_map, tree_unflatten
from ..optim.adamw import apply_updates
from ..runtime import collectives as C
from ..runtime import constraint as K
from ..runtime import distributed as dist
from ..runtime import telemetry as T
from ..runtime.mesh import TPMesh, padded_size, resolve_bundle_degrees
from . import agg as AGG
from . import chunks as CH
from . import tp


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPGraph:
    """Replicated graph structure + comm plans (on every rank)."""

    edges: L.EdgeListDev          # full graph
    chunked: L.ChunkedDev         # chunk-scheduled view
    comm_plan: CH.ChunkCommPlan   # per-chunk a2a tables
    n: int
    n_padded: int
    n_workers: int
    num_classes: int
    c_padded: int                 # class dim padded to multiple of workers
    in_dim_padded: int
    # aggregation backend (core.agg): "segment" needs no extra data;
    # "blocksparse" carries the per-chunk tile plans, "dense" the
    # per-chunk dense adjacency rows
    agg: str = "segment"
    bsp: Any = None               # SP.BlockSparsePlanDev | None
    dense_adj: Any = None         # (C, chunk_size, n_padded) f32 | None
    # the segment backend's compressed rows of the static weights, one
    # core.agg.csr_plan instance a chunk (core.agg.with_csr): set where a
    # GCN-like step is built, never on a bundle, so GAT's carries none
    csr: Any = None


@dataclasses.dataclass(frozen=True)
class TPBundle:
    """Training bundle: replicated graph + node arrays, over all vertices
    (each step reads its rank's rows) or, placed (:func:`place_bundle`),
    over this rank's block ``block = (index, count)`` of them only."""

    graph: TPGraph
    features: torch.Tensor        # (n_padded, in_dim_padded) or its block
    labels: torch.Tensor          # (n_padded,) int64 (pad 0)
    train_mask: torch.Tensor      # (n_padded,) f32
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    block: tuple[int, int] | None = None

    @property
    def n_padded(self):
        return self.graph.n_padded

    @property
    def n_workers(self):
        return self.graph.n_workers

    @property
    def in_dim_padded(self):
        return self.graph.in_dim_padded

    def masks(self) -> dict:
        return {"train": self.train_mask, "val": self.val_mask,
                "test": self.test_mask}


def _pad_graph(g: gf.Graph, n_padded: int) -> gf.Graph:
    if n_padded == g.n:
        return g
    indptr = np.concatenate(
        [g.indptr, np.full(n_padded - g.n, g.indptr[-1], g.indptr.dtype)])
    return gf.Graph(n=n_padded, src=g.src, dst=g.dst, weight=g.weight,
                    indptr=indptr)


NODE_ARRAYS = ("features", "labels", "train_mask", "val_mask", "test_mask")


def node_array_bytes(bundle) -> int:
    """Bytes of a bundle's node arrays (features, labels, the three
    masks): what placement divides by the rank count."""
    return sum(getattr(bundle, f).numel() * getattr(bundle, f).element_size()
               for f in NODE_ARRAYS)


def place_bundle(bundle: TPBundle, mesh: TPMesh, device=None) -> TPBundle:
    """This rank's share of ``bundle`` on ``device``: its vertex block
    (:func:`repro_torch.core.tp.vertex_block`; V/(N·R) rows under hybrid
    DP×TP) of the node arrays, through
    :func:`repro_torch.runtime.distributed.put_global`.  The graph
    structure and the comm plans stay replicated, as in the reference's
    ``place_bundle``."""
    vspec = tp.vertex_spec(mesh.axis, mesh.data_axes)
    return dataclasses.replace(
        bundle, block=tp.vertex_block(mesh),
        **{f: dist.put_global(getattr(bundle, f), mesh,
                              vspec[:getattr(bundle, f).dim()], device)
           for f in NODE_ARRAYS})


def prepare_bundle(data: GraphData, n_workers: int | None = None,
                   n_chunks: int = 4, n_replicas: int | None = None,
                   mesh: TPMesh | None = None, agg: str = "segment",
                   agg_block_size: int = 128, device="cuda") -> TPBundle:
    """Host-side prep for ``n_workers`` TP ranks, placed on ``device``.
    Under a hybrid mesh ``n_replicas`` is the replica count, so the vertex
    dim pads to a multiple of every rank (``n_workers·n_chunks·
    n_replicas``).  ``mesh=`` derives both degrees from the mesh (explicit
    ones must match it) and returns the bundle placed on it
    (:func:`place_bundle`): only this rank's rows of the node arrays reach
    ``device``.  Without a mesh the bundle holds every row.

    ``agg`` selects the default aggregation backend
    (:data:`repro_torch.core.agg.AGG_BACKENDS`) and builds its per-chunk
    data: tile plans of block size ``agg_block_size`` for
    ``"blocksparse"``, dense adjacency rows (O(V²) memory — small graphs)
    for ``"dense"``.  The chunked segment view is always built."""
    if mesh is not None:
        n_workers, n_replicas = resolve_bundle_degrees(mesh, n_workers,
                                                       n_replicas)
    elif n_workers is None:
        raise TypeError("prepare_bundle needs n_workers= (or mesh= to "
                        "derive it)")
    n_replicas = 1 if n_replicas is None else n_replicas
    g = data.graph
    n_padded = padded_size(g.n, n_workers * n_chunks * n_replicas)
    with T.span("prepare.chunk_graph"):
        gp = _pad_graph(g, n_padded)
        cg = gf.chunk_graph(gp, n_chunks)
    with T.span("prepare.comm_plan"):
        plan = CH.build_chunk_comm_plan(cg, n_workers, n_padded, device)
    with T.span("prepare.agg_plans"):
        bsp, dense_adj = AGG.build_chunk_plans(gp, n_chunks, agg,
                                               bs=agg_block_size,
                                               device=device)
    with T.span("prepare.graph_upload"):
        edges = L.edge_list_dev(gp, device)
        chunked = L.chunked_dev(cg, device)

    in_dim = data.features.shape[1]
    in_dim_padded = padded_size(in_dim, n_workers)
    c_padded = padded_size(data.num_classes, n_workers)

    # with a mesh the node arrays stay on the host until placed: only this
    # rank's rows are copied to the device
    node_dev = "cpu" if mesh is not None else device

    def pad_mask(m):
        out = np.zeros((n_padded,), np.float32)
        out[: g.n] = m.astype(np.float32)
        return torch.from_numpy(out).to(node_dev)

    with T.span("prepare.node_arrays"):
        feats = np.zeros((n_padded, in_dim_padded), np.float32)
        feats[: g.n, :in_dim] = data.features
        labels = np.zeros((n_padded,), np.int64)
        labels[: g.n] = data.labels
        nodes = dict(features=torch.from_numpy(feats).to(node_dev),
                     labels=torch.from_numpy(labels).to(node_dev),
                     train_mask=pad_mask(data.train_mask),
                     val_mask=pad_mask(data.val_mask),
                     test_mask=pad_mask(data.test_mask))

    graph = TPGraph(
        edges=edges, chunked=chunked, comm_plan=plan,
        n=g.n, n_padded=n_padded, n_workers=n_workers,
        num_classes=data.num_classes, c_padded=c_padded,
        in_dim_padded=in_dim_padded, agg=agg, bsp=bsp, dense_adj=dense_adj)
    bundle = TPBundle(graph=graph, **nodes)
    if mesh is None:
        return bundle
    with T.span("prepare.place"):
        return place_bundle(bundle, mesh, device)


def padded_gnn_config(data: GraphData, bundle: TPBundle,
                      model: str = "gcn", hidden_dim: int = 64,
                      num_layers: int = 2, decoupled: bool = True,
                      gamma: float = 1.0) -> M.GNNConfig:
    """GNN config whose dims are padded for N-way TP divisibility."""
    return M.GNNConfig(
        model=model, in_dim=bundle.in_dim_padded,
        hidden_dim=padded_size(hidden_dim, bundle.n_workers),
        num_classes=bundle.graph.c_padded, num_layers=num_layers,
        decoupled=decoupled, gamma=gamma)


# ---------------------------------------------------------------------------
# Dim-sharded propagation rounds (run on feature slices)
# ---------------------------------------------------------------------------
#
# Every round is pure per-rank compute on the feature slice; the aggregation
# backend dispatches inside the chunk loops without touching the split/
# gather schedule.  Buffers written by the chunk steps carry one dump row
# for the -1 pads of the comm tables (core.chunks).

def _aggregate_once(graph: TPGraph, z, agg: str, w_chunk, scale: float,
                    r: int = 0):
    """One full aggregation round (round ``r``) over all chunks."""
    cs = graph.chunked.chunk_size
    outs = []
    for c, ax in enumerate(AGG.chunk_xs(graph, agg, w_chunk)):
        with T.span("agg.r%d.c%d", r, c):
            outs.append(AGG.chunk_agg(agg, z, ax, cs, scale))
    return torch.cat(outs)[: z.shape[0]]


def _propagate_plain(graph: TPGraph, z, w_chunk, rounds: int,
                     agg: str = "segment", scale: float = 1.0,
                     first: int = 0):
    """Rounds ``first`` .. ``first + rounds - 1``."""
    for r in range(first, first + rounds):
        z = _aggregate_once(graph, z, agg, w_chunk, scale, r)
    return z


def _round_split_pipelined(h_local, graph: TPGraph, w_chunk, mesh: TPMesh,
                           agg: str = "segment", scale: float = 1.0):
    """First propagation round with per-chunk split interleaved (§4.2.2)."""
    cs, plan = graph.chunked.chunk_size, graph.comm_plan
    zbuf = h_local.new_zeros(plan.n_padded + 1, h_local.shape[1] // mesh.size)
    outs = []
    for c, ax in enumerate(AGG.chunk_xs(graph, agg, w_chunk)):
        with T.span("tp.split.c%d", c):
            zbuf = CH.chunk_split_step(h_local, plan.split_rows[c], zbuf,
                                       mesh)
        with T.span("agg.r0.c%d", c):
            outs.append(AGG.chunk_agg(agg, zbuf[:-1], ax, cs, scale))
    return torch.cat(outs)[: plan.n_padded]


def _round_gather_pipelined(z, graph: TPGraph, w_chunk, d_full: int,
                            mesh: TPMesh, agg: str = "segment",
                            scale: float = 1.0, r: int = 1):
    """Last propagation round (round ``r``) with per-chunk gather
    interleaved."""
    cs, plan = graph.chunked.chunk_size, graph.comm_plan
    h_out = z.new_zeros(plan.n_padded // mesh.size + 1, d_full)
    for c, ax in enumerate(AGG.chunk_xs(graph, agg, w_chunk)):
        with T.span("agg.r%d.c%d", r, c):
            out_c = AGG.chunk_agg(agg, z, ax, cs, scale)
        with T.span("tp.gather.c%d", c):
            h_out = CH.chunk_gather_step(out_c, plan.gather_rows[c], c * cs,
                                         h_out, mesh)
    return h_out[:-1]


def _round_split_gather_pipelined(h_local, graph: TPGraph, w_chunk,
                                  d_full: int, mesh: TPMesh,
                                  agg: str = "segment", scale: float = 1.0):
    """Single-round case: split, aggregate, gather all chunk-interleaved."""
    cs, plan = graph.chunked.chunk_size, graph.comm_plan
    zbuf = h_local.new_zeros(plan.n_padded + 1, h_local.shape[1] // mesh.size)
    h_out = h_local.new_zeros(plan.n_padded // mesh.size + 1, d_full)
    for c, ax in enumerate(AGG.chunk_xs(graph, agg, w_chunk)):
        with T.span("tp.split.c%d", c):
            zbuf = CH.chunk_split_step(h_local, plan.split_rows[c], zbuf,
                                       mesh)
        with T.span("agg.r0.c%d", c):
            out_c = AGG.chunk_agg(agg, zbuf[:-1], ax, cs, scale)
        with T.span("tp.gather.c%d", c):
            h_out = CH.chunk_gather_step(out_c, plan.gather_rows[c], c * cs,
                                         h_out, mesh)
    return h_out[:-1]


# ---------------------------------------------------------------------------
# Edge weights for propagation (shared across ranks)
# ---------------------------------------------------------------------------

def _gat_alpha_tp(p, edges: L.EdgeListDev, h_local, mesh: TPMesh):
    """GAT's attention α over the whole graph from this rank's rows: the
    paper's generalized decoupling.  Each rank scores its own vertices,
    and the two (V/N,) score halves are shared by an all-gather — O(V)
    communication, not O(E·D)."""
    with T.span("gat.alpha"):
        sl = C.all_gather(h_local @ p["a_l"], mesh.group, axis=mesh.axis)
        sr = C.all_gather(h_local @ p["a_r"], mesh.group, axis=mesh.axis)
        return L.gat_alpha(edges, sl, sr)


def _edge_weights_tp(params, cfg: M.GNNConfig, graph: TPGraph, h_local,
                     mesh: TPMesh):
    """The chunked propagation weights a step computes: GAT's γ·α, the
    precomputed attention, rechunked; ``None`` for the GCN-like models,
    whose static weights Â the backends hold (γ their scale,
    :func:`_effective_agg`)."""
    if cfg.model != "gat":
        return None
    alpha = _gat_alpha_tp(params["layers"][-1], graph.edges, h_local, mesh)
    return L.rechunk_edge_values(graph.chunked, cfg.gamma * alpha)


def _effective_agg(cfg: M.GNNConfig, agg: str) -> tuple[str, float]:
    """(backend, scale) a forward actually uses.

    GAT always aggregates by segment sums: its edge weights α are computed
    at run time from the features, so they cannot be baked into the
    compressed rows, tiles or dense rows, and γ is already inside α.  For
    the other models every backend holds the static weights Â (the
    segment backend as compressed rows, :func:`repro_torch.core.agg
    .csr_plan`), and γ becomes a scalar post-multiplier, since γ·(Â@z) =
    (γÂ)@z."""
    if cfg.model == "gat":
        return "segment", 1.0
    return agg, cfg.gamma


# ---------------------------------------------------------------------------
# Forward passes (per rank)
# ---------------------------------------------------------------------------

def tp_decoupled_forward(params, cfg: M.GNNConfig, graph: TPGraph,
                         x_local, mesh: TPMesh, pipelined: bool = True,
                         agg: str = "segment"):
    """Decoupled TP forward: this rank's (V/N, D) rows in, its (V/N, C_pad)
    logits out.  ``agg`` selects the aggregation backend of the
    propagation rounds (:mod:`repro_torch.core.agg`; GAT is pinned to
    ``segment``, :func:`_effective_agg`).

    Hybrid DP×TP (``mesh`` has data axes): ``x_local`` holds only this
    replica's rows (V/(N·R), D).  The NN phase runs on them before the replica shards
    are gathered into the model worker's block (exact: the MLP is
    row-wise), and the result is sliced back to this replica's rows."""
    rep = mesh.replicas()
    agg, scale = _effective_agg(cfg, agg)
    with T.span("gnn.nn_phase"):
        h = M.mlp_phase(params, cfg, x_local)          # NN phase, local rows
    h = C.replica_gather(h, rep)                       # (V/N, C)
    with T.span("gnn.edge_weights"):
        w_chunk = _edge_weights_tp(params, cfg, graph, h, mesh)
    n_rounds = cfg.num_layers
    d_full = h.shape[1]

    if not pipelined:
        with T.span("tp.split"):
            z = tp.split(h, mesh)                      # (V, C/N)
        z = _propagate_plain(graph, z, w_chunk, n_rounds, agg, scale)
        with T.span("tp.gather"):
            out = tp.gather(z, mesh)                   # (V/N, C)
    elif n_rounds == 1:
        out = _round_split_gather_pipelined(
            h, graph, w_chunk, d_full, mesh, agg, scale)
    else:
        z = _round_split_pipelined(h, graph, w_chunk, mesh, agg, scale)
        z = _propagate_plain(graph, z, w_chunk, n_rounds - 2, agg, scale,
                             first=1)
        out = _round_gather_pipelined(z, graph, w_chunk, d_full, mesh, agg,
                                      scale, r=n_rounds - 1)
    return C.replica_slice(out, rep)


NAIVE_MODELS = ("gcn", "gat")


def tp_naive_forward(params, cfg: M.GNNConfig, graph: TPGraph, x_local,
                     mesh: TPMesh, agg: str = "segment"):
    """Coupled ("naive") TP: a split, one aggregation round and a gather
    per layer (Fig. 8's baseline), for GCN and GAT.  No γ (``scale=1``).

    GCN: the dense update follows the gather, on this rank's rows.  Layer
    0 moves the input features, which carry no gradient, so its
    all-to-alls have no backward: 4L−2 a step.  GAT: ``h @ w`` comes
    first, then the score all-gathers, α, and the aggregation by segment
    sums (:func:`_effective_agg`); every all-to-all moves ``h @ w``,
    which depends on the weights, so all have a backward: 4L a step, and
    4L all-gathers.

    Hybrid DP×TP: each layer keeps only this replica's rows between
    layers, gathers the replica shards for the aggregation (which needs
    the model worker's whole block) and slices back before the dense
    update, as the DP baseline does; layer 0's replica gather, like its
    all-to-alls, has no backward."""
    rep = mesh.replicas()
    agg, _ = _effective_agg(cfg, agg)
    h = x_local
    n_layers = cfg.num_layers
    for i, p in enumerate(params["layers"]):
        last = i == n_layers - 1
        if cfg.model == "gat":
            hw = h @ p["w"]                            # dense on local rows
            hw = C.replica_gather(hw, rep)             # (V/N, D')
            alpha = _gat_alpha_tp(p, graph.edges, hw, mesh)
            w_chunk = L.rechunk_edge_values(graph.chunked, alpha)
            z = _aggregate_once(graph, tp.split(hw, mesh), agg, w_chunk,
                                1.0)
            h = C.replica_slice(tp.gather(z, mesh), rep)
            h = h if last else F.elu(h)
        else:
            hf = C.replica_gather(h, rep, mirror=i > 0)  # (V/N, D) block
            z = tp.split(hf, mesh)                     # dim-sharded
            z = _aggregate_once(graph, z, agg, None, 1.0)
            a = C.replica_slice(tp.gather(z, mesh), rep)  # replica's rows
            h = L.dense(p, a)
            h = h if last else torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Global-view forwards for the constraint backend
# ---------------------------------------------------------------------------

def _aggregate_chunked_constraint(graph: TPGraph, z, w_chunk, axis: str,
                                  agg: str = "segment", scale: float = 1.0):
    """One aggregation round of the dim-sharded global ``z`` on each
    rank's column shard (:func:`repro_torch.runtime.constraint.local_map`,
    ``(None, axis)`` in and out).  DTensor has no sharding rule for the
    SpMM kernel's autograd function, nor a safe one for ``index_select`` /
    ``index_add_`` on a column-sharded operand: without the local map it
    would raise or replicate z (the reference's "involuntary full
    rematerialization")."""
    return K.local_map(
        lambda zl: _aggregate_once(graph, zl, agg, w_chunk, scale),
        (None, axis), z)


def _edge_weights_constraint(params, cfg: M.GNNConfig, graph: TPGraph, h,
                             axis: str):
    """GAT's chunked γ·α from the model-sharded global ``h``; ``None`` for
    the static weights (:func:`_edge_weights_tp`).  The reference anchors
    the two (V,) score vectors replicated (``P(None)``) and lets its
    partitioner gather them; here that O(V) all-gather is a transition
    through the choke point, and α is computed on the whole vectors on
    every rank as a local tensor, whose gradient the all-gather's backward
    sums."""
    if cfg.model != "gat":
        return None
    p = params["layers"][-1]
    sl, sr = (K.layout_cast(h @ p[k], (None,), src_spec=(axis,),
                            mirror=True).to_local()
              for k in ("a_l", "a_r"))
    return L.rechunk_edge_values(
        graph.chunked, cfg.gamma * L.gat_alpha(graph.edges, sl, sr))


def tp_decoupled_forward_constraint(params, cfg: M.GNNConfig,
                                    graph: TPGraph, x, mesh: TPMesh,
                                    agg: str = "segment"):
    """Decoupled TP forward on global DTensors: ``x`` (V, D) laid out
    :func:`repro_torch.core.tp.vertex_spec`, the logits (V, C_pad) too.
    The NN phase runs on the vertex layout (under hybrid DP×TP on every
    rank's rows), then the data-axis hop gathers the model block, where
    GAT scores its vertices, and the split, L rounds and the gather
    follow."""
    axis, data_axes = mesh.axis, mesh.data_axes
    agg, scale = _effective_agg(cfg, agg)
    vspec = tp.vertex_spec(axis, data_axes)
    h = K.constrain(M.mlp_phase(params, cfg, x), vspec)
    if data_axes:
        h = K.layout_cast(h, (axis, None), src_spec=vspec, mirror=True)
    w_chunk = _edge_weights_constraint(params, cfg, graph, h, axis)
    z = tp.split_constraint(h, axis)
    for _ in range(cfg.num_layers):
        z = _aggregate_chunked_constraint(graph, z, w_chunk, axis, agg,
                                          scale)
    return tp.gather_constraint(z, axis, data_axes)


def tp_naive_forward_constraint(params, cfg: M.GNNConfig, graph: TPGraph,
                                x, mesh: TPMesh, agg: str = "segment"):
    """Coupled ("naive") TP on global DTensors: a split and a gather
    transition per layer, the dense updates on the vertex layout.  Layer
    0's transitions move the input features (``mirror=False``).  The
    relu is spelled ``h * (h > 0)``, as the reference spells it for this
    backend."""
    axis, data_axes = mesh.axis, mesh.data_axes
    agg, _ = _effective_agg(cfg, agg)
    vspec = tp.vertex_spec(axis, data_axes)
    h = K.constrain(x, vspec)
    n_layers = cfg.num_layers
    for i, p in enumerate(params["layers"]):
        last = i == n_layers - 1
        if cfg.model == "gat":
            hw = K.constrain(h @ p["w"], vspec)
            if data_axes:
                hw = K.layout_cast(hw, (axis, None), src_spec=vspec,
                                   mirror=True)
            sl, sr = (K.layout_cast(hw @ p[k], (None,), src_spec=(axis,),
                                    mirror=True).to_local()
                      for k in ("a_l", "a_r"))
            w_chunk = L.rechunk_edge_values(
                graph.chunked, L.gat_alpha(graph.edges, sl, sr))
            z = tp.split_constraint(hw, axis)
            z = _aggregate_chunked_constraint(graph, z, w_chunk, axis)
            h = tp.gather_constraint(z, axis, data_axes)
            h = h if last else F.elu(h)
        else:
            mirror = i > 0
            z = tp.split_constraint(h, axis, data_axes, mirror=mirror)
            z = _aggregate_chunked_constraint(graph, z, None, axis, agg,
                                              1.0)
            a = tp.gather_constraint(z, axis, data_axes, mirror=mirror)
            h = L.dense(p, a)
            h = h if last else h * (h > 0)
        h = K.constrain(h, vspec)
    return h


# ---------------------------------------------------------------------------
# Loss / train-step factories
# ---------------------------------------------------------------------------

_FORWARDS = {
    "decoupled": partial(tp_decoupled_forward, pipelined=False),
    "decoupled_pipelined": partial(tp_decoupled_forward, pipelined=True),
    "naive": tp_naive_forward,
}

# the chunk interleaving has nothing to pipeline when the transitions are
# whole-tensor moves: decoupled_pipelined is decoupled, as in the reference
_FORWARDS_CONSTRAINT = {
    "decoupled": tp_decoupled_forward_constraint,
    "decoupled_pipelined": tp_decoupled_forward_constraint,
    "naive": tp_naive_forward_constraint,
}

BACKENDS = ("explicit", "constraint")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"engine backend must be 'explicit' or "
                         f"'constraint', got {backend!r}")
    return backend


def global_loss_and_acc(logits, labels, mask, num_classes: int,
                        mesh: TPMesh):
    """(loss, acc) over every rank's vertices from this rank's logits:
    summed over the model axis, then over the replica axes.

    The three sums travel in one stacked psum of 12 bytes per axis group;
    the reference makes three scalar psums of the same bytes."""
    with T.span("tp.loss"):
        sums = torch.stack(M.masked_loss_and_acc(logits, labels, mask,
                                                 num_classes))
        sums = C.psum(sums, mesh.group, axis=mesh.axis)
        loss_sum, correct, cnt = C.psum_replicas(sums, mesh.replicas())
        cnt = torch.clamp(cnt, min=1.0)
        return loss_sum / cnt, correct / cnt


def global_loss_and_acc_constraint(logits, labels, mask, num_classes: int):
    """(loss, acc) of global DTensors: each rank's three sums (a
    ``local_map``, Partial), reduced stacked in one
    :func:`repro_torch.runtime.constraint.replicate`."""
    sums = K.local_map(
        lambda lg, y, m: torch.stack(M.masked_loss_and_acc(lg, y, m,
                                                           num_classes)),
        None, logits, labels, mask, partial=True)
    sums = K.replicate(sums)
    cnt = torch.clamp(sums[2], min=1.0)
    return sums[0] / cnt, sums[1] / cnt


def _make_tp_loss_and_acc(cfg: M.GNNConfig, mesh: TPMesh, mode: str,
                          agg: str, backend: str):
    """(params, graph, x, labels, mask) → (loss, acc), the loss and
    accuracy over every rank's vertices: of this rank's rows (explicit),
    or of global DTensors (constraint)."""
    if mode not in _FORWARDS:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{tuple(_FORWARDS)}")
    if mode == "naive" and cfg.model not in NAIVE_MODELS:
        raise ValueError(
            f"naive TP supports {NAIVE_MODELS}, not {cfg.model!r}, as the "
            f"reference's coupled TP forward does; train {cfg.model!r} "
            f"with mode='decoupled' or 'decoupled_pipelined'")
    if check_backend(backend) == "constraint":
        fwd_c = _FORWARDS_CONSTRAINT[mode]

        def global_loss(params, graph, x, labels, mask):
            logits = fwd_c(params, cfg, graph, x, mesh, agg=agg)
            return global_loss_and_acc_constraint(logits, labels, mask,
                                                  graph.num_classes)

        return global_loss
    fwd = _FORWARDS[mode]

    def shard_loss(params, graph, x_local, labels_local, mask_local):
        logits = fwd(params, cfg, graph, x_local, mesh, agg=agg)
        return global_loss_and_acc(logits, labels_local, mask_local,
                                   graph.num_classes, mesh)

    return shard_loss


def _check_bundle_fits(bundle: TPBundle, mesh: TPMesh) -> None:
    """Fail early with a padding hint when the bundle was prepared for
    another (model, data) shape than the execution will use (the pure-TP
    view of a hybrid mesh validates against the model degree alone)."""
    n, replicas = mesh.size, mesh.data_size
    try:
        mesh.validate_divisible(n_vertices=bundle.n_padded,
                                dim=bundle.in_dim_padded)
    except ValueError as e:
        raise ValueError(
            f"{e} Re-run prepare_bundle with n_workers={n}, "
            f"n_replicas={replicas}.") from None
    if bundle.n_workers != n:
        raise ValueError(
            f"bundle prepared for n_workers={bundle.n_workers} but mesh "
            f"model degree is {n} — re-run prepare_bundle with the "
            f"mesh's model degree (and n_replicas={replicas})")


def local_rows(n_padded: int, mesh: TPMesh, block=None):
    """(rows → this rank's rows) for arrays over the vertex dim of
    ``n_padded``: block ``m·R + r`` of V/(N·R) is sliced out of an array
    over all vertices, and an array of one block's rows — a placed
    bundle's, whose ``block`` must be this rank's — is taken as it is."""
    idx, count = tp.vertex_block(mesh)
    if block is not None and tuple(block) != (idx, count):
        raise ValueError(
            f"bundle placed for vertex block {block[0]} of {block[1]} but "
            f"this rank's execution takes block {idx} of {count} — place "
            f"it on the execution's mesh (prepare_bundle(mesh=...)) or "
            f"prepare it without mesh=")
    shard = n_padded // count
    rows = slice(idx * shard, (idx + 1) * shard)

    def mine(a):
        if a.shape[0] == n_padded:
            return a[rows]
        if a.shape[0] == shard:
            return a
        raise ValueError(
            f"a node array of {a.shape[0]} rows is neither over all "
            f"{n_padded} vertices nor one rank's {shard}")

    return mine


def _make_local_loss(cfg: M.GNNConfig, bundle: TPBundle, mesh: TPMesh,
                     mode: str, agg, backend: str):
    """(params, mask) → (loss, acc) on this rank's rows of the bundle, with
    ``mask`` over all vertices or this rank's rows (:func:`local_rows`).
    Under the constraint backend the rows enter as the shards of global
    DTensors laid out ``vertex_spec``."""
    _check_bundle_fits(bundle, mesh)
    agg = AGG.resolve_choice(bundle.graph, agg)
    if agg == "segment" and cfg.model != "gat":
        bundle = dataclasses.replace(bundle, graph=AGG.with_csr(bundle.graph))
    body = _make_tp_loss_and_acc(cfg, mesh, mode, agg, backend)
    mine = local_rows(bundle.n_padded, mesh, bundle.block)
    x, labels = mine(bundle.features), mine(bundle.labels)
    if backend == "constraint":
        vspec = tp.vertex_spec(mesh.axis, mesh.data_axes)
        x = K.from_local(x, vspec, mesh)
        labels = K.from_local(labels, vspec[:1], mesh)

        def global_loss(params, mask):
            return body(params, bundle.graph, x, labels,
                        K.from_local(mine(mask), vspec[:1], mesh))

        return global_loss

    def loss_and_acc(params, mask):
        return body(params, bundle.graph, x, labels, mine(mask))

    return loss_and_acc


def sum_grads(grads, mesh: TPMesh) -> list:
    """The replicated parameters' gradients (a list of tensors) summed
    across ranks in one all-reduce (ledger op ``grad_psum``): over the
    model group, or under hybrid DP×TP over every rank of the mesh (the
    default group), with the label ``model+data`` (``model+pod+data``)."""
    if mesh.data_axes:
        group, axis = None, (mesh.axis,) + mesh.data_axes
    else:
        group, axis = mesh.group, mesh.axis
    flat = C.psum(torch.cat([g.reshape(-1) for g in grads]), group,
                  axis=axis, op="grad_psum")
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def value_and_grad(loss_and_acc, mesh: TPMesh, backend: str = "explicit"):
    """(params, mask) → (loss, grads) over a per-rank
    ``loss_and_acc(params, mask) → (loss, acc)``, with the replicated
    parameters' gradients summed across ranks (:func:`sum_grads`).  Under
    the constraint backend ``loss_and_acc`` is global-view, and
    :func:`repro_torch.runtime.constraint.value_and_grad` wraps it."""
    if backend == "constraint":
        return K.value_and_grad(loss_and_acc, mesh)

    def value_and_grad_fn(params, mask):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = loss_and_acc(p, mask)
        # a parameter the path does not use (GIN's eps, R-GCN's relation
        # weights on the decoupled path) gets zeros, as under JAX
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        with T.span("tp.grad_sum"):
            grads = sum_grads(grads, mesh)
        return loss.detach(), tree_unflatten(params, grads)

    return value_and_grad_fn


def train_fns(loss_and_acc, mesh: TPMesh, optimizer, masks: dict,
              backend: str = "explicit"):
    """(train_step, evaluate) over a per-rank ``loss_and_acc(params,
    mask)`` (global-view under the constraint backend); ``masks`` maps
    ``"train"``/``"val"``/``"test"`` to the mask ``loss_and_acc``
    takes."""
    vg = value_and_grad(loss_and_acc, mesh, backend)
    if backend == "constraint":
        loss_and_acc = K.plain(loss_and_acc, mesh)

    def train_step(params, opt_state):
        with T.span("tp.train_step"):
            loss, grads = vg(params, masks["train"])
            with T.span("optim.update"):
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = apply_updates(params, updates)
        return params, opt_state, loss

    @torch.no_grad()
    def evaluate(params, split: str = "val"):
        return loss_and_acc(params, masks[split])

    return train_step, evaluate


def make_tp_value_and_grad(cfg: M.GNNConfig, bundle: TPBundle, mesh: TPMesh,
                           mode: str = "decoupled_pipelined", agg=None,
                           data_axes=None, backend: str = "explicit"):
    """(params, mask) → (loss, grads), with ``mask`` over all vertices and
    the grads summed across ranks (the same on every rank).  ``agg=None``
    uses the bundle's prepared aggregation backend; ``data_axes=None``
    the mesh's replica axes (``()``: pure TP on a hybrid mesh);
    ``backend`` the engine backend (module docstring)."""
    mesh = mesh.for_data_axes(data_axes)
    return value_and_grad(
        _make_local_loss(cfg, bundle, mesh, mode, agg, backend), mesh,
        backend)


class _SumGrads(torch.autograd.Function):
    """The parameter leaves, each passed through ``wrap`` (a view of it,
    or a Replicate DTensor of it); their gradients summed over the ranks
    by ``reduce`` in the backward, recorded into the ledgers the forward
    saw."""

    @staticmethod
    def forward(ctx, reduce, wrap, *leaves):
        ctx.reduce, ctx.ledgers = reduce, T.active_ledgers()
        return tuple(wrap(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        with T.ledgers_scope(ctx.ledgers):
            return (None, None, *ctx.reduce(list(grads)))


def make_tp_loss_fn(cfg: M.GNNConfig, bundle: TPBundle, mesh: TPMesh,
                    mode: str = "decoupled_pipelined",
                    backend: str = "explicit", data_axes=None, agg=None):
    """Differentiable (params, mask) → scalar loss over every rank's
    vertices, with ``mask`` over all vertices: the handle to take grads
    through.  The gradients autograd takes through it are
    :func:`make_tp_value_and_grad`'s on every rank: a replicated
    parameter's share from this rank's rows is summed over the ranks in
    the backward, by :func:`sum_grads` (explicit) or by the constraint
    backend's :func:`repro_torch.runtime.constraint.reduce_grads` — the
    sum the reference's ``shard_map`` transpose performs.  The arguments
    are :func:`make_tp_value_and_grad`'s."""
    mesh = mesh.for_data_axes(data_axes)
    return differentiable_loss(
        _make_local_loss(cfg, bundle, mesh, mode, agg, backend), mesh,
        backend)


def differentiable_loss(loss_and_acc, mesh: TPMesh, backend: str):
    """(params, mask) → scalar loss of a local ``loss_and_acc`` (this
    rank's rows; global-view under the constraint backend), its parameter
    leaves passed through :class:`_SumGrads`, so that the gradients
    autograd takes through it are summed over the ranks: :func:`sum_grads`
    (explicit) or ``constraint.reduce_grads``."""
    if backend == "constraint":
        def loss_fn(params, mask):
            leaves = _SumGrads.apply(
                lambda gs: K.reduce_grads(gs, mesh),
                lambda t: K.replicated_params(t, mesh), *tree_leaves(params))
            with K.mesh_context(mesh):
                loss, _ = loss_and_acc(tree_unflatten(params, leaves), mask)
            return loss.to_local()
    else:
        def loss_fn(params, mask):
            leaves = _SumGrads.apply(lambda gs: sum_grads(gs, mesh),
                                     lambda t: t.view_as(t),
                                     *tree_leaves(params))
            loss, _ = loss_and_acc(tree_unflatten(params, leaves), mask)
            return loss

    return loss_fn


def make_tp_train_fns(cfg: M.GNNConfig, bundle: TPBundle, mesh: TPMesh,
                      optimizer, mode: str = "decoupled_pipelined",
                      agg=None, data_axes=None, backend: str = "explicit"):
    """(train_step, evaluate) for TP training.

    ``train_step(params, opt_state) → (params, opt_state, loss)``;
    ``evaluate(params, split) → (loss, acc)`` over the ``"train"``,
    ``"val"`` or ``"test"`` mask.  ``mode`` ∈ {decoupled,
    decoupled_pipelined, naive}; ``agg=None`` uses the bundle's backend;
    ``data_axes=None`` derives the replica axes from ``mesh`` (hybrid
    DP×TP on a :func:`repro_torch.runtime.hybrid_mesh`), ``()`` forces
    pure TP; ``backend`` ∈ {explicit, constraint}."""
    mesh = mesh.for_data_axes(data_axes)
    return train_fns(
        _make_local_loss(cfg, bundle, mesh, mode, agg, backend), mesh,
        optimizer, bundle.masks(), backend)
