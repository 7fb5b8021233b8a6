"""Out-of-core chunk streaming: host-resident features, a two-item device
buffer (the paper's memory-efficient task scheduling, §4.2).

The in-memory engine (:mod:`repro_torch.core.decouple`) keeps every input
on the device, so the graph must fit there.  This module is the
out-of-core spelling of the same decoupled epoch: the feature matrix and
the per-chunk aggregation inputs stay in host memory, pinned when they
feed a card (:class:`repro_torch.graph.format.HostFeatureStore`, the
builders in :mod:`repro_torch.core.chunks`), and the epoch walks them
through a double-buffered prefetch (:mod:`repro_torch.runtime.streaming`):
while the compute stream works on staged item ``c``, item ``c+1``'s copy
runs on a copy stream.  A rank holds at most two staged stripes and two
staged chunk inputs, plus the O(V·C/N) buffers tensor parallelism needs
whatever the graph's size.

One epoch on each rank, in seven steps:

  1. the NN phase over the stripes of this rank's rows, into H (V/N, C);
  2. split — the paper's all-to-all (vertex- → dim-sharded);
  3. L·C chunk aggregations forward, each round into a fresh z buffer;
  4. gather + masked loss + the stacked loss psum; dL/dz by autograd;
  5. L·C transposed chunk aggregations (the propagation is linear in z,
     so the backward needs no stored activations);
  6. the split's transpose, the gather all-to-all on the cotangent, run
     by hand and recorded as the split's backward
     (:func:`repro_torch.runtime.telemetry.backward_scope`);
  7. the NN phase recomputed per stripe, its parameter gradients taken
     by autograd and accumulated; one gradient all-reduce.

One step's collective ledger equals the in-memory ``decoupled`` step's
(a split and a gather with their backward calls, the stacked loss psum
and ``grad_psum``); its ``h2d`` entries equal :func:`expected_h2d_bytes`.

How it differs from the reference (``repro.core.stream``):

* ``blocksparse`` stages compressed rows (:class:`repro_torch.kernels.spmm
  .HalfPlan`), built once on the host, not dense tiles: at the
  reddit_like scale a chunk's tiles are ~2.1 GB a direction against
  ~8 MB of compressed rows.  Its h2d bytes differ from the reference's
  for that reason; ``segment`` and ``dense`` stage the same bytes.
* Each rank stages only its own block of a stripe
  (:meth:`HostFeatureStore.rank_block`), what the reference's placement
  hands each worker; the reference records the whole stripe per process.
* Both engine backends run the epoch, as in the reference.  Under
  ``backend="constraint"`` steps 1, 2, 4, 6 and 7 are global-view
  (:mod:`repro_torch.runtime.constraint`): the NN phase and its recompute
  on DTensor stripes laid out on the model axis, the split and the
  split's transpose as :func:`repro_torch.core.tp.split_constraint` /
  :func:`~repro_torch.core.tp.gather_constraint` transitions through the
  same choke point, the loss on ``gather_constraint``, and the gradient
  reduction left to ``constraint.replicate``; the chunk rounds (3, 5) run
  no collective and are shared.  Its ledger equals the explicit epoch's
  but for the loss and gradient reductions, which are DTensor's.  A hybrid
  DP×TP mesh raises the reference's gate on either backend: the stripe
  slicing is pure-TP vertex-sharded.

``decoupled_pipelined`` is accepted as an alias of ``decoupled``, as in
the reference: under streaming the asynchronous copies give the overlap
§4.2.2's chunk interleaving exists for.

Scope gates (the reference's errors, not silent fallbacks): GAT (its
attention needs the full embedding matrix before the split, which the
stripe loop never holds) and ``mode="naive"`` (the coupled baseline
re-splits every layer; nothing to stream).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..gnn import models as M
from ..graph import format as gf
from ..graph.synthetic import GraphData
from ..kernels import spmm as SP
from ..params import tree_leaves, tree_map, tree_unflatten
from ..runtime import constraint as K
from ..runtime import distributed as dist
from ..runtime import streaming as RS
from ..runtime import telemetry as T
from ..runtime.mesh import TPMesh, padded_size
from . import agg as AGG
from . import chunks as CH
from . import decouple as DC
from . import tp

STREAM_MODES = ("decoupled", "decoupled_pipelined")


# ---------------------------------------------------------------------------
# Host-side preparation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamBundle:
    """Host-resident training bundle for the out-of-core path.

    The big members (``store``, ``chunked``, ``half_plans``,
    ``dense_rows``) stay on the host, pinned when ``device`` is a card;
    the epoch stages them one item at a time.  Only the O(V) label and
    mask vectors are placed on ``device`` up front: over all vertices
    (each rank reads its rows, as in the in-memory bundle) or, prepared
    with ``mesh=``, this rank's block ``block = (index, count)`` of
    them."""

    store: gf.HostFeatureStore     # (n_padded, in_dim_padded) host f32
    chunked: gf.ChunkedGraph       # host numpy per-chunk edge arrays
    half_plans: list | None        # per chunk (forward, transposed) HalfPlan
    dense_rows: torch.Tensor | None  # (C, chunk_size, n_padded) host f32
    labels: torch.Tensor           # (n_padded,) int64 on device (pad 0)
    train_mask: torch.Tensor       # (n_padded,) f32 on device
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    device: torch.device
    n: int
    n_padded: int
    n_workers: int
    n_chunks: int
    n_stripes: int
    num_classes: int
    c_padded: int
    in_dim_padded: int
    agg: str
    block: tuple[int, int] | None = None

    @property
    def chunk_size(self) -> int:
        return self.chunked.chunk_size

    @property
    def stripe_rows(self) -> int:
        return self.store.stripe_rows

    def masks(self) -> dict:
        return {"train": self.train_mask, "val": self.val_mask,
                "test": self.test_mask}


def prepare_stream_bundle(data: GraphData, n_workers: int | None = None,
                          n_chunks: int = 4, n_stripes: int | None = None,
                          agg: str = "segment", agg_block_size: int = 128,
                          device="cuda", mesh: TPMesh | None = None
                          ) -> StreamBundle:
    """Host-side prep for streaming on ``n_workers`` TP ranks: pad, chunk,
    build the host stores (pinned when ``device`` is a card).  ``mesh=``
    derives ``n_workers`` from a pure-TP mesh (a hybrid one raises the
    reference's gate) and places the labels and masks per rank, as the
    reference's ``P(axis)`` placement does; the host feature store stays
    host-side either way.

    ``n_stripes`` (default ``n_chunks``) slices the NN phase; the vertex
    dim pads to a multiple of ``n_workers · lcm(n_chunks, n_stripes)`` so
    both the chunk and the stripe grids are rectangular — with the default
    it is the in-memory ``prepare_bundle``'s padding.  ``agg`` builds the
    backend's per-chunk data: half plans of block size
    ``agg_block_size`` (``"blocksparse"``, one chunk's tiles at a time,
    compressed on the host) or dense rows (``"dense"``)."""
    if mesh is not None:
        if mesh.data_axes:
            raise ValueError(
                f"prepare_stream_bundle: hybrid DP×TP meshes (data axes "
                f"{mesh.data_axes}) are not streamable — the stripe "
                f"slicing contract is pure-TP vertex-sharded.  Use a "
                f"pure-TP mesh (runtime.TPMesh()) or the in-memory "
                f"prepare_bundle path.")
        if n_workers is None:
            n_workers = mesh.size
        elif n_workers != mesh.size:
            raise ValueError(
                f"prepare_stream_bundle: n_workers={n_workers} but the "
                f"mesh model degree is {mesh.size}")
    elif n_workers is None:
        raise TypeError("prepare_stream_bundle needs n_workers= (or mesh= "
                        "to derive it)")
    n_stripes = n_chunks if n_stripes is None else n_stripes
    if n_stripes < 1 or n_chunks < 1:
        raise ValueError("n_chunks and n_stripes must be >= 1")
    AGG.validate_backend(agg)
    device = torch.device(device)

    g = data.graph
    n_padded = padded_size(g.n, n_workers * math.lcm(n_chunks, n_stripes))
    gp = DC._pad_graph(g, n_padded)
    cg = gf.chunk_graph(gp, n_chunks)

    half_plans = dense_rows = None
    if agg == "blocksparse":
        half_plans = RS.pinned(
            CH.host_half_plans(gp, n_chunks, agg_block_size), device)
    elif agg == "dense":
        _, dense_rows = AGG.build_chunk_plans(gp, n_chunks, "dense",
                                              agg_block_size, device="cpu")
        dense_rows = RS.pinned(dense_rows, device)

    in_dim = data.features.shape[1]
    in_dim_padded = padded_size(in_dim, n_workers)
    c_padded = padded_size(data.num_classes, n_workers)

    feats = np.zeros((n_padded, in_dim_padded), np.float32)
    feats[: g.n, :in_dim] = data.features
    store = gf.HostFeatureStore(RS.pinned(torch.from_numpy(feats), device),
                                n_workers, n_stripes)
    labels = np.zeros((n_padded,), np.int64)
    labels[: g.n] = data.labels

    def place(a):
        if mesh is None:
            return torch.from_numpy(a).to(device)
        return dist.put_global(a, mesh, (mesh.axis,), device)

    def pad_mask(m):
        out = np.zeros((n_padded,), np.float32)
        out[: g.n] = m.astype(np.float32)
        return place(out)

    return StreamBundle(
        store=store, chunked=cg, half_plans=half_plans,
        dense_rows=dense_rows, labels=place(labels),
        train_mask=pad_mask(data.train_mask),
        val_mask=pad_mask(data.val_mask),
        test_mask=pad_mask(data.test_mask), device=device,
        n=g.n, n_padded=n_padded, n_workers=n_workers,
        n_chunks=n_chunks, n_stripes=n_stripes,
        num_classes=data.num_classes, c_padded=c_padded,
        in_dim_padded=in_dim_padded, agg=agg,
        block=None if mesh is None else (mesh.index, mesh.size))


def stream_gnn_config(data: GraphData, sb: StreamBundle,
                      model: str = "gcn", hidden_dim: int = 64,
                      num_layers: int = 2,
                      gamma: float = 1.0) -> M.GNNConfig:
    """GNN config padded for the stream bundle's TP degree."""
    return M.GNNConfig(
        model=model, in_dim=sb.in_dim_padded,
        hidden_dim=padded_size(hidden_dim, sb.n_workers),
        num_classes=sb.c_padded, num_layers=num_layers, gamma=gamma)


# ---------------------------------------------------------------------------
# H2D accounting (the analytic side of the ledger's h2d entries)
# ---------------------------------------------------------------------------

def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in RS.tree_tensors(tree))


def _chunk_inputs(sb: StreamBundle, agg: str, transposed: bool,
                  gamma: float) -> list:
    build = CH.host_chunk_inputs_t if transposed else CH.host_chunk_inputs
    return [build(agg, c, chunked=sb.chunked, plans=sb.half_plans,
                  dense_rows=sb.dense_rows, gamma=gamma)
            for c in range(sb.n_chunks)]


def chunk_input_nbytes(sb: StreamBundle, *, transposed: bool = False,
                       gamma: float = 1.0) -> list[int]:
    """Host bytes of each chunk's staged (forward or transposed) inputs:
    the edge arrays (``segment``), the half plan's compressed rows
    (``blocksparse``) or the dense rows (``dense``)."""
    return [_tree_nbytes(x)
            for x in _chunk_inputs(sb, sb.agg, transposed, gamma)]


def expected_h2d_bytes(sb: StreamBundle, cfg: M.GNNConfig) -> int:
    """Bytes ONE RANK stages in one epoch (forward + backward):

    * its block of every stripe twice — once for the NN phase, once for
      the per-stripe recompute of the gradients — = 2 · store bytes / N;
    * every chunk's forward inputs once per round (L), whole on every
      rank (each rank aggregates its feature slice over all the rows);
    * every chunk's transposed inputs once per backward round (L).

    The reference records the whole stripe per process, so at N ranks the
    two differ in the stripes' term; at N=1 the ``segment`` and ``dense``
    figures equal the reference's.  Labels and masks are placed at
    prepare time and the z/H buffers are allocated on the device
    (``global_zeros``): neither crosses the host link per epoch."""
    gamma = 1.0 if cfg.model == "gat" else cfg.gamma
    return (2 * sb.n_stripes * sb.store.rank_block_nbytes
            + cfg.num_layers * sum(chunk_input_nbytes(sb, gamma=gamma))
            + cfg.num_layers * sum(chunk_input_nbytes(sb, transposed=True,
                                                      gamma=gamma)))


def device_resident_bytes(sb: StreamBundle, cfg: M.GNNConfig,
                          depth: int = 2) -> dict:
    """The footprint contract, itemized in bytes per rank:

    * ``staged_stripe_bytes`` / ``staged_chunk_bytes`` — the ≤ ``depth``
      staged items alive at once, which do not grow with V for a fixed
      item size.  (The transposed half plan's row pointers do: a
      ``blocksparse`` chunk's transposed rows are all V vertices, 4 bytes
      each.)
    * ``working_bytes`` — the two dim-sharded (V, C_pad/N) embedding
      buffers (current and next round) plus the labels (int64) and the
      three masks: the O(V·C/N) state tensor parallelism itself needs."""
    fwd = max(chunk_input_nbytes(sb, gamma=cfg.gamma), default=0)
    bwd = max(chunk_input_nbytes(sb, transposed=True, gamma=cfg.gamma),
              default=0)
    return {
        "staged_stripe_bytes": depth * sb.store.rank_block_nbytes,
        "staged_chunk_bytes": depth * max(fwd, bwd),
        "working_bytes": 2 * sb.n_padded * (sb.c_padded // sb.n_workers)
        * 4 + sb.n_padded * (8 + 3 * 4),
    }


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _resolve_stream_agg(sb: StreamBundle, agg: str | None) -> str:
    if agg is None:
        return sb.agg
    AGG.validate_backend(agg)
    if agg == "blocksparse" and sb.half_plans is None:
        raise ValueError(
            'agg="blocksparse" requested but the stream bundle carries '
            'no tile plans — re-run prepare_stream_bundle with '
            'agg="blocksparse"')
    if agg == "dense" and sb.dense_rows is None:
        raise ValueError(
            'agg="dense" requested but the stream bundle carries no '
            'dense rows — re-run prepare_stream_bundle with agg="dense"')
    return agg


def _check_streamable(cfg: M.GNNConfig, sb: StreamBundle,
                      mode: str) -> None:
    if cfg.model == "gat":
        raise ValueError(
            "streaming does not support GAT: its attention weights are "
            "computed at runtime from the full embedding matrix before "
            "the split (an O(V) all-gather the stripe loop cannot see), "
            "so the per-stripe NN phase is not independent.  Use the "
            "in-memory path (core.decouple) for GAT.")
    if mode not in STREAM_MODES:
        raise ValueError(
            f"stream mode must be one of {STREAM_MODES} (got {mode!r}); "
            f"the coupled 'naive' baseline re-splits every layer and has "
            f"no host-resident phase to stream — use core.decouple for "
            f"it.  'decoupled_pipelined' is an alias of 'decoupled' "
            f"here: the async H2D prefetch provides the overlap §4.2.2's "
            f"manual chunk interleaving exists for.")
    if cfg.num_classes != sb.c_padded:
        raise ValueError(
            f"cfg.num_classes={cfg.num_classes} must equal the bundle's "
            f"padded class dim {sb.c_padded} (build cfg via "
            f"stream_gnn_config / decouple.padded_gnn_config)")
    if cfg.in_dim != sb.in_dim_padded:
        raise ValueError(
            f"cfg.in_dim={cfg.in_dim} must equal the bundle's padded "
            f"input dim {sb.in_dim_padded}")


# ---------------------------------------------------------------------------
# Per-chunk aggregation, forward and transposed (no collectives)
# ---------------------------------------------------------------------------

def _chunk_fwd(agg: str, z, xs, cs: int, scale: float) -> torch.Tensor:
    """Chunk rows (cs, width) of Â·z."""
    if agg == "blocksparse":
        out = SP.spmm_half(xs, z)[:cs]
        return out if scale == 1.0 else scale * out
    return AGG.chunk_agg(agg, z, xs, cs, scale)


def _chunk_bwd(agg: str, ct_c, xs_t, g, scale: float) -> None:
    """``g += Â_cᵀ @ ct_c``, the transpose of one chunk's aggregation."""
    if agg == "segment":
        src, dst_local, w = xs_t
        # pad edges carry dst_local == cs → the appended zero row, and
        # w == 0: inert, as in the forward
        ct_ext = torch.cat([ct_c, ct_c.new_zeros(1, ct_c.shape[1])])
        g.index_add_(0, src, ct_ext.index_select(0, dst_local) * w[:, None])
    elif agg == "blocksparse":
        g.add_(SP.spmm_half(xs_t, ct_c)[: g.shape[0]], alpha=scale)
    else:
        g.add_(xs_t.T @ ct_c, alpha=scale)


# ---------------------------------------------------------------------------
# The epoch
# ---------------------------------------------------------------------------

def make_stream_value_and_grad(cfg: M.GNNConfig, sb: StreamBundle,
                               mesh: TPMesh, mode: str = "decoupled",
                               backend: str = "explicit",
                               agg: str | None = None):
    """Out-of-core (params, mask) → (loss, grads): the streaming analog of
    :func:`repro_torch.core.decouple.make_tp_value_and_grad`.

    ``mask`` is over all vertices, on the bundle's device; the grads are
    summed across ranks.  Loss and grads match the in-memory decoupled
    step to float tolerance, and the ledger the in-memory ``decoupled``
    step's (module docstring).  The host chunk inputs are built, and
    pinned for a card, once here."""
    if backend not in DC.BACKENDS:
        raise ValueError(
            f"stream backend must be 'explicit' or 'constraint', "
            f"got {backend!r}")
    if mesh.data_axes:
        raise ValueError(
            f"make_stream_value_and_grad: hybrid DP×TP meshes (data axes "
            f"{mesh.data_axes}) are not streamable — the stripe slicing "
            f"contract is pure-TP vertex-sharded.  Use a pure-TP mesh "
            f"(runtime.TPMesh()) or the in-memory prepare_bundle path.")
    agg = _resolve_stream_agg(sb, agg)
    _check_streamable(cfg, sb, mode)
    if mesh.size != sb.n_workers:
        raise ValueError(
            f"stream bundle prepared for n_workers={sb.n_workers} but the "
            f"mesh has {mesh.size} ranks — re-run prepare_stream_bundle "
            f"with n_workers={mesh.size}")
    dev, rank = sb.device, mesh.index
    V, N, cs, rs = sb.n_padded, sb.n_workers, sb.chunk_size, sb.stripe_rows
    cp, width = cfg.num_classes, cfg.num_classes // sb.n_workers
    scale = 1.0 if agg == "segment" else cfg.gamma
    mine = DC.local_rows(V, mesh, sb.block)
    labels = mine(sb.labels)
    fwd_in = RS.pinned(_chunk_inputs(sb, agg, False, cfg.gamma), dev)
    bwd_in = RS.pinned(_chunk_inputs(sb, agg, True, cfg.gamma), dev)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(x, label):
        return RS.stage(x, dev, label=label, copy_stream=copy_stream)

    def stripes():
        return RS.prefetched(
            range(sb.n_stripes),
            lambda s: stage(sb.store.rank_block(s, rank), "stripe"))

    def chunks(inputs, label):
        return RS.prefetched(inputs, lambda x: stage(x, label))

    if backend == "constraint":
        return _constraint_value_and_grad(cfg, sb, mesh, agg, stripes,
                                          chunks, fwd_in, bwd_in, mine)

    def value_and_grad_fn(params, mask):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.no_grad():
            # 1. NN phase over this rank's stripe blocks
            H = RS.global_zeros((V // N, cp), dev)
            for s, item in enumerate(stripes()):
                H[s * rs:(s + 1) * rs] = M.mlp_phase(p, cfg, item.take())
            # 2. split: vertex- → dim-sharded
            z = tp.split(RS.sync_for_collectives(H), mesh)
            del H
            # 3. L rounds, chunk by chunk, each into a fresh buffer
            for _ in range(cfg.num_layers):
                z_next = RS.global_zeros((V, width), dev)
                for c, item in enumerate(chunks(fwd_in, "chunk")):
                    z_next[c * cs:(c + 1) * cs] = _chunk_fwd(
                        agg, z, item.take(), cs, scale)
                z = z_next
            del z_next
        # 4. gather + loss; dL/dz through the gather's autograd mirror
        z = RS.sync_for_collectives(z).requires_grad_()
        loss, _ = DC.global_loss_and_acc(tp.gather(z, mesh), labels,
                                         mine(mask), sb.num_classes, mesh)
        (ct,) = torch.autograd.grad(loss, z)
        del z
        with torch.no_grad():
            # 5. L transposed rounds
            for _ in range(cfg.num_layers):
                g = RS.global_zeros((V, width), dev)
                for c, item in enumerate(chunks(bwd_in, "chunk_t")):
                    _chunk_bwd(agg, ct[c * cs:(c + 1) * cs], item.take(), g,
                               scale)
                ct = g
            del g
            # 6. the split's transpose: recorded as its backward call
            with T.backward_scope():
                ct_h = tp.gather(RS.sync_for_collectives(ct), mesh)
            del ct
        # 7. per-stripe recompute of the NN phase and its grads
        leaves = tree_leaves(p)
        acc = [torch.zeros_like(t) for t in leaves]
        for s, item in enumerate(stripes()):
            h = M.mlp_phase(p, cfg, item.take())
            # GIN's eps and R-GCN's relation weights get zeros, as in
            # the in-memory step
            parts = torch.autograd.grad(
                h, leaves, grad_outputs=ct_h[s * rs:(s + 1) * rs],
                allow_unused=True, materialize_grads=True)
            for a, part in zip(acc, parts):
                a.add_(part)
        grads = DC.sum_grads(RS.sync_for_collectives(acc), mesh)
        return loss.detach(), tree_unflatten(params, grads)

    return value_and_grad_fn


def _constraint_value_and_grad(cfg: M.GNNConfig, sb: StreamBundle,
                               mesh: TPMesh, agg: str, stripes, chunks,
                               fwd_in, bwd_in, mine):
    """The epoch of :func:`make_stream_value_and_grad` on the constraint
    backend: the same seven steps, the same staging (``stripes``,
    ``chunks``) and buffers, with the stripes, H and the loss as global
    DTensors (module docstring).  ``mine`` takes this rank's rows of a
    vertex array (:func:`repro_torch.core.decouple.local_rows`)."""
    dev = sb.device
    V, N, cs, rs = sb.n_padded, sb.n_workers, sb.chunk_size, sb.stripe_rows
    cp, width = cfg.num_classes, cfg.num_classes // sb.n_workers
    scale = 1.0 if agg == "segment" else cfg.gamma
    axis = mesh.axis
    vspec, zspec = (axis, None), (None, axis)
    labels = K.from_local(mine(sb.labels), (axis,), mesh)

    def value_and_grad_fn(params, mask):
        p = K.replicated_params(params, mesh, requires_grad=True)
        with K.mesh_context(mesh), torch.no_grad():
            # 1. the NN phase over the global stripes: stripe s is
            # (N·rs, C), each rank's block of it its own rows
            H = RS.global_zeros((V // N, cp), dev)
            for s, item in enumerate(stripes()):
                h = M.mlp_phase(p, cfg, K.from_local(item.take(), vspec))
                H[s * rs:(s + 1) * rs] = K.constrain(h, vspec).to_local()
            # 2. split
            z = tp.split_constraint(
                K.from_local(RS.sync_for_collectives(H), vspec),
                axis).to_local()
            del H
            # 3. L rounds, chunk by chunk, each into a fresh buffer
            for _ in range(cfg.num_layers):
                z_next = RS.global_zeros((V, width), dev)
                for c, item in enumerate(chunks(fwd_in, "chunk")):
                    z_next[c * cs:(c + 1) * cs] = _chunk_fwd(
                        agg, z, item.take(), cs, scale)
                z = z_next
            del z_next
        # 4. gather + loss; dL/dz through the gather's autograd mirror
        z = RS.sync_for_collectives(z).requires_grad_()
        with K.mesh_context(mesh):
            loss, _ = DC.global_loss_and_acc_constraint(
                tp.gather_constraint(K.from_local(z, zspec), axis), labels,
                K.from_local(mine(mask), (axis,)), sb.num_classes)
        (ct,) = torch.autograd.grad(loss, z)
        del z
        with K.mesh_context(mesh), torch.no_grad():
            # 5. L transposed rounds
            for _ in range(cfg.num_layers):
                g = RS.global_zeros((V, width), dev)
                for c, item in enumerate(chunks(bwd_in, "chunk_t")):
                    _chunk_bwd(agg, ct[c * cs:(c + 1) * cs], item.take(), g,
                               scale)
                ct = g
            del g
            # 6. the split's transpose: recorded as its backward call
            with T.backward_scope():
                ct_h = tp.gather_constraint(
                    K.from_local(RS.sync_for_collectives(ct), zspec), axis,
                    mirror=False).to_local()
            del ct
        # 7. per-stripe recompute; each rank's gradients are its partial
        # sums, reduced once by constraint.replicate
        leaves = tree_leaves(p)
        acc = [torch.zeros_like(t.to_local()) for t in leaves]
        with K.mesh_context(mesh):
            for s, item in enumerate(stripes()):
                h = M.mlp_phase(p, cfg, K.from_local(item.take(), vspec))
                parts = torch.autograd.grad(
                    h, leaves,
                    grad_outputs=K.from_local(ct_h[s * rs:(s + 1) * rs],
                                              vspec),
                    allow_unused=True, materialize_grads=True)
                for a, part in zip(acc, parts):
                    a.add_(part.to_local())
        grads = K.reduce_grads(RS.sync_for_collectives(acc), mesh)
        return loss.to_local().detach(), tree_unflatten(params, grads)

    return value_and_grad_fn
