"""GNN data parallelism baseline (DepComm, NeutronStar-style).

The comparison system for the paper's ablation (§5.4 "baseline+CS"): the
graph is partitioned into contiguous destination chunks, one per worker;
every aggregation needs the embeddings of *remote* in-neighbors, fetched by
an explicit halo exchange (dependency communication).  This is exactly the
workload whose imbalance (skewed edge counts, skewed halo sizes) motivates
tensor parallelism.

The halo exchange is a static, rectangular all-to-all built from
:func:`repro_torch.graph.partition.halo_plan`; per-worker arrays are padded
to the max across workers and stacked on a leading worker axis.  Every rank
builds the same bundle and takes its own partition (index ``mesh.index``):
one process per worker, L halo all-to-alls forward and L−1 backward (layer
0's input features carry no gradient).  With ``mesh=`` only that
partition's node arrays reach the rank's device (:func:`place_dp_bundle`,
or slab by slab through the staging prefetcher,
:func:`place_dp_bundle_streamed`).

On a hybrid (data, model) mesh the partitions stay on the model axis
(halo all-to-alls unchanged) while each partition's rows also shard over
the data axes: the dense updates run on 1/replicas of the rows, each layer
gathers the replica shards for the halo exchange and the aggregation and
slices back after it, and the gradients are summed over every rank.

Both engine backends run it (``backend="explicit" | "constraint"``, as in
the reference): the constraint one (:func:`dp_coupled_forward_constraint`)
on global DTensors in the stacked (k, n_local_max, ·) layout, its halo
all-to-all a transition through the same choke point.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import agg as AGG
from ..core import decouple as D
from ..graph import format as gf
from ..graph import partition as gp
from ..graph.synthetic import GraphData
from ..kernels import spmm as SP
from ..runtime import collectives as C
from ..runtime import constraint as K
from ..runtime import distributed as dist
from ..runtime import streaming as RS
from ..runtime.mesh import TPMesh, resolve_bundle_degrees
from . import layers as L
from . import models as M


@dataclasses.dataclass(frozen=True)
class DPGraph:
    """Per-worker partitioned graph, stacked+padded on the worker axis."""

    send_idx_local: torch.Tensor  # (k, k, m) int32 LOCAL row ids to send (pad -1)
    recv_pos: torch.Tensor        # (k, k, m) int32 halo slot (pad = halo_size)
    src: torch.Tensor             # (k, e_max) int32 local-coord srcs (pad 0)
    dst: torch.Tensor             # (k, e_max) int32 local dst (pad = n_local_max)
    weight: torch.Tensor          # (k, e_max) f32 (pad 0)
    valid_rows: torch.Tensor      # (k, n_local_max) f32 1 for real local vertices
    k: int
    m: int
    halo_size: int
    n_local_max: int
    e_max: int
    # aggregation backend (core.agg): per-worker tile plans ("blocksparse",
    # stacked on the worker axis) or per-worker dense rows ("dense",
    # (k, n_local_max, n_local_max + halo_size))
    agg: str = "segment"
    bsp: Any = None               # SP.BlockSparsePlanDev | None
    dense_adj: Any = None


@dataclasses.dataclass(frozen=True)
class DPBundle:
    """Node arrays over every partition, (k, n_local_max, ·), or, placed,
    over this rank's block ``block = (partition, replica, replicas)``
    only: (1, n_local_max / replicas, ·)."""

    graph: DPGraph
    features: torch.Tensor     # (k, n_local_max, d)
    labels: torch.Tensor       # (k, n_local_max) int64
    train_mask: torch.Tensor   # (k, n_local_max) f32
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    num_classes: int
    comm_rows_per_worker: np.ndarray  # analysis: rows each worker receives
    block: tuple[int, int, int] | None = None

    def masks(self) -> dict:
        return {"train": self.train_mask, "val": self.val_mask,
                "test": self.test_mask}


def _dp_block(mesh: TPMesh) -> tuple[int, int, int]:
    """(partition, replica index, replica count) of this rank."""
    rep = mesh.replicas()
    return mesh.index, C.replica_index(rep), C.replica_size(rep)


def _rank_spec(a: torch.Tensor, mesh: TPMesh) -> tuple:
    """The stacked layout's spec for node array ``a``: partitions on the
    model axis, rows over the data axes."""
    return _dp_row_spec(mesh.axis, mesh.data_axes, a.dim() - 2)


def place_dp_bundle(bundle: DPBundle, mesh: TPMesh, device=None) -> DPBundle:
    """This rank's share of ``bundle`` on ``device``: its partition of the
    node arrays, and under hybrid DP×TP its data-axis block of that
    partition's rows (:func:`repro_torch.runtime.distributed.put_global`
    in the stacked layout).  The graph structure stays replicated, as in
    the reference's ``place_dp_bundle``."""
    return dataclasses.replace(
        bundle, block=_dp_block(mesh),
        **{f: dist.put_global(getattr(bundle, f), mesh,
                              _rank_spec(getattr(bundle, f), mesh), device)
           for f in D.NODE_ARRAYS})


def place_dp_bundle_streamed(bundle: DPBundle, mesh: TPMesh, *,
                             n_slabs: int = 4, depth: int = 2,
                             device=None) -> DPBundle:
    """Streamed drop-in for :func:`place_dp_bundle`: this rank's rows of
    each node array reach ``device`` slab by slab (contiguous row ranges)
    through the double-buffered prefetcher
    (:func:`repro_torch.runtime.streaming.prefetched` and ``stage``), each
    slab recorded as one ``h2d`` ledger entry call (label ``dp_rows``), the
    graph structure as one (``dp_graph``).

    As in the reference, DP residency is already V/k rows a worker, so
    this does not shrink the footprint: it bounds the staging — no copy
    larger than one slab is in flight — and makes the placement's bytes
    measured ``h2d`` entries.  Call with the host-side bundle of
    ``prepare_dp_bundle(device="cpu")``."""
    device = torch.device(dist.rank_device() if device is None else device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None

    def stage(tree, label):
        return RS.stage(RS.pinned(tree, device), device, label=label,
                        copy_stream=copy_stream)

    graph = stage(bundle.graph, "dp_graph").take()
    placed = {}
    for f in D.NODE_ARRAYS:
        host = getattr(bundle, f)
        host = host[dist.shard_slices(host.shape, mesh,
                                      _rank_spec(host, mesh))]
        n_rows = host.shape[1]
        slab = -(-n_rows // max(1, min(n_slabs, n_rows)))
        buf = RS.global_zeros(host.shape, device, host.dtype)
        slabs = [(lo, host[:, lo:lo + slab].contiguous())
                 for lo in range(0, n_rows, slab)]
        for lo, staged in RS.prefetched(
                slabs, lambda item: (item[0], stage(item[1], "dp_rows")),
                depth=depth):
            rows = staged.take()
            buf[:, lo:lo + rows.shape[1]] = rows
        placed[f] = buf
    return dataclasses.replace(bundle, graph=graph, block=_dp_block(mesh),
                               **placed)


def prepare_dp_bundle(data: GraphData, k: int | None = None,
                      balance: str = "vertex",
                      n_replicas: int | None = None,
                      mesh: TPMesh | None = None, agg: str = "segment",
                      agg_block_size: int = 128,
                      device="cuda") -> DPBundle:
    """``k`` graph partitions (the model axis), placed on ``device``; under
    a hybrid mesh ``n_replicas`` pads each partition's row count to a
    multiple of it, so the local rows also shard over the data axes.
    ``mesh=`` derives both counts from the mesh (explicit ones must match
    it) and returns the bundle placed on it (:func:`place_dp_bundle`):
    only this rank's partition reaches ``device``.

    ``agg`` selects the default aggregation backend
    (:data:`repro_torch.core.agg.AGG_BACKENDS`): ``"blocksparse"`` builds
    one rectangular tile plan per worker (local dst rows × extended
    local+halo source rows, block size ``agg_block_size``), ``"dense"``
    the per-worker dense rows.  The segment edge lists are always built."""
    AGG.validate_backend(agg)
    if mesh is not None:
        k, n_replicas = resolve_bundle_degrees(
            mesh, k, n_replicas, caller="prepare_dp_bundle",
            worker_name="k")
    elif k is None:
        raise TypeError("prepare_dp_bundle needs k= (or mesh= to derive "
                        "it)")
    n_replicas = 1 if n_replicas is None else n_replicas
    g = data.graph
    part = gp.chunk_partition(g, k, balance=balance)
    plan = gp.halo_plan(g, part)
    n_local_max = int(plan.n_local.max())
    n_local_max = -(-n_local_max // n_replicas) * n_replicas
    e_max = max(1, max(len(s) for s in plan.local_src))

    send_local = np.full((k, k, plan.m), -1, dtype=np.int32)
    for i in range(k):
        lo = part.bounds[i]
        sel = plan.send_idx[i] >= 0
        send_local[i][sel] = plan.send_idx[i][sel] - lo

    ext = n_local_max + plan.halo_size
    src = np.zeros((k, e_max), np.int32)
    dst = np.full((k, e_max), n_local_max, np.int32)
    wgt = np.zeros((k, e_max), np.float32)
    valid = np.zeros((k, n_local_max), np.float32)
    worker_plans = [] if agg == "blocksparse" else None
    dense_rows = (np.zeros((k, n_local_max, ext), np.float32)
                  if agg == "dense" else None)
    feats = np.zeros((k, n_local_max, data.features.shape[1]), np.float32)
    labels = np.zeros((k, n_local_max), np.int64)
    masks = {name: np.zeros((k, n_local_max), np.float32)
             for name in ("train", "val", "test")}
    for i in range(k):
        e_i = len(plan.local_src[i])
        n_i = int(plan.n_local[i])
        src[i, :e_i] = plan.local_src[i]
        # clamp halo coords into the padded layout: local rows sit in
        # [0, n_local_max), halo rows in [n_local_max, n_local_max+halo)
        halo_sel = plan.local_src[i] >= n_i
        src[i, :e_i][halo_sel] += n_local_max - n_i
        dst[i, :e_i] = plan.local_dst[i]
        wgt[i, :e_i] = plan.local_w[i]
        valid[i, :n_i] = 1.0
        # per-worker aggregation plans use the same clamped coordinates
        # the segment path indexes with: dst over the padded local rows,
        # src over the extended [local | halo] rows
        if worker_plans is not None:
            worker_plans.append(gf.rect_block_sparse(
                dst[i, :e_i], src[i, :e_i], wgt[i, :e_i],
                n_rows=n_local_max, n_cols=ext, bs=agg_block_size))
        if dense_rows is not None:
            np.add.at(dense_rows[i], (dst[i, :e_i], src[i, :e_i]),
                      wgt[i, :e_i])
        lo, hi = part.bounds[i], part.bounds[i + 1]
        feats[i, :n_i] = data.features[lo:hi]
        labels[i, :n_i] = data.labels[lo:hi]
        masks["train"][i, :n_i] = data.train_mask[lo:hi]
        masks["val"][i, :n_i] = data.val_mask[lo:hi]
        masks["test"][i, :n_i] = data.test_mask[lo:hi]

    def dev(a):
        return torch.from_numpy(a).to(device)

    # with a mesh the node arrays stay on the host until placed
    node_dev = "cpu" if mesh is not None else device

    def node(a):
        return torch.from_numpy(a).to(node_dev)

    graph = DPGraph(
        send_idx_local=dev(send_local), recv_pos=dev(plan.recv_pos),
        src=dev(src), dst=dev(dst), weight=dev(wgt), valid_rows=dev(valid),
        k=k, m=plan.m, halo_size=plan.halo_size,
        n_local_max=n_local_max, e_max=e_max, agg=agg,
        bsp=(SP.block_sparse_plan_dev(gf.stack_plans(worker_plans), device)
             if worker_plans is not None else None),
        dense_adj=dev(dense_rows) if dense_rows is not None else None)
    bundle = DPBundle(graph=graph, features=node(feats),
                      labels=node(labels), train_mask=node(masks["train"]),
                      val_mask=node(masks["val"]),
                      test_mask=node(masks["test"]),
                      num_classes=data.num_classes,
                      comm_rows_per_worker=(plan.send_idx >= 0).sum(
                          axis=(0, 2)))
    return bundle if mesh is None else place_dp_bundle(bundle, mesh, device)


# ---------------------------------------------------------------------------
# Halo exchange + aggregation (per rank)
# ---------------------------------------------------------------------------

def _halo_send(h_local: torch.Tensor, g: DPGraph, i: int) -> torch.Tensor:
    """Worker ``i``'s (k, m, D) send buffer: block j holds the rows worker
    j needs, zeros in the pads."""
    send_rows = g.send_idx_local[i]                      # (k, m) local ids
    valid = (send_rows >= 0).reshape(-1, 1)
    send = h_local.index_select(0, torch.where(send_rows >= 0, send_rows,
                                               0).reshape(-1))
    return torch.where(valid, send, 0.0).reshape(g.k, g.m, -1)


def _halo_land(recv: torch.Tensor, g: DPGraph, i: int) -> torch.Tensor:
    """The (k, m, D) rows worker ``i`` received, landed in its halo
    buffer: (halo_size+1, D), the last row a dump row for the pads."""
    d = recv.shape[-1]
    pos = g.recv_pos[i].reshape(-1).long()               # (k*m,)
    halo = recv.new_zeros(g.halo_size + 1, d)
    return halo.index_copy(0, pos, recv.reshape(-1, d))


def halo_exchange(h_local: torch.Tensor, g: DPGraph,
                  mesh: TPMesh) -> torch.Tensor:
    """DepComm: fetch remote in-neighbor rows.  Returns (halo_size+1, D),
    the last row a dump row for the pads.  When ``h_local`` carries no
    gradient (layer 0's input features) autograd runs no backward
    all-to-all for it, and the ledger counts none."""
    i = mesh.index
    recv = C.all_to_all(_halo_send(h_local, g, i), mesh.group, split_axis=0,
                        concat_axis=0, axis=mesh.axis)
    # recv[j] = rows worker j sent me; land them in my halo buffer
    return _halo_land(recv, g, i)


def _local_aggregate(h_ext: torch.Tensor, g: DPGraph, i: int,
                     agg: str) -> torch.Tensor:
    """Worker ``i``'s rows of Â·[local | halo]: (n_local_max, D)."""
    if agg == "blocksparse":
        return SP.aggregate_plan(g.bsp.instance(i), h_ext)[: g.n_local_max]
    if agg == "dense":
        return g.dense_adj[i] @ h_ext
    return L.aggregate_chunk(h_ext, g.src[i], g.dst[i], g.weight[i],
                             g.n_local_max)


def dp_aggregate(h_local: torch.Tensor, g: DPGraph, mesh: TPMesh,
                 agg: str = "segment") -> torch.Tensor:
    """One full aggregation round: halo exchange + local weighted SpMM on
    this worker's (n_local_max, n_local_max + halo_size) slice of Â.  The
    halo exchange — the only communication — is the same for every
    backend."""
    halo = halo_exchange(h_local, g, mesh)[:-1]          # drop the dump row
    return _local_aggregate(torch.cat([h_local, halo]), g, mesh.index, agg)


def dp_coupled_forward(params, cfg: M.GNNConfig, g: DPGraph, x_local,
                       mesh: TPMesh, agg: str = "segment"):
    """Classic coupled data-parallel GCN: per layer a halo exchange, the
    local aggregation and the dense update on this worker's rows.

    Hybrid DP×TP (``mesh`` has data axes): ``x_local`` holds only this
    replica's block of the
    partition's rows; each layer gathers the replica shards (the halo
    exchange and the aggregation need every local row), then slices back
    so the dense update runs on 1/replicas of the rows.  Layer 0's gather
    moves the input features: no backward."""
    rep = mesh.replicas()
    h = x_local
    for i, p in enumerate(params["layers"]):
        h_full = C.replica_gather(h, rep, mirror=i > 0)
        a = C.replica_slice(dp_aggregate(h_full, g, mesh, agg), rep)
        h = L.dense(p, a)
        if i < cfg.num_layers - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Global-view forward for the constraint backend
# ---------------------------------------------------------------------------

def _dp_row_spec(axis: str, data_axes: tuple[str, ...],
                 trailing: int = 1) -> tuple:
    """Spec of the stacked DP layout (k, n_local_max, ...): partitions on
    the model axis, local rows on the data axes (hybrid) or unsharded."""
    row_entry = tuple(data_axes) if data_axes else None
    return (axis, row_entry) + (None,) * trailing


def _halo_exchange_constraint(h, g: DPGraph, mesh: TPMesh, *,
                              mirror: bool = True):
    """Global-view DepComm: (k, n_local_max, D) → (k, halo_size, D).

    The send buffers form one (k, k, m, D) tensor, ``[sender, receiver]``,
    laid out on the sender; its transpose is laid out on dim 1, and moving
    the model axis back to dim 0 is the halo all-to-all, run through the
    choke point by :func:`repro_torch.runtime.constraint
    .note_transition`."""
    axis, i = mesh.axis, mesh.index
    spec4 = (axis, None, None, None)
    send = K.local_map(lambda hl: _halo_send(hl[0], g, i)[None], spec4, h)
    recv = K.note_transition(send.transpose(0, 1), (None, axis),
                             spec4, mirror=mirror)
    return K.local_map(lambda r: _halo_land(r[0], g, i)[None, :-1],
                       (axis, None, None), recv)


def dp_coupled_forward_constraint(params, cfg: M.GNNConfig, g: DPGraph, x,
                                  mesh: TPMesh, agg: str = "segment"):
    """Coupled DP GCN on global DTensors: same math as
    :func:`dp_coupled_forward` on the stacked (k, n_local_max, ·) layout
    (``x`` laid out :func:`_dp_row_spec`'s; under hybrid DP×TP the rows
    shard over the data axes, and each layer's data-axis hop gathers them
    for the halo exchange and the aggregation, which run on each rank's
    partition under a ``local_map``).  Layer 0's transitions move the
    input features (``mirror=False``)."""
    axis, data_axes, i = mesh.axis, mesh.data_axes, mesh.index
    row, full = _dp_row_spec(axis, data_axes), (axis, None, None)
    h = x
    for li, p in enumerate(params["layers"]):
        mirror = li > 0
        h = K.constrain(h, row)
        if data_axes:
            h = K.layout_cast(h, full, src_spec=row, mirror=mirror)
        halo = _halo_exchange_constraint(h, g, mesh, mirror=mirror)
        a = K.local_map(
            lambda hl, hh: _local_aggregate(torch.cat([hl[0], hh[0]]), g, i,
                                            agg)[None],
            full, h, halo)
        a = K.constrain(a, row)                         # hybrid: a slice
        # DTensor has no rule for the matmul of a (k, n, D) operand whose
        # partition dim is sharded (it flattens k into the rows), so the
        # update runs on the local rows too; its parameter gradients are
        # each rank's partial sums, as everywhere (constraint.reduce_grads)
        h = K.local_map(lambda al, w, b: L.dense({"w": w, "b": b}, al),
                        row, a, p["w"], p["b"])
        if li < cfg.num_layers - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Loss / train-step factories
# ---------------------------------------------------------------------------

def _resolve_dp_axes(bundle: DPBundle, mesh: TPMesh, data_axes) -> TPMesh:
    """The mesh of the execution over ``data_axes``
    (:meth:`TPMesh.for_data_axes`), with the bundle's padding checked
    against it."""
    mesh = mesh.for_data_axes(data_axes)
    k, replicas = mesh.size, mesh.data_size
    g = bundle.graph
    if g.k != k:
        raise ValueError(
            f"DP bundle partitioned for k={g.k} workers but mesh model "
            f"degree is {k} — re-run prepare_dp_bundle with k={k}")
    if g.n_local_max % replicas:
        raise ValueError(
            f"DP bundle rows n_local_max={g.n_local_max} do not divide "
            f"the {replicas} replicas — re-run prepare_dp_bundle with "
            f"n_replicas={replicas}")
    return mesh


def _make_local_loss(cfg: M.GNNConfig, bundle: DPBundle, mesh: TPMesh,
                     agg, backend: str):
    """(params, mask) → (loss, acc) on this rank's rows of its partition,
    with ``mask`` over every partition, (k, n_local_max), or over this
    rank's block, as a placed bundle holds it; global-view under the
    constraint backend."""
    if cfg.model != "gcn":
        raise ValueError(
            f"the DP halo-exchange baseline trains GCN only, as the "
            f"reference's dp_coupled_forward does (its layers are GCN "
            f"updates); got model {cfg.model!r}")
    g = bundle.graph
    agg = AGG.resolve_choice(g, agg)
    i, rep = mesh.index, mesh.replicas()
    block = _dp_block(mesh)
    if bundle.block is not None and bundle.block != block:
        raise ValueError(
            f"DP bundle placed for (partition, replica, replicas) "
            f"{bundle.block} but this rank's execution takes {block} — "
            f"place it on the execution's mesh (prepare_dp_bundle(mesh=...)) "
            f"or prepare it without mesh=")
    rows = (1, g.n_local_max // block[2])

    def mine(a):
        """This rank's rows of partition i of a (k, n_local_max, ...), or
        of its placed block (1, n_local_max / replicas, ...)."""
        if tuple(a.shape[:2]) == rows:
            return a[0]
        return C.replica_slice(a[i], rep)

    x, labels = mine(bundle.features), mine(bundle.labels)
    valid = mine(g.valid_rows)
    if backend == "constraint":
        row, row1 = (_dp_row_spec(mesh.axis, mesh.data_axes, t)
                     for t in (1, 0))
        x, labels = K.from_local(x[None], row, mesh), \
            K.from_local(labels[None], row1, mesh)

        def global_loss(params, mask):
            logits = dp_coupled_forward_constraint(params, cfg, g, x, mesh,
                                                   agg)
            mask = K.from_local((mine(mask) * valid)[None], row1, mesh)
            return D.global_loss_and_acc_constraint(logits, labels, mask,
                                                    bundle.num_classes)

        return global_loss

    def loss_and_acc(params, mask):
        logits = dp_coupled_forward(params, cfg, g, x, mesh, agg)
        return D.global_loss_and_acc(logits, labels, mine(mask) * valid,
                                     bundle.num_classes, mesh)

    return loss_and_acc


def make_dp_value_and_grad(cfg: M.GNNConfig, bundle: DPBundle, mesh: TPMesh,
                           agg: str | None = None, data_axes=None,
                           backend: str = "explicit"):
    """(params, mask) → (loss, grads), the grads summed across ranks.
    ``agg=None`` keeps the bundle's prepared aggregation backend;
    ``data_axes=None`` derives the replica axes from ``mesh``, ``()``
    forces the pure partition-parallel baseline; ``backend`` ∈
    {explicit, constraint}."""
    mesh = _resolve_dp_axes(bundle, mesh, data_axes)
    return D.value_and_grad(
        _make_local_loss(cfg, bundle, mesh, agg, D.check_backend(backend)),
        mesh, backend)


def make_dp_loss_fn(cfg: M.GNNConfig, bundle: DPBundle, mesh: TPMesh,
                    agg: str | None = None, data_axes=None,
                    backend: str = "explicit"):
    """Differentiable (params, mask) → scalar loss over every rank's rows:
    the handle to take grads through, as the reference's
    ``make_dp_loss_fn``.  The gradients autograd takes through it are
    :func:`make_dp_value_and_grad`'s on every rank (each replicated
    parameter's share summed over the ranks in the backward,
    ``core.decouple.differentiable_loss``).  The arguments are
    :func:`make_dp_value_and_grad`'s."""
    mesh = _resolve_dp_axes(bundle, mesh, data_axes)
    return D.differentiable_loss(
        _make_local_loss(cfg, bundle, mesh, agg, D.check_backend(backend)),
        mesh, backend)


def make_dp_train_fns(cfg: M.GNNConfig, bundle: DPBundle, mesh: TPMesh,
                      optimizer, agg: str | None = None, data_axes=None,
                      backend: str = "explicit"):
    """(train_step, evaluate) for the DP baseline (GCN), with the
    signatures of :func:`repro_torch.core.decouple.make_tp_train_fns`.
    ``agg=None`` keeps the bundle's prepared aggregation backend;
    ``data_axes=None`` derives the replica axes from ``mesh`` (hybrid
    DP×TP: partition rows shard over the data axes); ``backend`` ∈
    {explicit, constraint}."""
    mesh = _resolve_dp_axes(bundle, mesh, data_axes)
    return D.train_fns(
        _make_local_loss(cfg, bundle, mesh, agg, D.check_backend(backend)),
        mesh, optimizer, bundle.masks(), backend)
