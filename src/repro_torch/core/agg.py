"""Pluggable aggregation backends for the TP and DP engines.

The per-worker compute hot spot is full-graph aggregation ``Â @ Z`` on the
feature slice (§3.1, §4.2).  All the tensor layer's communication happens in
the split/gather all-to-alls around that multiply, so the backend choice is
pure local compute.

* ``"segment"``     — the chunked edge lists.  With the graph's own static
                      weights (GCN's, SAGE's, GIN's, R-GCN's Â) each chunk
                      runs the SpMM kernel (:mod:`repro_torch.kernels.spmm`)
                      on compressed rows derived from its edges
                      (:func:`csr_plan`), with the exact backward through
                      their transpose; weights given per step (GAT's α,
                      which needs a gradient) run ``index_select`` · w →
                      ``index_add_``.
* ``"blocksparse"`` — the same kernel on precomputed (bs × bs) tile
                      plans, read as the compressed rows of their
                      nonzeros, with an exact backward through the Âᵀ
                      tiles.
* ``"dense"``       — per-chunk dense (chunk_size × n) adjacency rows and
                      a plain ``torch.matmul``.  O(V²) memory: small graphs
                      only.

Static edge weights (GCN's normalized Â) are baked into the rows and tiles;
the decoupled propagation's γ is applied as a scalar post-multiplier,
since γ·(Â@z) = (γÂ)@z.  The backend is pure local compute: the collective
ledger is the same for every choice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import format as gf
from ..gnn import layers as L
from ..kernels import spmm as SP
from ..runtime import telemetry as T

AGG_BACKENDS = ("segment", "blocksparse", "dense")


def validate_backend(agg: str) -> str:
    if agg not in AGG_BACKENDS:
        raise ValueError(
            f"unknown aggregation backend {agg!r}; expected one of "
            f"{AGG_BACKENDS}")
    return agg


def resolve_choice(graph, agg: str | None) -> str:
    """Factory-level backend choice against a prepared bundle's graph.

    ``None`` → the backend the bundle was prepared with.  ``"segment"``
    is always available (the chunked view is always built);
    ``"blocksparse"`` and ``"dense"`` need the plans that only
    ``prepare_bundle``/``prepare_dp_bundle`` with that ``agg`` builds."""
    if agg is None:
        return graph.agg
    validate_backend(agg)
    if agg == "blocksparse" and graph.bsp is None:
        raise ValueError(
            'agg="blocksparse" requested but the bundle carries no tile '
            'plans — re-run prepare_bundle/prepare_dp_bundle with '
            'agg="blocksparse"')
    if agg == "dense" and graph.dense_adj is None:
        raise ValueError(
            'agg="dense" requested but the bundle carries no dense '
            'adjacency — re-run prepare_bundle/prepare_dp_bundle with '
            'agg="dense"')
    return agg


def build_chunk_plans(gp: gf.Graph, n_chunks: int, agg: str, bs: int,
                      device="cuda"):
    """The backend's per-chunk data on ``device``: ``(bsp, dense_adj)``,
    the stacked tile plans (``"blocksparse"``) or the (C, chunk_size, n)
    dense adjacency rows (``"dense"``), the unused slot ``None``."""
    validate_backend(agg)
    bsp = dense = None
    if agg == "blocksparse":
        bsp = SP.block_sparse_plan_dev(
            gf.chunk_block_sparse(gp, n_chunks, bs=bs), device)
    elif agg == "dense":
        cs = -(-gp.n // n_chunks)
        a = gp.dense_adjacency()
        rows = np.zeros((n_chunks, cs, gp.n), np.float32)
        for c in range(n_chunks):
            lo, hi = min(gp.n, c * cs), min(gp.n, (c + 1) * cs)
            rows[c, : hi - lo] = a[lo:hi]
        dense = torch.from_numpy(rows).to(device)
    return bsp, dense


def csr_plan(cg: L.ChunkedDev) -> SP.BlockSparsePlanDev:
    """The chunks' static-weight aggregation as the kernel's compressed
    rows, stacked over the chunks: a plan of 1 × 1 tiles.

    Each chunk's edges are sorted by destination (``chunk_graph`` cuts
    them out of the CSR graph), so its forward rows are its edge arrays as
    they are: ``row_ptr[c]`` counts its real edges per local destination
    (the padding, ``dst_local == chunk_size``, lies past ``row_ptr[c,
    -1]``), ``col_idx = cg.src`` and ``vals = cg.weight`` without a copy.
    The transposed rows, for the backward, are the chunk's real edges
    sorted stably by source: ``row_ptr_t[c]`` over the ``n`` sources,
    ``col_idx_t`` the local destination and ``vals_t`` the weight, padded
    with zeros to the chunk arrays' width.  Derived on the chunks' device;
    E × 8 bytes of transposed arrays beside the chunked view."""
    dst, src, w = cg.dst_local, cg.src, cg.weight
    if bool((dst[:, 1:] < dst[:, :-1]).any()):
        raise ValueError("csr_plan: each chunk's edges must be sorted by "
                         "destination, as chunk_graph cuts them")
    cs, n, dev = cg.chunk_size, cg.n, dst.device
    row_ptr = torch.searchsorted(
        dst, torch.arange(cs + 1, dtype=dst.dtype, device=dev)
        .expand(dst.shape[0], cs + 1).contiguous(), out_int32=True)
    sources = torch.arange(n + 1, dtype=src.dtype, device=dev)
    row_ptr_t = torch.empty(dst.shape[0], n + 1, dtype=torch.int32,
                            device=dev)
    col_idx_t, vals_t = torch.zeros_like(dst), torch.zeros_like(w)
    for c in range(dst.shape[0]):
        nnz = int(row_ptr[c, -1])
        by_src, order = torch.sort(src[c, :nnz], stable=True)
        row_ptr_t[c] = torch.searchsorted(by_src, sources, out_int32=True)
        col_idx_t[c, :nnz] = dst[c, :nnz][order]
        vals_t[c, :nnz] = w[c, :nnz][order]
    return SP.BlockSparsePlanDev(
        row_ptr=row_ptr, col_idx=src, vals=w, row_ptr_t=row_ptr_t,
        col_idx_t=col_idx_t, vals_t=vals_t, n_rows=cs, n_cols=n,
        rows_padded=cs, cols_padded=n, bs=1)


def with_csr(graph):
    """``graph`` (a ``TPGraph``) with its chunks' compressed rows of the
    static weights, one :func:`csr_plan` instance a chunk in ``csr``:
    what the segment backend aggregates a GCN-like step through."""
    plan = csr_plan(graph.chunked)
    return dataclasses.replace(
        graph, csr=[plan.instance(c) for c in range(graph.chunked.n_chunks)])


def chunk_xs(graph, agg: str, w_chunk) -> list:
    """Each chunk's aggregation inputs for the chosen backend: one plan
    instance per chunk (blocksparse, and segment with the graph's static
    weights, ``w_chunk=None``), the chunk's dense rows (dense) or its
    (src, dst_local, w) edge arrays (segment with ``w_chunk``, weights
    given per step)."""
    if agg == "blocksparse":
        return [graph.bsp.instance(c) for c in range(graph.chunked.n_chunks)]
    if agg == "dense":
        return list(graph.dense_adj)
    if w_chunk is None:
        if graph.csr is None:
            raise ValueError("chunk_xs: the segment backend's static "
                             "weights aggregate through compressed rows, "
                             "and this graph carries none: derive them "
                             "with with_csr(graph)")
        return graph.csr
    cg = graph.chunked
    return [(cg.src[c], cg.dst_local[c], w_chunk[c])
            for c in range(cg.n_chunks)]


def chunk_agg(agg: str, z: torch.Tensor, xs, chunk_size: int,
              scale: float = 1.0) -> torch.Tensor:
    """One chunk's aggregation rows ``(chunk_size, d)`` from its inputs
    ``xs`` (:func:`chunk_xs`), times the scalar post-multiplier ``scale``
    (γ for the decoupled GCN propagation; 1 where the per-edge weights
    carry it).  A plan instance runs the SpMM kernel with its exact
    backward, the dense rows a matmul, the edge arrays ``index_select`` ·
    w → ``index_add_``.  Counts the route taken
    (:func:`repro_torch.runtime.telemetry.count_agg_route`)."""
    if isinstance(xs, SP.BlockSparsePlanDev):
        T.count_agg_route("csr")
        out = SP.aggregate_plan(xs, z)[:chunk_size]
    elif agg == "dense":
        T.count_agg_route("dense")
        out = xs @ z
    else:
        T.count_agg_route("segment")
        src, dst_local, w = xs
        out = L.aggregate_chunk(z, src, dst_local, w, chunk_size)
    return out if scale == 1.0 else scale * out
