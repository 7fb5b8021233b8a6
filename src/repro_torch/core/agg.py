"""Pluggable aggregation backends for the TP engine.

The per-worker compute hot spot is full-graph aggregation ``Â @ Z`` on the
feature slice (§3.1, §4.2).  All the tensor layer's communication happens in
the split/gather all-to-alls around that multiply, so the backend choice is
pure local compute.

* ``"segment"``     — ``index_select`` + ``index_add`` over the chunked edge
                      lists.
* ``"blocksparse"`` — the SpMM kernel (:mod:`repro_torch.kernels.spmm`)
                      on precomputed (bs × bs) tile plans, read as the
                      compressed rows of their nonzeros, with an exact
                      backward through the Âᵀ tiles.

Static edge weights (GCN's normalized Â) are baked into the tiles at
prepare time; the decoupled propagation's γ is applied as a scalar
post-multiplier, since γ·(Â@z) = (γÂ)@z.
"""
from __future__ import annotations

import torch

from ..graph import format as gf
from ..gnn import layers as L
from ..kernels import spmm as SP

AGG_BACKENDS = ("segment", "blocksparse")


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
    ``"blocksparse"`` needs the plans that only
    ``prepare_bundle(agg="blocksparse")`` builds."""
    if agg is None:
        return graph.agg
    validate_backend(agg)
    if agg == "blocksparse" and graph.bsp is None:
        raise ValueError(
            'agg="blocksparse" requested but the bundle carries no tile '
            'plans — re-run prepare_bundle with agg="blocksparse"')
    return agg


def build_chunk_plans(gp: gf.Graph, n_chunks: int, agg: str, bs: int,
                      device="cuda"):
    """Per-chunk tile plans (stacked) for ``"blocksparse"``, else None."""
    validate_backend(agg)
    if agg != "blocksparse":
        return None
    return SP.block_sparse_plan_dev(
        gf.chunk_block_sparse(gp, n_chunks, bs=bs), device)


def chunk_xs(graph, agg: str, w_chunk) -> list:
    """Each chunk's aggregation inputs for the chosen backend: one plan
    instance per chunk (blocksparse) or the chunk's (src, dst_local, w)
    edge arrays (segment)."""
    if agg == "blocksparse":
        return [graph.bsp.instance(c) for c in range(graph.chunked.n_chunks)]
    cg = graph.chunked
    w = cg.weight if w_chunk is None else w_chunk
    return [(cg.src[c], cg.dst_local[c], w[c]) for c in range(cg.n_chunks)]


def chunk_agg(agg: str, z: torch.Tensor, xs, chunk_size: int,
              scale: float = 1.0) -> torch.Tensor:
    """One chunk's aggregation rows ``(chunk_size, d)`` for backend ``agg``.

    ``scale`` is a scalar post-multiplier (γ for the decoupled GCN
    propagation).  The segment backend ignores it — its per-edge weights
    already carry any scaling."""
    if agg == "blocksparse":
        out = SP.aggregate_plan(xs, z)[:chunk_size]
        return out if scale == 1.0 else scale * out
    src, dst_local, w = xs
    return L.aggregate_chunk(z, src, dst_local, w, chunk_size)
