"""GNN aggregation / update primitives on tensors.

The graph lives on the device as edge arrays.  Aggregation is a weighted
SpMM ``out[v] = Σ_{(u,v)∈E} w_uv · h[u]`` written as ``index_select`` plus
``index_add``; the block-sparse kernel in :mod:`repro_torch.kernels.spmm`
computes the same product from tiles.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..graph.format import ChunkedGraph, Graph


@dataclasses.dataclass(frozen=True)
class EdgeListDev:
    """COO edge list on the device (full graph, in-edge oriented)."""
    src: torch.Tensor      # (E,) int32
    dst: torch.Tensor      # (E,) int32
    weight: torch.Tensor   # (E,) float32
    n: int


@dataclasses.dataclass(frozen=True)
class ChunkedDev:
    """Chunked edges on the device: leading axis is the chunk (§4.2)."""
    src: torch.Tensor        # (C, max_e) int32
    dst_local: torch.Tensor  # (C, max_e) int32 (pad = chunk_size)
    weight: torch.Tensor     # (C, max_e) f32 (pad = 0)
    edge_id: torch.Tensor    # (C, max_e) int32 (pad = E)
    n: int
    chunk_size: int

    @property
    def n_chunks(self) -> int:
        return int(self.src.shape[0])


def edge_list_dev(g: Graph, device="cuda") -> EdgeListDev:
    return EdgeListDev(src=torch.from_numpy(g.src).to(device),
                       dst=torch.from_numpy(g.dst).to(device),
                       weight=torch.from_numpy(g.weight).to(device), n=g.n)


def chunked_dev(cg: ChunkedGraph, device="cuda") -> ChunkedDev:
    return ChunkedDev(src=torch.from_numpy(cg.src).to(device),
                      dst_local=torch.from_numpy(cg.dst_local).to(device),
                      weight=torch.from_numpy(cg.weight).to(device),
                      edge_id=torch.from_numpy(cg.edge_id).to(device),
                      n=cg.n, chunk_size=cg.chunk_size)


def rechunk_edge_values(cg: ChunkedDev, values: torch.Tensor) -> torch.Tensor:
    """Map a flat per-edge vector (E,) onto the chunked layout (C, max_e);
    padding slots get 0 (numerically inert in the weighted sum)."""
    ext = torch.cat([values, values.new_zeros(1)])
    return ext.index_select(0, cg.edge_id.reshape(-1)).view(cg.edge_id.shape)


# ---------------------------------------------------------------------------
# Aggregation (the paper's AGG)
# ---------------------------------------------------------------------------

def aggregate(g: EdgeListDev, h: torch.Tensor,
              edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted in-neighbor sum: works on full features or any dim slice —
    feature-dimension slicing commutes with the SpMM (the TP property)."""
    w = g.weight if edge_weight is None else edge_weight
    msg = h.index_select(0, g.src) * w[:, None]
    return h.new_zeros(h.shape).index_add(0, g.dst, msg)


def aggregate_chunk(h: torch.Tensor, src: torch.Tensor,
                    dst_local: torch.Tensor, w: torch.Tensor,
                    chunk_size: int) -> torch.Tensor:
    """One chunk's (chunk_size, d) rows; padding edges land in the dump
    slot ``chunk_size``, which is dropped."""
    msg = h.index_select(0, src) * w[:, None]
    out = h.new_zeros(chunk_size + 1, h.shape[1]).index_add(0, dst_local, msg)
    return out[:chunk_size]


def aggregate_chunked(cg: ChunkedDev, h: torch.Tensor,
                      edge_weight: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Chunk-by-chunk aggregation (paper §4.2.1): bounded working set."""
    w_all = cg.weight if edge_weight is None else edge_weight
    outs = [aggregate_chunk(h, cg.src[c], cg.dst_local[c], w_all[c],
                            cg.chunk_size) for c in range(cg.n_chunks)]
    return torch.cat(outs)[: h.shape[0]]


# ---------------------------------------------------------------------------
# GAT attention (the edge-associated NN op of the generalized decoupling)
# ---------------------------------------------------------------------------

def gat_edge_scores(params, h):
    """GAT's per-vertex attention halves: e_uv = LeakyReLU(sl[u] + sr[v]).

    Returning the two (V,) score vectors instead of per-edge values is what
    makes the paper's edge-NN precompute cheap to share: communication is
    O(V), not O(E·D)."""
    hw = h @ params["w"]
    return hw, hw @ params["a_l"], hw @ params["a_r"]


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Numerically stable softmax over in-edge groups (grouped by dst).

    The max stabiliser is detached: it cancels from the result exactly in
    math, so its gradient is zero, and detaching it sidesteps the
    different tie rules of JAX's and torch's max gradients.  The E-sized
    gathers are ``index_select``, whose backward is an ``index_add``:
    the backward of ``x[idx]`` sorts the indices first."""
    smax = scores.new_zeros(n).scatter_reduce(
        0, dst.long(), scores.detach(), "amax", include_self=False)
    ex = torch.exp(scores - smax.index_select(0, dst))
    denom = scores.new_zeros(n).index_add(0, dst, ex)
    return ex / (denom.index_select(0, dst) + 1e-16)


# ---------------------------------------------------------------------------
# Updates (the paper's UPDATE) and initializers
# ---------------------------------------------------------------------------

def dense(params, x):
    return x @ params["w"] + params["b"]


def glorot(shape, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * lim) - lim


def init_dense(generator: torch.Generator, d_in: int, d_out: int):
    return {"w": glorot((d_in, d_out), generator),
            "b": torch.zeros(d_out, dtype=torch.float32)}


def init_gat_layer(generator: torch.Generator, d_in: int, d_out: int):
    return {"w": glorot((d_in, d_out), generator),
            "a_l": glorot((d_out,), generator),
            "a_r": glorot((d_out,), generator)}
