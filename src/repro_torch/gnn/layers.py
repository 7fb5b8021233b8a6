"""GNN aggregation / update primitives on tensors.

The graph lives on the device as edge arrays.  Aggregation is a weighted
SpMM ``out[v] = Σ_{(u,v)∈E} w_uv · h[u]``, written here as ``index_select``
plus ``index_add``: the plain form, which the engines run where the
weights are given per step (GAT's α, which needs a gradient).  With the
graph's static weights the engines' segment backend runs the SpMM kernel
in :mod:`repro_torch.kernels.spmm` on compressed rows derived from the
chunked edges (:func:`repro_torch.core.agg.csr_plan`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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


def gat_alpha(g: EdgeListDev, sl, sr, negative_slope: float = 0.2):
    """GAT's attention α over ``g``'s edges from the (V,) score halves."""
    e = F.leaky_relu(sl.index_select(0, g.src) + sr.index_select(0, g.dst),
                     negative_slope)
    return segment_softmax(e, g.dst, sl.shape[0])


def gat_attention(params, g: EdgeListDev, h, negative_slope: float = 0.2):
    """Edge attention coefficients α_uv (eq. 5) and the transformed
    features ``h @ w``."""
    hw, sl, sr = gat_edge_scores(params, h)
    return gat_alpha(g, sl, sr, negative_slope), hw


def gat_forward(params, g: EdgeListDev, h):
    """Coupled single-head GAT layer (reference semantics): ELU of the
    α-weighted sum."""
    alpha, hw = gat_attention(params, g, h)
    return F.elu(aggregate(g, hw, alpha))


# ---------------------------------------------------------------------------
# Updates (the paper's UPDATE), model-specific aggregators, initializers
# ---------------------------------------------------------------------------

def dense(params, x):
    return x @ params["w"] + params["b"]


def gcn_update(params, a, act=torch.relu):
    return act(dense(params, a))


def sage_forward(params, g: EdgeListDev, h):
    """GraphSAGE (mean aggregator): σ(W·[h_v ‖ mean(h_u)]); the ReLU runs
    on every layer, the last one included, as in the reference."""
    neigh = aggregate(g, h)  # weights pre-normalized "mean"
    return torch.relu(torch.cat([h, neigh], dim=-1) @ params["w"]
                      + params["b"])


def gin_forward(params, g: EdgeListDev, h, eps):
    """GIN: MLP((1+ε)·h_v + Σ h_u), with no activation after ``l1``."""
    agg = aggregate(g, h)  # weights must be "none" (plain sum)
    z = (1.0 + eps) * h + agg
    return dense(params["l1"], torch.relu(dense(params["l0"], z)))


def rgcn_aggregate(g: EdgeListDev, etypes: torch.Tensor, h: torch.Tensor,
                   rel_weights: torch.Tensor) -> torch.Tensor:
    """Relation-typed aggregation: out[v] = Σ_{(u,v)∈E} w·(h_u @ W_r(u,v)).

    ``rel_weights``: (R, D, D_out).  The reference transforms every edge's
    message by every relation, an (E, R, D_out) tensor, and picks its own;
    here each vertex is transformed once per relation, (R, V, D_out), and
    each edge gathers its relation's row: the same products, without the
    E-sized intermediates.  Normalization comes from the graph weights
    ("mean")."""
    n, d_out = h.shape[0], rel_weights.shape[-1]
    hw = torch.einsum("vd,rdo->rvo", h, rel_weights).reshape(-1, d_out)
    rows = etypes.long() * n + g.src.long()
    msg = hw.index_select(0, rows) * g.weight[:, None]
    return h.new_zeros(n, d_out).index_add(0, g.dst, msg)


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
