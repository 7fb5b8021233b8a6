"""Chunk-level communication plans + the pipelined chunk steps (§4.2.2).

The decoupled epoch needs one *split* before the L aggregation rounds and
one *gather* after them.  Inter-chunk pipelining partitions those two
collectives into per-chunk tasks so they can interleave with per-chunk
aggregation, without changing the bytes moved:

* split task of chunk c  — move the feature slices of the src vertices whose
  *first use* is chunk c (a src shared by several chunks is sent once, by
  the earliest chunk);
* gather task of chunk c — collect the complete embeddings of chunk c's
  destination vertices once its last aggregation finishes.

Plans are static rectangular index tables so each task is one all-to-all;
``-1`` pads are written to a dump row that is dropped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph import format as gf
from ..graph.format import ChunkedGraph
from ..kernels import spmm as SP
from ..runtime import collectives as C
from ..runtime.mesh import TPMesh


@dataclasses.dataclass(frozen=True)
class ChunkCommPlan:
    """Static per-chunk all-to-all row tables.

    split_rows[c, i, m]  — global vertex id whose owner is worker i and whose
                           feature slices must be sent for chunk c (pad -1).
    gather_rows[c, i, m] — global dst vertex id (owned by worker i in the
                           vertex-sharded layout) collected after chunk c
                           (pad -1).
    """

    split_rows: torch.Tensor   # (C, N, m_split) int32
    gather_rows: torch.Tensor  # (C, N, m_gather) int32
    n_workers: int
    n_padded: int              # padded vertex count (multiple of n_workers)
    m_split: int
    m_gather: int


def build_chunk_comm_plan(cg: ChunkedGraph, n_workers: int, n_padded: int,
                          device="cuda") -> ChunkCommPlan:
    shard = n_padded // n_workers
    c_rows_split: list[list[np.ndarray]] = []
    c_rows_gather: list[list[np.ndarray]] = []
    m_split, m_gather = 1, 1
    for c in range(cg.n_chunks):
        fresh = cg.new_src[c][: cg.new_src_count[c]]
        split_by_owner = [fresh[fresh // shard == i] for i in range(n_workers)]
        lo = c * cg.chunk_size
        hi = min(cg.n, (c + 1) * cg.chunk_size)
        dsts = np.arange(lo, hi, dtype=np.int32)
        gather_by_owner = [dsts[dsts // shard == i] for i in range(n_workers)]
        c_rows_split.append(split_by_owner)
        c_rows_gather.append(gather_by_owner)
        m_split = max(m_split, max(len(r) for r in split_by_owner))
        m_gather = max(m_gather, max(len(r) for r in gather_by_owner))

    def table(rows, m):
        out = np.full((cg.n_chunks, n_workers, m), -1, dtype=np.int32)
        for c, per_owner in enumerate(rows):
            for i, r in enumerate(per_owner):
                out[c, i, : len(r)] = r
        return torch.from_numpy(out).to(device)

    return ChunkCommPlan(
        split_rows=table(c_rows_split, m_split),
        gather_rows=table(c_rows_gather, m_gather),
        n_workers=n_workers, n_padded=n_padded,
        m_split=m_split, m_gather=m_gather)


# ---------------------------------------------------------------------------
# Device-side chunk collectives
# ---------------------------------------------------------------------------
#
# The scatters write into a buffer with one extra dump row that takes the
# -1 pads; callers drop it (JAX's ``.at[...].set(mode="drop")``).

def chunk_split_step(h_local: torch.Tensor, rows_c: torch.Tensor,
                     zbuf: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """Move feature slices of ``rows_c`` into the dim-sharded buffer.

    h_local : (V/N, D)     vertex-sharded embeddings (this worker's rows)
    rows_c  : (N, M)       global ids; rows_c[i] are owned by worker i (pad -1)
    zbuf    : (V + 1, D/N) dim-sharded buffer; row V is the dump row
    """
    n, i = mesh.size, mesh.index
    n_padded = zbuf.shape[0] - 1
    shard = n_padded // n
    ds = zbuf.shape[1]
    mine = rows_c[i]                              # (M,) rows I own
    valid = mine >= 0
    local = torch.where(valid, mine - i * shard, 0)
    rows = h_local.index_select(0, local)
    rows = torch.where(valid[:, None], rows, 0.0)          # (M, D)
    send = rows.reshape(rows.shape[0], n, ds).transpose(0, 1)  # (N, M, Ds)
    recv = C.all_to_all(send, mesh.group, split_axis=0, concat_axis=0,
                        axis=mesh.axis)
    # recv[j] = slices (this worker's dims) of rows owned by worker j
    ids = rows_c.reshape(-1)
    ids = torch.where(ids >= 0, ids, n_padded)            # pad → dump row
    return zbuf.index_copy(0, ids.long(), recv.reshape(-1, ds))


def chunk_gather_step(z_chunk: torch.Tensor, rows_c: torch.Tensor,
                      chunk_start: int, h_out: torch.Tensor,
                      mesh: TPMesh) -> torch.Tensor:
    """Collect complete embeddings of chunk destinations.

    z_chunk : (chunk_size, D/N)  this chunk's aggregation output (dim slice)
    rows_c  : (N, M)             global dst ids grouped by owner (pad -1)
    h_out   : (V/N + 1, D)       vertex-sharded output buffer + dump row
    """
    n, i = mesh.size, mesh.index
    shard = h_out.shape[0] - 1
    ds = z_chunk.shape[1]
    # send[j] = my dim-slice of the rows worker j owns
    valid = (rows_c >= 0).reshape(-1, 1)
    in_chunk = torch.where(rows_c >= 0, rows_c - chunk_start, 0)
    send = z_chunk.index_select(0, in_chunk.reshape(-1))
    send = torch.where(valid, send, 0.0).reshape(n, rows_c.shape[1], ds)
    recv = C.all_to_all(send, mesh.group, split_axis=0, concat_axis=0,
                        axis=mesh.axis)
    # recv[j] = worker j's dim-slice of MY rows → concat along features
    full = recv.transpose(0, 1).reshape(rows_c.shape[1], n * ds)  # (M, D)
    mine = rows_c[i]
    ids = torch.where(mine >= 0, mine - i * shard, shard)
    return h_out.index_copy(0, ids.long(), full)


# ---------------------------------------------------------------------------
# Host-side per-chunk inputs (out-of-core streaming, core.stream)
# ---------------------------------------------------------------------------
#
# The in-memory epoch keeps every chunk's aggregation inputs on the device.
# The out-of-core epoch slices one chunk's inputs out of host memory,
# stages them, consumes them and lets the buffer go; these builders are the
# one place that says what chunk c needs on the device:
#
# * segment     — (src, dst_local, γ·w) edge arrays of chunk c, byte-equal
#                 to the reference's.
# * blocksparse — a half plan: one direction of chunk c in the kernel's
#                 compressed rows.  The reference stages the chunk's dense
#                 tiles; at the reddit_like scale those are ~2.1 GB per
#                 direction against ~8 MB of compressed rows, so the port
#                 compresses once on the host (host_half_plans) and stages
#                 only the compressed rows.
# * dense       — chunk c's (chunk_size, V) adjacency rows, byte-equal.
#
# The transposed builders feed the hand-written transpose of the same
# chunk: segment reuses the edge arrays (the transpose adds by src),
# blocksparse takes the transposed half plan, dense reuses the rows
# (the transpose is rowsᵀ @ ct).


def host_half_plans(gp: gf.Graph, n_chunks: int,
                    bs: int) -> list[tuple[SP.HalfPlan, SP.HalfPlan]]:
    """Each chunk's (forward, transposed) half plan in host memory: the
    arrays ``block_sparse_plan_dev`` derives for that chunk of
    ``chunk_block_sparse``, built one chunk's tiles at a time (the stacked
    tile plan is never built)."""
    return [SP.half_plans(plan, "cpu")
            for plan in gf.chunk_plans(gp, n_chunks, bs)]


def host_chunk_inputs(agg: str, c: int, *,
                      chunked: ChunkedGraph | None = None,
                      plans: list | None = None,
                      dense_rows: torch.Tensor | None = None,
                      gamma: float = 1.0):
    """Host tensors of chunk ``c``'s forward aggregation inputs."""
    if agg == "blocksparse":
        return plans[c][0]
    if agg == "dense":
        return dense_rows[c]
    w = chunked.weight[c]
    return tuple(torch.from_numpy(a) for a in (
        chunked.src[c], chunked.dst_local[c],
        w if gamma == 1.0 else np.float32(gamma) * w))


def host_chunk_inputs_t(agg: str, c: int, *,
                        chunked: ChunkedGraph | None = None,
                        plans: list | None = None,
                        dense_rows: torch.Tensor | None = None,
                        gamma: float = 1.0):
    """Host tensors feeding the hand-written transpose of chunk ``c``'s
    aggregation (``ct_z += Â_cᵀ @ ct_out[c]``)."""
    if agg == "blocksparse":
        return plans[c][1]
    if agg == "dense":
        return dense_rows[c]
    return host_chunk_inputs("segment", c, chunked=chunked, gamma=gamma)
