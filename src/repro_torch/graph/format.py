"""Host-side graph containers and tile plans (numpy, built once).

The same formats as the JAX package's ``repro.graph.format``, kept as a copy
so the port imports nothing of it; for the same inputs every array here is
byte-identical to that module's (``tests/test_torch_graph.py``).

* ``Graph``          — COO sorted by destination + CSR ``indptr`` over in-edges,
                       with GCN symmetric normalization baked into ``weight``.
* ``ChunkedGraph``   — the paper's §4.2 chunk partition: contiguous destination
                       ranges with *all* their in-edges, padded to rectangular
                       arrays; padding edges point at the dump slot
                       ``chunk_size``.
* ``BlockSparseGraph`` — (dst_block × src_block) dense tiles of Â.
* ``BlockSparsePlan``  — rectangular tile plan (forward + transposed tiles)
                       for one slice of Â, stacked per §4.2 chunk by
                       ``chunk_block_sparse`` for the block-sparse SpMM
                       kernel and its exact backward through Âᵀ.
* ``HostFeatureStore`` — the host-resident feature matrix of the
                       out-of-core path, sliced into worker-major stripes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """Full graph, in-edge oriented (COO sorted by dst + CSR indptr)."""

    n: int
    src: np.ndarray       # (E,) int32, sorted by dst
    dst: np.ndarray       # (E,) int32, non-decreasing
    weight: np.ndarray    # (E,) float32 aggregation coefficients
    indptr: np.ndarray    # (n+1,) int64 CSR offsets over dst

    @property
    def e(self) -> int:
        return int(self.src.shape[0])

    def dense_adjacency(self) -> np.ndarray:
        """Dense normalized adjacency (the ``dense`` backend's rows).

        ``np.add.at``, not fancy-index ``+=``: the buffered form drops
        duplicate (dst, src) contributions, and graphs built outside
        :func:`build_graph`'s dedupe may carry parallel edges."""
        a = np.zeros((self.n, self.n), dtype=np.float32)
        np.add.at(a, (self.dst, self.src), self.weight)
        return a


def _sort_by_dst(src: np.ndarray, dst: np.ndarray):
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def build_graph(src: np.ndarray, dst: np.ndarray, n: int, *,
                add_self_loops: bool = True,
                normalization: str = "sym") -> Graph:
    """Build a :class:`Graph` with GCN-style normalized edge weights.

    normalization:
      * ``"sym"``  — 1/sqrt(deg_in(v) · deg_out(u))  (GCN, eq. 3)
      * ``"mean"`` — 1/deg_in(v)                      (GraphSAGE mean)
      * ``"none"`` — 1                                 (GIN sum)
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if add_self_loops:
        loop = np.arange(n, dtype=np.int32)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    # dedupe parallel edges
    key = dst.astype(np.int64) * n + src.astype(np.int64)
    key, uniq_idx = np.unique(key, return_index=True)
    src, dst = src[uniq_idx], dst[uniq_idx]

    src, dst = _sort_by_dst(src, dst)
    deg_in = np.bincount(dst, minlength=n).astype(np.float64)
    deg_out = np.bincount(src, minlength=n).astype(np.float64)
    if normalization == "sym":
        w = 1.0 / np.sqrt(np.maximum(deg_in[dst], 1.0)
                          * np.maximum(deg_out[src], 1.0))
    elif normalization == "mean":
        w = 1.0 / np.maximum(deg_in[dst], 1.0)
    elif normalization == "none":
        w = np.ones_like(src, dtype=np.float64)
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    return Graph(n=n, src=src, dst=dst,
                 weight=w.astype(np.float32), indptr=indptr)


# ---------------------------------------------------------------------------
# Chunked format (paper §4.2: contiguous dst ranges + all their in-edges)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkedGraph:
    """Rectangular per-chunk edge arrays.

    Padded edges carry weight 0 and point at dst slot ``chunk_size`` which is
    dropped after the per-chunk sum, so padding is numerically inert.
    """

    n: int
    n_chunks: int
    chunk_size: int            # destinations per chunk (last chunk padded)
    src: np.ndarray            # (n_chunks, max_e) int32, pad=0
    dst_local: np.ndarray      # (n_chunks, max_e) int32 in [0, chunk_size], pad=chunk_size
    weight: np.ndarray         # (n_chunks, max_e) float32, pad=0.0
    edge_id: np.ndarray        # (n_chunks, max_e) int32 id into the flat edge list (pad=E)
    # Inter-chunk pipelining (§4.2.2): srcs whose embedding slice is first
    # used by this chunk — the dedup'd per-chunk communication task.
    new_src: np.ndarray        # (n_chunks, max_new) int32, pad=-1
    new_src_count: np.ndarray  # (n_chunks,) int32


def require_int32_edge_ids(e: int) -> None:
    """Edge ids are int32 end to end and the pad value is E itself, so E
    must fit int32 *inclusive*."""
    if e >= np.iinfo(np.int32).max:
        raise ValueError(
            f"chunk_graph: edge count E={e} does not fit the int32 "
            f"edge_id contract (ids run 0..E-1 and the pad value is E, "
            f"so E must be < {np.iinfo(np.int32).max})")


def chunk_graph(g: Graph, n_chunks: int) -> ChunkedGraph:
    n = g.n
    require_int32_edge_ids(g.e)
    chunk_size = -(-n // n_chunks)
    srcs, dsts, ws, eids, news, new_counts = [], [], [], [], [], []
    seen = np.zeros(n, dtype=bool)
    max_e = 1
    max_new = 1
    for c in range(n_chunks):
        # clamp: with n_chunks ∤ n, ceil-sized chunks can overrun n;
        # trailing chunks become empty, which the padded layout represents.
        lo = min(n, c * chunk_size)
        hi = min(n, (c + 1) * chunk_size)
        e_lo, e_hi = g.indptr[lo], g.indptr[hi]
        s = g.src[e_lo:e_hi]
        d = g.dst[e_lo:e_hi] - lo
        w = g.weight[e_lo:e_hi]
        eid = np.arange(e_lo, e_hi, dtype=np.int32)
        fresh = np.unique(s[~seen[s]]) if s.size else np.empty(0, np.int32)
        seen[fresh] = True
        srcs.append(s); dsts.append(d); ws.append(w); eids.append(eid)
        news.append(fresh)
        new_counts.append(len(fresh))
        max_e = max(max_e, len(s))
        max_new = max(max_new, len(fresh))

    def pad(a, length, value, dtype):
        out = np.full(length, value, dtype=dtype)
        out[: len(a)] = a
        return out

    return ChunkedGraph(
        n=n, n_chunks=n_chunks, chunk_size=chunk_size,
        src=np.stack([pad(s, max_e, 0, np.int32) for s in srcs]),
        dst_local=np.stack(
            [pad(d, max_e, chunk_size, np.int32) for d in dsts]),
        weight=np.stack([pad(w, max_e, 0.0, np.float32) for w in ws]),
        edge_id=np.stack([pad(e, max_e, g.e, np.int32) for e in eids]),
        new_src=np.stack([pad(f, max_new, -1, np.int32) for f in news]),
        new_src_count=np.asarray(new_counts, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# Block-sparse format for the SpMM kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSparseGraph:
    """(dst_block, src_block) dense tiles of the normalized adjacency.

    ``blocks[k]`` is the dense ``(bs, bs)`` tile for the pair
    ``(block_rows[k], block_cols[k])``; pairs are sorted by ``block_rows``.
    ``row_first[k]`` is 1 iff k is the first pair of its destination block.
    """

    n: int                  # original vertex count
    n_padded: int           # padded to a multiple of bs
    bs: int                 # block size
    n_blocks: int           # n_padded // bs
    block_rows: np.ndarray  # (nnzb,) int32, non-decreasing
    block_cols: np.ndarray  # (nnzb,) int32
    row_first: np.ndarray   # (nnzb,) int32 {0,1}
    blocks: np.ndarray      # (nnzb, bs, bs) float32

    @property
    def nnzb(self) -> int:
        return int(self.block_rows.shape[0])


def _coo_tiles(dst: np.ndarray, src: np.ndarray, weight: np.ndarray,
               n_row_blocks: int, n_col_blocks: int, bs: int):
    """Dense (bs, bs) tiles of the non-empty (dst//bs, src//bs) pairs.

    ``np.add.at`` so duplicate (dst, src) entries *accumulate* — the
    buffered fancy-index ``+=`` keeps only one contribution per tile cell.
    """
    bi = dst.astype(np.int64) // bs
    bj = src.astype(np.int64) // bs
    pair = bi * n_col_blocks + bj
    uniq = np.unique(pair)
    block_rows = (uniq // n_col_blocks).astype(np.int32)
    block_cols = (uniq % n_col_blocks).astype(np.int32)
    blocks = np.zeros((len(uniq), bs, bs), dtype=np.float32)
    tile_of_edge = np.searchsorted(uniq, pair)
    np.add.at(blocks, (tile_of_edge, dst % bs, src % bs), weight)
    return block_rows, block_cols, blocks


def _finalize_tiles(block_rows: np.ndarray, block_cols: np.ndarray,
                    blocks: np.ndarray, n_row_blocks: int, bs: int):
    """Sort tiles by destination block and mark each row's first tile.

    Every destination block row gets >= 1 tile (absent rows receive an
    explicit all-zero tile), as the TPU kernel writes an out block only
    when visited."""
    present = np.zeros(n_row_blocks, dtype=bool)
    present[block_rows] = True
    missing = np.where(~present)[0].astype(np.int32)
    if len(missing):
        block_rows = np.concatenate([block_rows, missing])
        block_cols = np.concatenate(
            [block_cols, np.zeros(len(missing), np.int32)])
        blocks = np.concatenate(
            [blocks, np.zeros((len(missing), bs, bs), np.float32)])
    order = np.lexsort((block_cols, block_rows))
    block_rows, block_cols = block_rows[order], block_cols[order]
    blocks = blocks[order]
    row_first = np.ones(len(block_rows), dtype=np.int32)
    row_first[1:] = (block_rows[1:] != block_rows[:-1]).astype(np.int32)
    return block_rows, block_cols, row_first, blocks


def block_sparse(g: Graph, bs: int = 128) -> BlockSparseGraph:
    n_padded = -(-g.n // bs) * bs
    n_blocks = n_padded // bs
    rows, cols, blocks = _coo_tiles(g.dst, g.src, g.weight,
                                    n_blocks, n_blocks, bs)
    rows, cols, first, blocks = _finalize_tiles(rows, cols, blocks,
                                                n_blocks, bs)
    return BlockSparseGraph(
        n=g.n, n_padded=n_padded, bs=bs, n_blocks=n_blocks,
        block_rows=rows, block_cols=cols,
        row_first=first, blocks=blocks)


def block_sparse_transpose(bsg: BlockSparseGraph) -> BlockSparseGraph:
    """Tiles of Âᵀ, re-sorted by *source* block — the backward-pass plan."""
    rows, cols, first, blocks = _finalize_tiles(
        bsg.block_cols.copy(), bsg.block_rows.copy(),
        np.ascontiguousarray(np.swapaxes(bsg.blocks, 1, 2)),
        bsg.n_blocks, bsg.bs)
    return BlockSparseGraph(
        n=bsg.n, n_padded=bsg.n_padded, bs=bsg.bs, n_blocks=bsg.n_blocks,
        block_rows=rows, block_cols=cols, row_first=first, blocks=blocks)


# ---------------------------------------------------------------------------
# Rectangular / per-chunk block-sparse plans (forward + transpose tiles)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSparsePlan:
    """Rectangular block-sparse aggregation plan with its backward tiles.

    Forward tiles cover a (n_rows × n_cols) slice of Â; the ``*_t`` arrays
    are the transposed tiles (Âᵀ slice, sorted by source block) that the
    backward multiplies the cotangent through.  Data arrays may carry one
    leading stack axis (chunks of the §4.2 scan).
    """

    n_rows: int          # real destination rows per instance
    n_cols: int          # real source rows per instance
    rows_padded: int     # n_rows padded to a multiple of bs (kernel out)
    cols_padded: int     # n_cols padded to a multiple of bs (kernel in)
    bs: int
    block_rows: np.ndarray    # ([C,] nnzb) int32 non-decreasing
    block_cols: np.ndarray    # ([C,] nnzb) int32
    row_first: np.ndarray     # ([C,] nnzb) int32 {0,1}
    blocks: np.ndarray        # ([C,] nnzb, bs, bs) float32
    block_rows_t: np.ndarray  # transpose plan, same layout
    block_cols_t: np.ndarray
    row_first_t: np.ndarray
    blocks_t: np.ndarray

    @property
    def nnzb(self) -> int:
        return int(self.block_rows.shape[-1])

    @property
    def nnzb_t(self) -> int:
        return int(self.block_rows_t.shape[-1])


def rect_block_sparse(dst: np.ndarray, src: np.ndarray, weight: np.ndarray,
                      n_rows: int, n_cols: int, bs: int) -> BlockSparsePlan:
    """Plan for one rectangular slice ``out[dst] += w · h[src]`` with
    ``dst ∈ [0, n_rows)`` and ``src ∈ [0, n_cols)``, plus its transpose."""
    rows_padded = -(-n_rows // bs) * bs
    cols_padded = -(-n_cols // bs) * bs
    r_blocks, c_blocks = rows_padded // bs, cols_padded // bs
    fr, fc, fb = _coo_tiles(dst, src, weight, r_blocks, c_blocks, bs)
    fr, fc, ff, fb = _finalize_tiles(fr, fc, fb, r_blocks, bs)
    tr, tc, tb = _coo_tiles(src, dst, weight, c_blocks, r_blocks, bs)
    tr, tc, tf, tb = _finalize_tiles(tr, tc, tb, c_blocks, bs)
    return BlockSparsePlan(
        n_rows=n_rows, n_cols=n_cols,
        rows_padded=rows_padded, cols_padded=cols_padded, bs=bs,
        block_rows=fr, block_cols=fc, row_first=ff, blocks=fb,
        block_rows_t=tr, block_cols_t=tc, row_first_t=tf, blocks_t=tb)


def stack_plans(plans: list[BlockSparsePlan]) -> BlockSparsePlan:
    """Stack same-shape plans along a new leading axis.

    Instances are padded to the max tile count with all-zero tiles at
    (row = last row block, col = 0, row_first = 0): rows stay
    non-decreasing and the padding tiles add nothing."""
    meta = {(p.n_rows, p.n_cols, p.bs) for p in plans}
    if len(meta) != 1:
        raise ValueError(f"stack_plans needs uniform plan shapes, got {meta}")
    p0 = plans[0]

    def pad_set(rows, cols, first, blocks, m, n_row_blocks):
        k = m - len(rows)
        if k:
            rows = np.concatenate(
                [rows, np.full(k, n_row_blocks - 1, np.int32)])
            cols = np.concatenate([cols, np.zeros(k, np.int32)])
            first = np.concatenate([first, np.zeros(k, np.int32)])
            blocks = np.concatenate(
                [blocks, np.zeros((k, p0.bs, p0.bs), np.float32)])
        return rows, cols, first, blocks

    m_f = max(p.nnzb for p in plans)
    m_t = max(p.nnzb_t for p in plans)
    fwd = [pad_set(p.block_rows, p.block_cols, p.row_first, p.blocks,
                   m_f, p0.rows_padded // p0.bs) for p in plans]
    bwd = [pad_set(p.block_rows_t, p.block_cols_t, p.row_first_t, p.blocks_t,
                   m_t, p0.cols_padded // p0.bs) for p in plans]
    return dataclasses.replace(
        p0,
        block_rows=np.stack([s[0] for s in fwd]),
        block_cols=np.stack([s[1] for s in fwd]),
        row_first=np.stack([s[2] for s in fwd]),
        blocks=np.stack([s[3] for s in fwd]),
        block_rows_t=np.stack([s[0] for s in bwd]),
        block_cols_t=np.stack([s[1] for s in bwd]),
        row_first_t=np.stack([s[2] for s in bwd]),
        blocks_t=np.stack([s[3] for s in bwd]))


def chunk_plans(g: Graph, n_chunks: int,
                bs: int = 128) -> Iterator[BlockSparsePlan]:
    """Each §4.2 chunk's plan, one at a time.

    Chunk ``c`` owns destination rows ``[c·cs, (c+1)·cs)`` with all their
    in-edges; sources span the full vertex set.  Chunk bounds clamp
    identically to :func:`chunk_graph` when ``n_chunks ∤ n``."""
    cs = -(-g.n // n_chunks)
    for c in range(n_chunks):
        lo = min(g.n, c * cs)
        hi = min(g.n, (c + 1) * cs)
        e_lo, e_hi = g.indptr[lo], g.indptr[hi]
        yield rect_block_sparse(
            g.dst[e_lo:e_hi] - lo, g.src[e_lo:e_hi], g.weight[e_lo:e_hi],
            n_rows=cs, n_cols=g.n, bs=bs)


def chunk_block_sparse(g: Graph, n_chunks: int,
                       bs: int = 128) -> BlockSparsePlan:
    """:func:`chunk_plans`, stacked for the in-memory chunk loop."""
    return stack_plans(list(chunk_plans(g, n_chunks, bs)))


def pad_features(x: np.ndarray, n_padded: int) -> np.ndarray:
    """``x`` with zero rows appended up to ``n_padded`` rows."""
    if x.shape[0] == n_padded:
        return x
    out = np.zeros((n_padded,) + x.shape[1:], dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


# ---------------------------------------------------------------------------
# Host-resident feature store (out-of-core streaming, core.stream)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostFeatureStore:
    """Host-resident (n_padded, d) feature matrix, sliced into the
    worker-major stripes of the out-of-core NN phase.

    Stripe ``s`` stacks each TP worker ``i``'s rows ``[i·V/N + s·rs,
    i·V/N + (s+1)·rs)`` (``rs = V/(N·S)``): worker ``i``'s part of it is
    the contiguous block :meth:`rank_block`, which lands at rows
    ``[s·rs, (s+1)·rs)`` of the worker's (V/N, ·) buffer, so streaming
    keeps the in-memory row order.  :meth:`stripe` is the whole stripe,
    byte-equal to the reference's; each rank stages only its own block,
    which is what the reference's placement hands each worker.

    ``x`` is a CPU tensor.  A block is a view of it, so it is pinned
    when ``x`` is: the caller pins ``x`` once when the store feeds a
    card, and every copy of a block can then run asynchronously."""

    x: torch.Tensor          # (n_padded, d) CPU tensor
    n_workers: int
    n_stripes: int

    def __post_init__(self):
        n_padded = int(self.x.shape[0])
        denom = self.n_workers * self.n_stripes
        if n_padded % denom:
            raise ValueError(
                f"HostFeatureStore: n_padded={n_padded} must divide by "
                f"n_workers·n_stripes={self.n_workers}·{self.n_stripes}"
                f"={denom} for rectangular stripes — pad the vertex dim "
                f"(tp.padded_size) or pick a stripe count dividing the "
                f"per-worker block")

    @property
    def n_padded(self) -> int:
        return int(self.x.shape[0])

    @property
    def d(self) -> int:
        return int(self.x.shape[1])

    @property
    def stripe_rows(self) -> int:
        """Per-worker rows of one stripe (``rs`` above)."""
        return self.n_padded // (self.n_workers * self.n_stripes)

    @property
    def nbytes(self) -> int:
        return self.x.numel() * self.x.element_size()

    @property
    def stripe_nbytes(self) -> int:
        """Bytes of one whole stripe, all workers' blocks."""
        return self.n_workers * self.rank_block_nbytes

    @property
    def rank_block_nbytes(self) -> int:
        """Bytes of one worker's block of a stripe (what a rank stages)."""
        return self.stripe_rows * self.d * self.x.element_size()

    def _check(self, s: int) -> None:
        if not 0 <= s < self.n_stripes:
            raise IndexError(
                f"stripe {s} out of range [0, {self.n_stripes})")

    def stripe(self, s: int) -> torch.Tensor:
        """Worker-major stripe ``s``: (n_workers·stripe_rows, d)."""
        self._check(s)
        rs = self.stripe_rows
        return self.x.reshape(self.n_workers, self.n_stripes, rs,
                              self.d)[:, s].reshape(-1, self.d)

    def rank_block(self, s: int, rank: int) -> torch.Tensor:
        """Worker ``rank``'s block of stripe ``s``: rows ``[rank·V/N +
        s·rs, rank·V/N + (s+1)·rs)`` of ``x``, a view."""
        self._check(s)
        if not 0 <= rank < self.n_workers:
            raise IndexError(
                f"rank {rank} out of range [0, {self.n_workers})")
        rs = self.stripe_rows
        lo = rank * (self.n_padded // self.n_workers) + s * rs
        return self.x[lo: lo + rs]
