"""Graph partitioners + workload statistics.

NeutronTP itself never partitions the graph across workers — that is the
point.  These partitioners exist for (a) the data-parallel *baseline* the
paper ablates against (chunk partitioning, §5.4's "baseline"), (b) the
load-balance analysis figures (Figs. 3 & 10), and (c) the DepComm halo
exchange plan of the DP baseline.

A copy of the JAX package's ``repro.graph.partition`` (numpy only), kept
so the port imports nothing of it; for the same inputs every array here
is byte-identical to that module's (``tests/test_torch_graph.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .format import Graph


@dataclasses.dataclass(frozen=True)
class Partition:
    """Assignment of destination vertices to ``k`` workers."""

    k: int
    owner: np.ndarray        # (n,) int32 worker id per vertex
    # contiguous-chunk partitions also expose boundaries:
    bounds: np.ndarray | None = None  # (k+1,) or None for non-contiguous


def chunk_partition(g: Graph, k: int, balance: str = "vertex") -> Partition:
    """Contiguous-ID chunks (NeuGraph/ROC/NeutronStar style).

    ``balance="vertex"`` equalizes vertices per worker; ``balance="edge"``
    equalizes in-edges (a slightly fairer variant we use for comparison).
    """
    n = g.n
    if balance == "vertex":
        bounds = np.linspace(0, n, k + 1).astype(np.int64)
    elif balance == "edge":
        target = g.e / k
        csum = g.indptr[1:]  # in-edges up to vertex i inclusive
        bounds = np.searchsorted(csum, target * np.arange(1, k))
        bounds = np.concatenate([[0], bounds, [n]]).astype(np.int64)
    else:
        raise ValueError(balance)
    owner = np.zeros(n, dtype=np.int32)
    for i in range(k):
        owner[bounds[i]:bounds[i + 1]] = i
    return Partition(k=k, owner=owner, bounds=bounds)


def hash_partition(g: Graph, k: int, seed: int = 0) -> Partition:
    """Random/hash partition — balances vertices, shreds locality (the
    worst-case for DepComm communication; a METIS stand-in is below)."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, k, size=g.n).astype(np.int32)
    return Partition(k=k, owner=owner)


def greedy_edge_cut_partition(g: Graph, k: int, passes: int = 2) -> Partition:
    """Lightweight METIS stand-in: LDG-style greedy streaming partitioning
    minimizing edge cut under a capacity constraint.  Reproduces the paper's
    observation that edge-cut minimizers still leave compute/comm imbalance.
    """
    n = g.n
    cap = 1.05 * n / k
    owner = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    order = np.argsort(-np.diff(g.indptr))  # high in-degree first
    for _ in range(passes):
        for v in order:
            nbrs = g.src[g.indptr[v]:g.indptr[v + 1]]
            scores = np.zeros(k)
            placed = owner[nbrs]
            for p in placed[placed >= 0]:
                scores[p] += 1
            scores *= np.maximum(0.0, 1.0 - sizes / cap)
            best = int(np.argmax(scores)) if scores.max() > 0 else \
                int(np.argmin(sizes))
            if owner[v] >= 0:
                sizes[owner[v]] -= 1
            owner[v] = best
            sizes[best] += 1
    return Partition(k=k, owner=owner)


# ---------------------------------------------------------------------------
# Workload statistics (paper Figs. 3 & 10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadStats:
    vertices: np.ndarray        # (k,) local vertex count
    edges: np.ndarray           # (k,) in-edges of local dst (compute load)
    remote_srcs: np.ndarray     # (k,) distinct remote src vertices (comm in)
    compute_imbalance: float    # max/mean of edges
    comm_imbalance: float       # max/mean of remote_srcs

    def as_dict(self):
        return {
            "vertices": self.vertices.tolist(),
            "edges": self.edges.tolist(),
            "remote_srcs": self.remote_srcs.tolist(),
            "compute_imbalance": float(self.compute_imbalance),
            "comm_imbalance": float(self.comm_imbalance),
        }


def workload_stats(g: Graph, part: Partition) -> WorkloadStats:
    k = part.k
    vertices = np.bincount(part.owner, minlength=k).astype(np.int64)
    edges = np.zeros(k, dtype=np.int64)
    remote = np.zeros(k, dtype=np.int64)
    dst_owner = part.owner[g.dst]
    src_owner = part.owner[g.src]
    edges = np.bincount(dst_owner, minlength=k).astype(np.int64)
    cross = dst_owner != src_owner
    for w in range(k):
        sel = cross & (dst_owner == w)
        remote[w] = len(np.unique(g.src[sel]))
    mean_e = max(edges.mean(), 1e-9)
    mean_r = max(remote.mean(), 1e-9)
    return WorkloadStats(
        vertices=vertices, edges=edges, remote_srcs=remote,
        compute_imbalance=float(edges.max() / mean_e),
        comm_imbalance=float(remote.max() / mean_r))


def tensor_parallel_stats(g: Graph, k: int, d: int) -> WorkloadStats:
    """NeutronTP's workload: every worker has ALL edges × (d/k) dims and a
    V/k share of vertex comm — perfectly balanced by construction."""
    vertices = np.full(k, g.n // k, dtype=np.int64)
    edges = np.full(k, g.e, dtype=np.int64)  # on a d/k slice
    comm = np.full(k, g.n // k, dtype=np.int64)
    return WorkloadStats(vertices=vertices, edges=edges, remote_srcs=comm,
                         compute_imbalance=1.0, comm_imbalance=1.0)


# ---------------------------------------------------------------------------
# Halo exchange plan for the DP (DepComm) baseline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static all-to-all plan: which local rows each worker sends to every
    other worker, and where received rows land in the local halo buffer.

    All per-pair sets are padded to the global max count ``m`` so the
    exchange is a single rectangular ``all_to_all``:

      send_idx[i, j, :]  — local vertex ids worker i sends to worker j
                           (global ids; pad = -1 → zeros row)
      recv_pos[i, j, :]  — slot in worker i's halo buffer for rows received
                           from j (pad = halo_size → dropped)
    """

    k: int
    m: int                    # padded per-pair row count
    halo_size: int            # max distinct remote srcs over workers (padded)
    send_idx: np.ndarray      # (k, k, m) int32 global vertex ids
    recv_pos: np.ndarray      # (k, k, m) int32
    # remap of local aggregation: for each worker, its in-edge list with
    # src rewritten to [0, n_local + halo_size) local coordinates
    local_src: list           # k × (e_i,) int32
    local_dst: list           # k × (e_i,) int32 (0-based within worker)
    local_w: list             # k × (e_i,) float32
    n_local: np.ndarray       # (k,) vertices per worker


def halo_plan(g: Graph, part: Partition) -> HaloPlan:
    assert part.bounds is not None, "DP baseline uses contiguous chunks"
    k = part.k
    bounds = part.bounds
    sends: dict[tuple[int, int], np.ndarray] = {}
    halos: list[np.ndarray] = []
    local_src, local_dst, local_w = [], [], []
    n_local = np.diff(bounds).astype(np.int64)

    for i in range(k):
        lo, hi = bounds[i], bounds[i + 1]
        e_lo, e_hi = g.indptr[lo], g.indptr[hi]
        s, d, w = g.src[e_lo:e_hi], g.dst[e_lo:e_hi], g.weight[e_lo:e_hi]
        remote_mask = (s < lo) | (s >= hi)
        halo_vs = np.unique(s[remote_mask])
        halos.append(halo_vs)
        # rewrite src: local → [0, n_i), halo → n_i + rank-in-halo
        s_new = np.where(remote_mask,
                         n_local[i] + np.searchsorted(halo_vs, s),
                         s - lo).astype(np.int32)
        local_src.append(s_new)
        local_dst.append((d - lo).astype(np.int32))
        local_w.append(w.astype(np.float32))
        owner_of = part.owner[halo_vs]
        for j in range(k):
            sends[(j, i)] = halo_vs[owner_of == j]  # j sends these to i

    m = max(1, max(len(v) for v in sends.values()))
    halo_size = max(1, max(len(h) for h in halos))
    send_idx = np.full((k, k, m), -1, dtype=np.int32)
    recv_pos = np.full((k, k, m), halo_size, dtype=np.int32)
    for i in range(k):
        halo_rank = {int(v): r for r, v in enumerate(halos[i])}
        for j in range(k):
            rows = sends[(j, i)]
            send_idx[j, i, : len(rows)] = rows
            recv_pos[i, j, : len(rows)] = [halo_rank[int(v)] for v in rows]
    return HaloPlan(k=k, m=m, halo_size=halo_size,
                    send_idx=send_idx, recv_pos=recv_pos,
                    local_src=local_src, local_dst=local_dst,
                    local_w=local_w, n_local=n_local)
