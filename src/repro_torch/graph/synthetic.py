"""Synthetic graph generators (numpy, seeded).

The same generators as the JAX package's ``repro.graph.synthetic``, kept as
a copy: for the same seed every array is byte-identical to that module's
(``tests/test_torch_graph.py``).  They give the two properties the paper's
evaluation leans on: a power-law degree distribution and planted community
structure correlated with the features.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .format import Graph, build_graph


@dataclasses.dataclass(frozen=True)
class GraphData:
    graph: Graph
    features: np.ndarray    # (n, d) float32
    labels: np.ndarray      # (n,) int32
    train_mask: np.ndarray  # (n,) bool
    val_mask: np.ndarray    # (n,) bool
    test_mask: np.ndarray   # (n,) bool
    num_classes: int

    # heterogeneous graphs (R-GCN, paper §5.8): each edge's type, or None
    edge_types: np.ndarray | None = None
    num_edge_types: int = 1


def _splits(n: int, rng: np.random.Generator,
            train: float = 0.65, val: float = 0.25):
    """Paper's split for graphs without ground truth: 65/25/10."""
    perm = rng.permutation(n)
    n_tr, n_va = int(train * n), int(val * n)
    tr = np.zeros(n, bool); va = np.zeros(n, bool); te = np.zeros(n, bool)
    tr[perm[:n_tr]] = True
    va[perm[n_tr:n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return tr, va, te


def sbm_power_law(n: int = 4096, num_classes: int = 8, feat_dim: int = 64,
                  avg_degree: int = 16, p_in: float = 0.85,
                  seed: int = 0, normalization: str = "sym") -> GraphData:
    """Stochastic block model with power-law degree propensities.

    Each vertex gets a community c(v) and a Zipf-ish propensity θ_v; an edge
    endpoint pair (u, v) is sampled ∝ θ_u·θ_v, intra-community with
    probability ``p_in``.  Features are a noisy community centroid.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, size=n).astype(np.int32)
    # Zipf propensities → power-law degrees
    theta = (1.0 / np.arange(1, n + 1) ** 0.75)
    theta = theta[rng.permutation(n)]
    theta /= theta.sum()

    e_target = n * avg_degree
    src = rng.choice(n, size=e_target, p=theta)
    # choose dst: with prob p_in from same community, else anywhere
    same = rng.random(e_target) < p_in
    dst = rng.choice(n, size=e_target, p=theta).astype(np.int64)
    by_comm = [np.where(comm == c)[0] for c in range(num_classes)]
    pw = [theta[idx] / theta[idx].sum() if len(idx) else None
          for idx in by_comm]
    for c in range(num_classes):
        sel = same & (comm[src] == c)
        if sel.sum() and len(by_comm[c]):
            dst[sel] = rng.choice(by_comm[c], size=sel.sum(), p=pw[c])
    keep = src != dst
    src, dst = src[keep], dst[keep]

    centroids = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feats = centroids[comm] + 1.2 * rng.normal(
        size=(n, feat_dim)).astype(np.float32)

    g = build_graph(src.astype(np.int32), dst.astype(np.int32), n,
                    normalization=normalization)
    tr, va, te = _splits(n, rng)
    return GraphData(graph=g, features=feats, labels=comm,
                     train_mask=tr, val_mask=va, test_mask=te,
                     num_classes=num_classes)


def barabasi_albert(n: int = 4096, m: int = 8, feat_dim: int = 64,
                    num_classes: int = 8, seed: int = 0,
                    normalization: str = "sym") -> GraphData:
    """Preferential attachment: the heavy-tailed topology of the
    load-imbalance benchmarks (paper Figs. 3, 10, 11's Friendster case)."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    repeated: list[int] = list(range(m))
    for v in range(m, n):
        chosen = rng.choice(repeated, size=m, replace=False) \
            if len(set(repeated)) >= m else rng.integers(0, v, size=m)
        for u in np.unique(chosen):
            src_l.append(v); dst_l.append(int(u))
            repeated.extend([v, int(u)])
    src = np.asarray(src_l + dst_l, dtype=np.int32)   # symmetrize
    dst = np.asarray(dst_l + src_l, dtype=np.int32)

    comm = rng.integers(0, num_classes, size=n).astype(np.int32)
    centroids = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feats = centroids[comm] + 1.5 * rng.normal(
        size=(n, feat_dim)).astype(np.float32)
    g = build_graph(src, dst, n, normalization=normalization)
    tr, va, te = _splits(n, rng)
    return GraphData(graph=g, features=feats, labels=comm,
                     train_mask=tr, val_mask=va, test_mask=te,
                     num_classes=num_classes)


def heterogeneous_sbm(n: int = 2048, num_classes: int = 6,
                      num_edge_types: int = 4, feat_dim: int = 64,
                      avg_degree: int = 12, seed: int = 0) -> GraphData:
    """Typed edges over :func:`sbm_power_law` ("mean" normalization), for
    the R-GCN experiment (paper §5.8)."""
    base = sbm_power_law(n=n, num_classes=num_classes, feat_dim=feat_dim,
                         avg_degree=avg_degree, seed=seed,
                         normalization="mean")
    rng = np.random.default_rng(seed + 1)
    etypes = rng.integers(0, num_edge_types,
                          size=base.graph.e).astype(np.int32)
    return dataclasses.replace(base, edge_types=etypes,
                               num_edge_types=num_edge_types)


REGISTRY = {
    "sbm": sbm_power_law,
    "ba": barabasi_albert,
    "hetero": heterogeneous_sbm,
}


def reddit_like(scale: float = 1.0, seed: int = 0) -> GraphData:
    """Scaled-down Reddit stand-in (feature dim 602, 41 classes, as in the
    paper's Table 1)."""
    n = max(1024, int(23000 * scale))
    return sbm_power_law(n=n, num_classes=41, feat_dim=602,
                         avg_degree=max(8, int(64 * scale)), seed=seed)
