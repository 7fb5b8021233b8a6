"""The benchmark's inputs, made on the device from ``--seed``.

A torch rewrite of the port's ``sbm_power_law`` (stochastic block model
with Zipf degree propensities, features a noisy community centroid) that
draws a Reddit-sized graph on the card in a few large calls, the initial
weights of the model, and the load-and-normalise step (self-loops,
deduplication, GCN's symmetric weights, CSR offsets) that hands the
program a graph in its own format.  The plain reference
(``tpbench/reference``) takes the raw draws from here and normalises them
again itself.
"""
from __future__ import annotations

import math

import torch

# the weights' generator is seeded apart from the graph's, so that a change
# to how the graph is drawn leaves the weights of a seed as they were
_WEIGHT_STREAM = 0x9E3779B97F4A7C15
MAX_ROUNDS = 8


def _generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) ^ stream) % (2 ** 63))
    return g


def draw_graph(gen: dict, seed: int, device) -> dict:
    """The raw graph of config section ``gen`` (its ``graph`` block):
    ``num_edges`` distinct directed edges ``src``/``dst`` (int64, no
    self-pairs), ``features`` (n, F) float32, ``labels`` (n,) int64 and
    the boolean ``train``/``val``/``test`` masks, all on ``device``.

    The structure (communities, which are the labels, and edges) is drawn
    from ``gen["structure_seed"]``, so every run trains on the same graph
    and the same work; ``seed`` draws the features, the split and (in
    :func:`init_weights`) the weights.  Each vertex gets a community and
    a Zipf propensity θ; endpoint pairs are drawn ``num_edges`` at a time,
    the source ∝ θ, the destination ∝ θ within the source's community with
    probability ``p_in`` and ∝ θ over all vertices otherwise, until
    ``num_edges`` distinct pairs are in hand; exactly that many of them
    are kept, at random.  Features are a community centroid plus noise."""
    g = _generator(gen["structure_seed"], device)
    n, c = gen["num_vertices"], gen["num_classes"]
    f, e = gen["num_features"], gen["num_edges"]
    comm = torch.randint(0, c, (n,), generator=g, device=device)
    theta = torch.arange(1, n + 1, device=device,
                         dtype=torch.float64).pow(-gen["zipf_exponent"])
    theta = theta[torch.randperm(n, generator=g, device=device)]
    theta = theta / theta.sum()
    cdf = torch.cumsum(theta, 0)

    def draw(u):
        return torch.searchsorted(cdf, u).clamp_(max=n - 1)

    # within a community: vertices ordered by community, θ summed in that
    # order, and a draw inside the source community's stretch of the sum
    order = torch.argsort(comm, stable=True)
    cs = torch.cumsum(theta[order], 0)
    cdf_in = torch.cat([cs.new_zeros(1), cs])
    counts = torch.bincount(comm, minlength=c)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts

    def pairs():
        """One round of ``e`` endpoint pairs as keys dst·n + src, the
        self-pairs dropped."""
        src = draw(torch.rand(e, generator=g, device=device,
                              dtype=torch.float64) * cdf[-1])
        dst_any = draw(torch.rand(e, generator=g, device=device,
                                  dtype=torch.float64) * cdf[-1])
        sc = comm[src]
        base, top = cdf_in[starts[sc]], cdf_in[ends[sc]]
        u = torch.rand(e, generator=g, device=device, dtype=torch.float64)
        pos = torch.searchsorted(cs, base + u * (top - base))
        pos = torch.minimum(torch.maximum(pos, starts[sc]),
                            (ends[sc] - 1).clamp(min=0))
        same = torch.rand(e, generator=g, device=device) < gen["p_in"]
        same &= counts[sc] > 0
        dst = torch.where(same, order[pos], dst_any)
        keep = src != dst
        return dst[keep] * n + src[keep]

    # rounds of draws until ``e`` distinct pairs are in hand, then exactly
    # ``e`` of them at random: every seed trains on the same edge count
    keys = pairs().unique()
    for _ in range(MAX_ROUNDS - 1):
        if keys.numel() >= e:
            break
        keys = torch.cat([keys, pairs()]).unique()
    if keys.numel() < e:
        raise RuntimeError(f"{MAX_ROUNDS} rounds of {e} draws gave only "
                           f"{keys.numel()} distinct edges")
    keys = keys[torch.randperm(keys.numel(), generator=g,
                               device=device)[:e]]
    src, dst = keys % n, keys // n
    del keys

    g = _generator(seed, device)
    centroids = torch.randn(c, f, generator=g, device=device)
    feats = centroids[comm] + gen["feature_noise"] * torch.randn(
        n, f, generator=g, device=device)
    perm = torch.randperm(n, generator=g, device=device)
    masks = {}
    lo = 0
    for split in ("train", "val", "test"):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[perm[lo:lo + gen["split"][split]]] = True
        masks[split] = m
        lo += gen["split"][split]
    return {"n": n, "num_classes": c, "src": src, "dst": dst,
            "features": feats, "labels": comm, **masks}


def normalize(src: torch.Tensor, dst: torch.Tensor, n: int) -> dict:
    """The program's graph: self-loops added, parallel edges merged,
    sorted by destination then source, GCN's symmetric weights
    1/sqrt(deg_in(v)·deg_out(u)) worked out in float64 and stored float32,
    and the CSR offsets over destinations."""
    loop = torch.arange(n, device=src.device)
    key = torch.unique(torch.cat([dst, loop]) * n + torch.cat([src, loop]))
    dst, src = key // n, key % n
    del key
    deg_in = torch.bincount(dst, minlength=n).double()
    deg_out = torch.bincount(src, minlength=n).double()
    w = torch.rsqrt(deg_in.clamp(min=1)[dst] * deg_out.clamp(min=1)[src])
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(deg_in.long(), 0)
    return {"src": src.int(), "dst": dst.int(), "weight": w.float(),
            "indptr": indptr}


def init_weights(model: str, dims: list[int], seed: int, device) -> dict:
    """Glorot-uniform weights and zero biases of a ``model`` ("gcn" or
    "gat") whose layer widths are ``dims`` (input, hidden..., classes,
    each as the program pads it), in the program's tree: GCN
    ``{"layers": [{"w", "b"}, ...]}``, GAT ``{"layers": [{"w", "a_l",
    "a_r"}, ...]}``."""
    g = _generator(seed, device, _WEIGHT_STREAM)

    def glorot(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
        u = torch.rand(shape, generator=g, device=device)
        return u * (2 * lim) - lim

    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        if model == "gcn":
            layers.append({"w": glorot((d_in, d_out)),
                           "b": torch.zeros(d_out, device=device)})
        elif model == "gat":
            layers.append({"w": glorot((d_in, d_out)),
                           "a_l": glorot((d_out,)),
                           "a_r": glorot((d_out,))})
        else:
            raise ValueError(f"no weights for model {model!r}")
    return {"layers": layers}


def checksum(tensors) -> float:
    """An order-sensitive sum over integer and float tensors, equal on two
    ranks only where every tensor is (to the float sums' rounding, which is
    the same on one card model)."""
    total = 0.0
    for t in tensors:
        pos = torch.arange(1, t.numel() + 1, device=t.device,
                           dtype=torch.float64) % 9973
        total += float((t.reshape(-1).double() * pos).sum())
    return total
