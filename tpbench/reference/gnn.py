"""Plain PyTorch reference of the benchmarked training step: decoupled
GCN and single-head GAT (an NN phase of L dense layers, then L
propagation rounds over the normalised graph), masked cross-entropy, and
AdamW, for a few full-graph steps.

It imports nothing of the program.  It is handed the raw edge draws,
features, labels, the training mask and the initial weights, and works
out the self-loops, the deduplication and GCN's symmetric weights again
itself.  Aggregation runs over blocks of edges with a hand-written
backward, so that its working set stays a few GB at Reddit's 115 M edges
beside nothing else on the card.

``tf32=True`` is the lower-precision control: every GEMM of the NN phase,
forward and backward, takes its operands rounded to TF32 (10 mantissa
bits, round to nearest even) and accumulates in float32, as a tensor-core
TF32 matmul does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EDGE_BLOCK = 1 << 24


def normalize(src: torch.Tensor, dst: torch.Tensor, n: int) -> dict:
    """Self-loops, parallel edges merged, and GCN's symmetric weights
    1/sqrt(deg_in(v)·deg_out(u)) (float64, then float32)."""
    loop = torch.arange(n, device=src.device)
    pair = torch.unique(torch.cat([dst.long(), loop]) * n
                        + torch.cat([src.long(), loop]))
    d, s = pair // n, pair % n
    del pair
    deg_in = torch.bincount(d, minlength=n).double().clamp(min=1)
    deg_out = torch.bincount(s, minlength=n).double().clamp(min=1)
    w = (1.0 / torch.sqrt(deg_in[d] * deg_out[s])).float()
    return {"n": n, "src": s, "dst": d, "weight": w}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


def matmul(a, b, tf32: bool = False):
    return _MatmulTF32.apply(a, b) if tf32 else a @ b


class _Aggregate(torch.autograd.Function):
    """out[v] = Σ_{(u, v)} w_uv · z[u], over blocks of edges."""

    @staticmethod
    def forward(ctx, z, w, src, dst):
        ctx.save_for_backward(z, w, src, dst)
        out = z.new_zeros(z.shape)
        for lo in range(0, src.numel(), EDGE_BLOCK):
            s, d = src[lo:lo + EDGE_BLOCK], dst[lo:lo + EDGE_BLOCK]
            out.index_add_(0, d, z.index_select(0, s)
                           * w[lo:lo + EDGE_BLOCK, None])
        return out

    @staticmethod
    def backward(ctx, g):
        z, w, src, dst = ctx.saved_tensors
        gz = torch.zeros_like(z)
        gw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        for lo in range(0, src.numel(), EDGE_BLOCK):
            s, d = src[lo:lo + EDGE_BLOCK], dst[lo:lo + EDGE_BLOCK]
            gd = g.index_select(0, d)
            gz.index_add_(0, s, gd * w[lo:lo + EDGE_BLOCK, None])
            if gw is not None:
                gw[lo:lo + EDGE_BLOCK] = (z.index_select(0, s) * gd).sum(1)
        return gz, gw, None, None


def aggregate(z, w, graph: dict):
    return _Aggregate.apply(z, w, graph["src"], graph["dst"])


def edge_softmax(e: torch.Tensor, dst: torch.Tensor, n: int):
    """Softmax of the edge scores ``e`` over each destination's in-edges."""
    top = torch.full((n,), float("-inf"), dtype=e.dtype, device=e.device)
    top = top.scatter_reduce(0, dst, e.detach(), "amax")
    ex = torch.exp(e - top[dst])
    return ex / torch.zeros(n, dtype=e.dtype,
                            device=e.device).index_add(0, dst, ex)[dst]


def logits(params: dict, model: str, num_layers: int, x, graph: dict,
           tf32: bool = False, gamma: float = 1.0):
    """The decoupled forward: L dense layers on the vertex rows (ReLU
    between GCN's, ELU between GAT's; GAT has no bias), the propagation
    weights (γ·Â, or for GAT γ·α from the last layer's score vectors), and
    L propagation rounds.  Weights may carry rows and columns of padding:
    the first layer reads only ``x``'s columns."""
    h = x
    for i in range(num_layers):
        w = params[f"layers.{i}.w"]
        h = matmul(h, w[: h.shape[1]], tf32)
        if model == "gcn":
            h = h + params[f"layers.{i}.b"]
        if i < num_layers - 1:
            h = torch.relu(h) if model == "gcn" else F.elu(h)
    if model == "gat":
        last = num_layers - 1
        e = F.leaky_relu(
            (h @ params[f"layers.{last}.a_l"])[graph["src"]]
            + (h @ params[f"layers.{last}.a_r"])[graph["dst"]], 0.2)
        ew = gamma * edge_softmax(e, graph["dst"], graph["n"])
    else:
        ew = gamma * graph["weight"]
    z = h
    for _ in range(num_layers):
        z = aggregate(z, ew, graph)
    return z


def loss(z, labels, mask, num_classes: int):
    """Mean cross-entropy over the vertices of ``mask``; columns past
    ``num_classes`` are padding and take no part."""
    logp = torch.log_softmax(z[:, :num_classes], dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    m = mask.to(z.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def train(params0: dict, model: dict, opt: dict, x, labels, mask,
          graph: dict, steps: int, tf32: bool = False) -> dict:
    """``steps`` full-graph AdamW steps from ``params0`` (a flat dict of
    named leaves).  Returns each step's loss, the first step's gradient and
    the parameters after the last step.  Weight decay, added to the step as
    lr·wd·p, applies to leaves of two or more dimensions."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        leaves = {k: p.requires_grad_() for k, p in params.items()}
        out = logits(leaves, model["model"], model["num_layers"], x, graph,
                     tf32, model["gamma"])
        value = loss(out, labels, mask, model["num_classes"])
        grads = torch.autograd.grad(value, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(value.detach()))
        grads = dict(zip(leaves, grads))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                step = lr * (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
                if p.dim() >= 2:
                    step = step + lr * wd * p
                params[k] = (p - step).detach()
        del out, value, grads, leaves
    return {"losses": losses, "grad1": grad1,
            "delta": {k: params[k] - params0[k] for k in params}}
