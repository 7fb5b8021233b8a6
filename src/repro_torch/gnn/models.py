"""GNN model definitions, coupled (classic) and decoupled (paper §4.1),
single device: GCN, GAT, GraphSAGE, GIN and R-GCN.

These are the reference semantics the distributed engine
(:mod:`repro_torch.core.decouple`) is held against, and what the
single-device trainer (:mod:`repro_torch.gnn.train`) runs.  Parameters
are the same nested dicts as the JAX package's (GCN ``{"layers": [{"w", "b"},
...]}``, GAT ``{"w", "a_l", "a_r"}`` a layer, GIN ``{"l0", "l1", "eps"}``,
R-GCN ``{"rel", "self"}``), so :mod:`repro_torch.params` carries them
across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..params import tree_map
from . import layers as L
from .layers import EdgeListDev


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"          # one of MODELS
    in_dim: int = 64
    hidden_dim: int = 64
    num_classes: int = 8
    num_layers: int = 2         # L — both NN rounds and propagation rounds
    decoupled: bool = True      # paper's DT mode (see forward)
    gamma: float = 1.0          # propagation edge weight γ ∈ (0,1] (§4.1.3)
    num_edge_types: int = 1     # rgcn only


MODELS = ("gcn", "gat", "sage", "gin", "rgcn")


def check_model(cfg: GNNConfig) -> None:
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}; expected one of "
                         f"{MODELS}")


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device="cuda"):
    """Glorot-uniform weights and zero biases from ``generator``, in the
    JAX package's tree shapes."""
    check_model(cfg)
    n = cfg.num_layers
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (n - 1) + [cfg.num_classes]
    io = list(zip(dims[:-1], dims[1:]))
    if cfg.model == "gcn":
        tree = {"layers": [L.init_dense(generator, i, o) for i, o in io]}
    elif cfg.model == "sage":
        tree = {"layers": [L.init_dense(generator, 2 * i, o)
                           for i, o in io]}
    elif cfg.model == "gin":
        tree = {"layers": [{"l0": L.init_dense(generator, i, o),
                            "l1": L.init_dense(generator, o, o),
                            "eps": torch.zeros(())} for i, o in io]}
    elif cfg.model == "gat":
        tree = {"layers": [L.init_gat_layer(generator, i, o)
                           for i, o in io]}
    else:
        tree = {"rel": [L.glorot((cfg.num_edge_types, i, o), generator)
                        for i, o in io],
                "self": [L.init_dense(generator, i, o) for i, o in io]}
    return tree_map(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# Coupled forward (classic per-layer AGG→UPDATE; eqs. 1–6)
# ---------------------------------------------------------------------------

def coupled_forward(params, cfg: GNNConfig, g: EdgeListDev, x,
                    etypes: torch.Tensor | None = None):
    """Per layer an aggregation and an update.  GCN and R-GCN skip the
    activation on the last layer, GAT its ELU; SAGE applies its ReLU on
    every layer and GIN none after ``l1``, as in the reference."""
    check_model(cfg)
    if cfg.model == "rgcn" and etypes is None:
        raise ValueError("the coupled R-GCN forward needs etypes, each "
                         "edge's relation")
    h = x
    n = cfg.num_layers
    for i in range(n):
        last = i == n - 1
        act = (lambda v: v) if last else torch.relu
        if cfg.model == "gcn":
            h = L.gcn_update(params["layers"][i], L.aggregate(g, h), act=act)
        elif cfg.model == "sage":
            h = L.sage_forward(params["layers"][i], g, h)
        elif cfg.model == "gin":
            p = params["layers"][i]
            h = L.gin_forward(p, g, h, p["eps"])
        elif cfg.model == "gat":
            alpha, hw = L.gat_attention(params["layers"][i], g, h)
            h = L.aggregate(g, hw, alpha)
            h = h if last else F.elu(h)
        else:
            a = L.rgcn_aggregate(g, etypes, h, params["rel"][i])
            h = act(a + L.dense(params["self"][i], h))
    return h


# ---------------------------------------------------------------------------
# Decoupled forward (paper §4.1.2): L NN rounds → L propagation rounds
# ---------------------------------------------------------------------------

def mlp_phase(params, cfg: GNNConfig, x):
    """The vertex-sharded NN phase: UPDATE applied L times (eq. 7).  GIN's
    ``eps`` and R-GCN's relation weights act only in the coupled layers,
    so they get no gradient here."""
    check_model(cfg)
    h = x
    n = cfg.num_layers
    layers = params["self" if cfg.model == "rgcn" else "layers"]
    for i, p in enumerate(layers):
        last = i == n - 1
        if cfg.model == "gin":
            # each layer is its own two-layer MLP; nothing between layers
            h = L.dense(p["l1"], torch.relu(L.dense(p["l0"], h)))
        elif cfg.model == "gat":
            h = h @ p["w"]
            h = h if last else F.elu(h)
        else:
            if cfg.model == "sage":
                # decoupled SAGE: dense on [h‖h] (self = neighbour input)
                h = torch.cat([h, h], dim=-1)
            h = L.dense(p, h)
            h = h if last else torch.relu(h)
    return h


def propagation_edge_weights(params, cfg: GNNConfig, g: EdgeListDev, h):
    """Edge weights of the propagation phase.

    GCN, SAGE, GIN, R-GCN: the (pre-normalized) structural weights scaled
    by γ.  GAT: the generalized decoupling — attention α precomputed from
    the final embeddings (the edge-associated NN op pulled in front of the
    aggregation, §4.1.1)."""
    if cfg.model == "gat":
        p = params["layers"][-1]
        return cfg.gamma * L.gat_alpha(g, h @ p["a_l"], h @ p["a_r"])
    return cfg.gamma * g.weight


def decoupled_forward(params, cfg: GNNConfig, g: EdgeListDev, x,
                      etypes: torch.Tensor | None = None):
    """Reference (single-device) decoupled semantics: eqs. 7–9.  ``etypes``
    is accepted for :func:`forward`'s sake and unused: R-GCN's decoupled
    path propagates by the structural weights."""
    h = mlp_phase(params, cfg, x)
    w = propagation_edge_weights(params, cfg, g, h)
    z = h
    for _ in range(cfg.num_layers):
        z = L.aggregate(g, z, edge_weight=w)
    return z


def forward(params, cfg: GNNConfig, g: EdgeListDev, x,
            etypes: torch.Tensor | None = None):
    if cfg.decoupled:
        return decoupled_forward(params, cfg, g, x, etypes)
    return coupled_forward(params, cfg, g, x, etypes)


def masked_loss_and_acc(logits, labels, mask, num_classes):
    """Masked NLL sum, correct count, and mask count over the trailing
    class dim; padded classes beyond ``num_classes`` get a −1e9 offset."""
    c_pad = logits.shape[-1]
    if c_pad > num_classes:
        offset = torch.zeros(c_pad, dtype=logits.dtype, device=logits.device)
        offset[num_classes:] = -1e9
        logits = logits + offset
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss_sum = torch.sum(nll * mask)
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum((pred == labels).to(logits.dtype) * mask)
    return loss_sum, correct, torch.sum(mask)


def cross_entropy(logits, labels, mask):
    """Mean NLL over the vertices of ``mask`` (0 for an empty mask)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    mask = mask.to(logits.dtype)
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask):
    """Share of the vertices of ``mask`` whose argmax is their label."""
    pred = torch.argmax(logits, dim=-1)
    mask = mask.to(torch.float32)
    correct = (pred == labels).to(torch.float32) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
