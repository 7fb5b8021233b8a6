"""GNN model definitions in their decoupled form (paper §4.1), single
device: GCN, GAT, GraphSAGE, GIN and R-GCN.

These are the reference semantics the distributed engine
(:mod:`repro_torch.core.decouple`) is held against.  Parameters are the
same nested dicts as the JAX package's (GCN ``{"layers": [{"w", "b"},
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


def gat_alpha(g: EdgeListDev, sl, sr):
    """GAT's attention α over ``g``'s edges from the (V,) score halves."""
    e = F.leaky_relu(sl.index_select(0, g.src) + sr.index_select(0, g.dst),
                     0.2)
    return L.segment_softmax(e, g.dst, sl.shape[0])


def propagation_edge_weights(params, cfg: GNNConfig, g: EdgeListDev, h):
    """Edge weights of the propagation phase.

    GCN, SAGE, GIN, R-GCN: the (pre-normalized) structural weights scaled
    by γ.  GAT: the generalized decoupling — attention α precomputed from
    the final embeddings (the edge-associated NN op pulled in front of the
    aggregation, §4.1.1)."""
    if cfg.model == "gat":
        p = params["layers"][-1]
        return cfg.gamma * gat_alpha(g, h @ p["a_l"], h @ p["a_r"])
    return cfg.gamma * g.weight


def decoupled_forward(params, cfg: GNNConfig, g: EdgeListDev, x):
    """Reference (single-device) decoupled semantics: eqs. 7–9."""
    h = mlp_phase(params, cfg, x)
    w = propagation_edge_weights(params, cfg, g, h)
    z = h
    for _ in range(cfg.num_layers):
        z = L.aggregate(g, z, edge_weight=w)
    return z


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
