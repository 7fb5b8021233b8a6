"""GNN model definitions: the decoupled GCN (paper §4.1), single device.

These are the reference semantics the distributed engine
(:mod:`repro_torch.core.decouple`) is held against.  Parameters are the
same nested dict as the JAX package's (``{"layers": [{"w", "b"}, ...]}``),
so :mod:`repro_torch.params` carries them across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch

from . import layers as L
from .layers import EdgeListDev


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"          # only gcn in this package so far
    in_dim: int = 64
    hidden_dim: int = 64
    num_classes: int = 8
    num_layers: int = 2         # L — both NN rounds and propagation rounds
    gamma: float = 1.0          # propagation edge weight γ ∈ (0,1] (§4.1.3)


def _require_gcn(cfg: GNNConfig) -> None:
    if cfg.model != "gcn":
        raise ValueError(f"model {cfg.model!r} is not ported yet; "
                         f"repro_torch supports 'gcn'")


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device="cuda"):
    """Glorot-uniform weights and zero biases from ``generator``."""
    _require_gcn(cfg)
    dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])
    layers = [L.init_dense(generator, dims[i], dims[i + 1])
              for i in range(cfg.num_layers)]
    return {"layers": [{k: v.to(device) for k, v in p.items()}
                       for p in layers]}


# ---------------------------------------------------------------------------
# Decoupled forward (paper §4.1.2): L NN rounds → L propagation rounds
# ---------------------------------------------------------------------------

def mlp_phase(params, cfg: GNNConfig, x):
    """The vertex-sharded NN phase: UPDATE applied L times (eq. 7)."""
    _require_gcn(cfg)
    h = x
    n = cfg.num_layers
    for i, p in enumerate(params["layers"]):
        h = L.dense(p, h)
        if i < n - 1:
            h = torch.relu(h)
    return h


def propagation_edge_weights(params, cfg: GNNConfig, g: EdgeListDev, h):
    """The (pre-normalized) structural weights scaled by γ."""
    _require_gcn(cfg)
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
