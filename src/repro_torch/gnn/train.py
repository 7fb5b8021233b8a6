"""Single-device full-graph training loop (reference and accuracy studies).

Trains the coupled and decoupled variants under identical conditions on
one device, the path a user with one card runs without
``torch.distributed``.  Distributed training goes through
:func:`repro_torch.core.decouple.make_tp_train_fns` instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import optim
from ..graph.synthetic import GraphData
from ..params import tree_leaves, tree_map, tree_unflatten
from . import layers as L
from . import models as M


@dataclasses.dataclass
class EpochLog:
    epoch: int
    loss: float
    train_acc: float
    val_acc: float
    test_acc: float
    seconds: float


def train_full_graph(data: GraphData, cfg: M.GNNConfig,
                     epochs: int = 100, lr: float = 1e-2,
                     weight_decay: float = 5e-4, seed: int = 0,
                     log_every: int = 10,
                     callback: Callable[[EpochLog], None] | None = None,
                     device="cuda"):
    """Train on the full graph with AdamW; returns (params, [EpochLog]).

    An epoch is one step on the train mask's cross-entropy; its seconds
    are the step's, up to the loss being ready on the device.  Every
    ``log_every``-th epoch and the last are evaluated (the accuracies are
    of the updated parameters; the loss is the step's)."""
    g = L.edge_list_dev(data.graph, device)
    x = torch.from_numpy(data.features).to(device)
    labels = torch.from_numpy(data.labels).to(device)
    etypes = (torch.from_numpy(data.edge_types).to(device)
              if data.edge_types is not None else None)
    masks = {k: torch.from_numpy(v.astype(np.float32)).to(device)
             for k, v in dict(train=data.train_mask, val=data.val_mask,
                              test=data.test_mask).items()}

    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device)
    opt = optim.adamw(lr, weight_decay=weight_decay)
    opt_state = opt.init(params)

    def step(params, state):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = M.cross_entropy(M.forward(p, cfg, g, x, etypes), labels,
                               masks["train"])
        # a parameter the model does not use (GIN's eps, R-GCN's relation
        # weights on the decoupled path) gets zeros, as under JAX
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            updates, state = opt.update(tree_unflatten(params, list(grads)),
                                        state, params)
            params = optim.apply_updates(params, updates)
        return params, state, loss.detach()

    @torch.no_grad()
    def metrics(params):
        logits = M.forward(params, cfg, g, x, etypes)
        return tuple(M.accuracy(logits, labels, masks[k])
                     for k in ("train", "val", "test"))

    logs: list[EpochLog] = []
    for epoch in range(1, epochs + 1):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state)
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        dt = time.perf_counter() - t0
        if epoch % log_every == 0 or epoch == epochs:
            tr, va, te = metrics(params)
            log = EpochLog(epoch, loss.item(), tr.item(), va.item(),
                           te.item(), dt)
            logs.append(log)
            if callback:
                callback(log)
    return params, logs
