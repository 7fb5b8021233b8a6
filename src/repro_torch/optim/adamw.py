"""AdamW and SGD over parameter trees, with the JAX package's exact
update rules.

``opt = adamw(lr); state = opt.init(params); updates, state =
opt.update(grads, state, params); params = apply_updates(params, updates)``.
Not ``torch.optim.AdamW``: weight decay applies only to params with
``ndim >= 2`` and is added to the step as ``lr·wd·p``, as in the JAX
package's ``optim/adamw.py``.  The learning rate may be a float or a
step-indexed schedule (:mod:`.schedule`); ``state.count`` is the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..params import tree_leaves, tree_map


@dataclasses.dataclass
class OptState:
    count: int
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[..., tuple[Any, OptState]]


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: float | None = None) -> Optimizer:
    def init(params):
        return OptState(count=0, mu=tree_map(torch.zeros_like, params),
                        nu=tree_map(torch.zeros_like, params))

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        if grad_clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(grads)))
            scale = torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g),
                      state.nu, grads)
        mu_hat_scale = 1.0 / (1 - b1 ** count)
        nu_hat_scale = 1.0 / (1 - b2 ** count)
        lr_t = _lr_at(lr, count)

        def upd(m, v, p):
            step = lr_t * (m * mu_hat_scale) / (
                torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay and p is not None and p.dim() >= 2:
                step = step + lr_t * weight_decay * p
            return -step

        updates = tree_map(upd, mu, nu, params if params is not None else mu)
        return updates, OptState(count=count, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum ``mu = momentum·mu + g`` where
    ``momentum`` is non-zero; ``state.nu`` is None."""
    def init(params):
        return OptState(count=0, mu=tree_map(torch.zeros_like, params),
                        nu=None)

    def update(grads, state: OptState, params=None):
        count = state.count + 1
        lr_t = _lr_at(lr, count)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            updates = tree_map(lambda m: -lr_t * m, mu)
        else:
            mu = state.mu
            updates = tree_map(lambda g: -lr_t * g, grads)
        return updates, OptState(count=count, mu=mu, nu=None)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
