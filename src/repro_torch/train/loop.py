"""LM train step factory: the port of ``repro/train/loop.py`` on one
device.

``train_step(state, batch) -> (state, metrics)``: the loss of
:func:`make_loss_fn`, its gradient by ``torch.autograd`` over the
parameter leaves, the optimizer's update and ``p + u``.  The reference
jits the step and donates the state's buffers; here ``donate=True`` updates
the state's tensors in place.

The reference's sharded setup (``sharder``, ``in_shardings``,
``batch_spec``, ``batch_shardings``, ``sharded_setup``) needs its sharding
rules, ROADMAP queue 1 item 25a; a sharder or shardings passed here raise.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels import NO_BACKWARD
from ..models import transformer as T
from ..params import tree_leaves, tree_map, tree_unflatten
from .state import TrainState


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: sharded LM training is not ported (ROADMAP queue 1 item "
        f"25a); the port trains an LM on one device")


def _forward_only_kernels(cfg: ArchConfig) -> list[str]:
    """The forward-only kernels ``cfg``'s forward would call."""
    kinds = set(cfg.layer_kinds())
    out = []
    if cfg.attn_impl == "flash" and kinds - {"mamba"}:
        out.append(f'{cfg.name} attn_impl="flash" (the flash attention '
                   f'kernel)')
    if cfg.ssm_impl == "fused" and "mamba" in kinds:
        out.append(f'{cfg.name} ssm_impl="fused" (the SSD intra-chunk '
                   f'kernel)')
    return out


def make_loss_fn(cfg: ArchConfig, sharder=None, aux_weight: float = 0.01,
                 remat=True):
    """``loss_fn(params, batch) -> (loss + aux_weight·aux, (loss, aux))``.

    ``batch`` holds ``tokens`` and pre-shifted ``targets`` (B, S) and, for
    a modality config, ``prefix`` (B, P, D), as tensors or numpy arrays;
    the logits of the P prefix positions take no part in the loss."""
    if sharder is not None:
        raise _unported("make_loss_fn(sharder=...)")
    kernels = _forward_only_kernels(cfg)
    if kernels:
        raise RuntimeError(NO_BACKWARD.format(kernel=" and ".join(kernels)))
    off = cfg.num_prefix_embeddings if cfg.modality else 0

    def loss_fn(params, batch):
        dev = params["embed"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        logits, aux = T.forward(params, cfg, batch["tokens"],
                                batch.get("prefix"), remat=remat)
        # targets[i] = tokens[i + 1]
        loss = T.lm_loss(logits[:, off:], batch["targets"])
        return loss + aux_weight * aux, (loss, aux)

    return loss_fn


def _write_into(old, new):
    """``new``'s values copied into ``old``'s tensors; returns ``old``."""
    if old is not None:
        for o, n in zip(tree_leaves(old), tree_leaves(new)):
            if o is not n:
                o.copy_(n)
    return old


def make_train_step(cfg: ArchConfig, optimizer, sharder=None,
                    aux_weight: float = 0.01, remat=True,
                    donate: bool = True, in_shardings=None):
    """``train_step(state, batch) -> (state, {"loss", "aux_loss",
    "total_loss"})``, the metrics 0-d fp32 tensors.

    ``donate=True`` writes the new parameters and optimizer moments into
    the state's own tensors (no_grad) and returns a state that holds them;
    ``donate=False`` leaves the state passed in untouched.  Raises for a
    ``sharder`` or ``in_shardings`` (ROADMAP queue 1 item 25a) and for a
    config whose forward calls a forward-only kernel."""
    if in_shardings is not None:
        raise _unported("make_train_step(in_shardings=...)")
    if sharder is not None:
        raise _unported("make_train_step(sharder=...)")
    loss_fn = make_loss_fn(cfg, None, aux_weight, remat)

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        live = [t.detach().requires_grad_() for t in leaves]
        total, (loss, aux) = loss_fn(tree_unflatten(state.params, live),
                                     batch)
        grads = torch.autograd.grad(total, live, allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                tree_unflatten(state.params, grads), state.opt_state,
                state.params)
            del grads       # freed before the update is applied
            if donate:
                for p, u in zip(leaves, tree_leaves(updates)):
                    p.add_(u.to(p.dtype))
                params = state.params
                opt_state.mu = _write_into(state.opt_state.mu, opt_state.mu)
                opt_state.nu = _write_into(state.opt_state.nu, opt_state.nu)
            else:
                params = tree_map(lambda p, u: p + u.to(p.dtype),
                                  state.params, updates)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "total_loss": total.detach()}
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step
