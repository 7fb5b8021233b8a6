"""LM train step factory: the port of ``repro/train/loop.py``.

``train_step(state, batch) -> (state, metrics)``: the loss of
:func:`make_loss_fn`, its gradient by ``torch.autograd`` over the
parameter leaves, the optimizer's update and ``p + u``.  The reference
jits the step and donates the state's buffers; here ``donate=True`` updates
the state's tensors in place.

Sharded (``sharder=``, a :class:`repro_torch.sharding.specs.Sharder` of
any strategy: ``neutron_tp``, ``megatron`` or ``dp``): every rank runs
the step on its shards of the parameters and of the AdamW moments (the
state of :func:`repro_torch.train.state.init_sharded_state`) and on the
global batch, of which it takes its block (:func:`batch_shardings`).  The loss's
sum and token count are summed over every rank in one call before the
quotient; the gradients of the axes a parameter is replicated over are
summed after the backward (``Sharder.reduce_grads``), and AdamW updates
the shards.  :func:`sharded_setup` returns the reference's keys, its
specs as the port's plain tuples and its shapes as tuples.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import optim
from ..configs.base import ArchConfig, InputShape
from ..kernels import NO_BACKWARD
from ..models import transformer as T
from ..nn import param as nparam
from ..nn.shard import no_shard
from ..params import tree_leaves, tree_map, tree_unflatten
from ..sharding.specs import Sharder, ShardingRules
from .state import TrainState


class TensorSpec(NamedTuple):
    """A tensor's global shape and dtype (the reference's
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def batch_spec(cfg: ArchConfig, shape: InputShape,
               rules: ShardingRules) -> dict:
    """The global batch's shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": TensorSpec((b, s), torch.int32),
             "targets": TensorSpec((b, s), torch.int32)}
    if cfg.modality:
        batch["prefix"] = TensorSpec(
            (b, cfg.num_prefix_embeddings, cfg.d_model), torch.float32)
    return batch


def batch_shardings(cfg: ArchConfig, rules: ShardingRules, mesh) -> dict:
    """The batch's layout: its batch dim over the data axes."""
    d = rules._d()
    sh = {"tokens": (d, None), "targets": (d, None)}
    if cfg.modality:
        sh["prefix"] = (d, None, None)
    return sh


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


def make_loss_fn(cfg: ArchConfig, sharder: Optional[Sharder] = None,
                 aux_weight: float = 0.01, remat=True):
    """``loss_fn(params, batch) -> (loss + aux_weight·aux, (loss, aux))``.

    ``batch`` holds ``tokens`` and pre-shifted ``targets`` (B, S) and, for
    a modality config, ``prefix`` (B, P, D), as tensors or numpy arrays;
    the logits of the P prefix positions take no part in the loss.  Under
    a ``sharder`` ``params`` are this rank's shards and ``batch`` the
    global batch."""
    kernels = _forward_only_kernels(cfg)
    if kernels:
        raise RuntimeError(NO_BACKWARD.format(kernel=" and ".join(kernels)))
    off = cfg.num_prefix_embeddings if cfg.modality else 0

    def loss_fn(params, batch):
        dev = params["embed"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        logits, aux = T.forward(params, cfg, batch["tokens"],
                                batch.get("prefix"), remat=remat,
                                shard=sharder or no_shard)
        # targets[i] = tokens[i + 1]
        if sharder is None:
            loss = T.lm_loss(logits[:, off:], batch["targets"])
        else:
            loss = _sharded_lm_loss(logits, batch["targets"], off, sharder)
        return loss + aux_weight * aux, (loss, aux)

    return loss_fn


def _sharded_lm_loss(logits, targets, off: int, sharder: Sharder):
    """:func:`T.lm_loss` of this rank's logits (the token layout of the
    P + S positions): its tokens' summed cross-entropy and their count,
    the P prefix positions masked out, summed over every rank in one call
    before the quotient."""
    b, s = targets.shape
    mask = torch.ones(b, s, device=logits.device)
    shard = sharder.bound(b, s + off)

    def local(t):
        t = shard.take_batch(F.pad(t, (off, 0)))
        return shard(t[..., None], "act_tokens", src="act_seq")[..., 0]
    targets, mask = local(targets), local(mask)
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.take_along_dim(
        logits, targets[..., None].long(), dim=-1)[..., 0]
    sums = sharder.psum_all(torch.stack([(nll * mask).sum(), mask.sum()]))
    return sums[0] / sums[1]


def _write_into(old, new):
    """``new``'s values copied into ``old``'s tensors; returns ``old``."""
    if old is not None:
        for o, n in zip(tree_leaves(old), tree_leaves(new)):
            if o is not n:
                o.copy_(n)
    return old


def make_grad_fn(cfg: ArchConfig, sharder: Optional[Sharder] = None,
                 aux_weight: float = 0.01, remat=True):
    """``grad_fn(params, batch) -> (grads, (total, loss, aux))``: the
    gradient of :func:`make_loss_fn`'s total over every leaf of
    ``params``, as a tree like it.  Under a ``sharder`` ``params`` are this
    rank's shards and the gradients are those of the shards, summed over
    the axes each parameter is replicated on (``Sharder.reduce_grads``)."""
    loss_fn = make_loss_fn(cfg, sharder, aux_weight, remat)
    specs = None if sharder is None else sharder.param_specs(cfg)

    def grad_fn(params, batch):
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        total, (loss, aux) = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(total, live, allow_unused=True,
                                    materialize_grads=True)
        grads = tree_unflatten(params, grads)
        if sharder is not None:
            grads = sharder.reduce_grads(grads, specs)
        return grads, (total.detach(), loss.detach(), aux.detach())

    return grad_fn


def make_train_step(cfg: ArchConfig, optimizer,
                    sharder: Optional[Sharder] = None,
                    aux_weight: float = 0.01, remat=True,
                    donate: bool = True, in_shardings=None):
    """``train_step(state, batch) -> (state, {"loss", "aux_loss",
    "total_loss"})``, the metrics 0-d fp32 tensors.

    ``donate=True`` writes the new parameters and optimizer moments into
    the state's own tensors (no_grad) and returns a state that holds them;
    ``donate=False`` leaves the state passed in untouched.  Under a
    ``sharder`` the state holds this rank's shards and ``batch`` is the
    global batch; ``in_shardings``, (state shardings, batch shardings) as
    :func:`sharded_setup` returns them, must be that sharder's layouts.
    Raises for a config whose forward calls a forward-only kernel."""
    if in_shardings is not None:
        _check_shardings(cfg, sharder, in_shardings)
    grad_fn = make_grad_fn(cfg, sharder, aux_weight, remat)

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        grads, (total, loss, aux) = grad_fn(state.params, batch)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
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
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total}
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step


def _state_shardings(cfg: ArchConfig, sharder: Sharder) -> TrainState:
    """The state's layout: parameters and AdamW moments by ``param_spec``;
    the counts replicated (``()``)."""
    specs = tree_map(lambda sp: sp.spec, sharder.param_specs(cfg))
    return TrainState(params=specs, opt_state=optim.OptState(
        count=(), mu=specs, nu=specs), step=())


def _check_shardings(cfg, sharder, in_shardings) -> None:
    if sharder is None:
        raise ValueError("make_train_step(in_shardings=...) lays out a "
                         "sharded step: pass its sharder")
    state_sh, batch_sh = in_shardings
    want = (_state_shardings(cfg, sharder),
            batch_shardings(cfg, sharder.rules, sharder.mesh))
    if (state_sh, batch_sh) != want:
        raise ValueError(
            "in_shardings differ from the sharder's layouts: the port runs "
            "each rank on its param_spec shards and its block of the "
            "batch (sharded_setup's state_shardings and batch_shardings)")


def sharded_setup(cfg: ArchConfig, shape: InputShape, mesh,
                  rules: ShardingRules, lr: float = 3e-4,
                  sharder: Optional[Sharder] = None, remat=True) -> dict:
    """Everything a sharded step needs: ``train_step`` (AdamW at ``lr``),
    ``optimizer``, ``state_shapes`` (global shapes), ``state_shardings``
    (specs), ``batch_specs``, ``batch_shardings`` and ``sharder`` (a plain
    :class:`Sharder` unless one is given).  A state for the step:
    ``init_sharded_state(params, cfg, optimizer, sharder)``."""
    optimizer = optim.adamw(lr)
    if sharder is None:
        sharder = Sharder(mesh=mesh, rules=rules)
    shapes = nparam.param_shapes(cfg)
    state_shapes = TrainState(params=shapes, opt_state=optim.OptState(
        count=(), mu=shapes, nu=shapes), step=())
    state_sh = _state_shardings(cfg, sharder)
    b_sh = batch_shardings(cfg, rules, mesh)
    step_fn = make_train_step(cfg, optimizer, sharder, remat=remat,
                              in_shardings=(state_sh, b_sh))
    return dict(train_step=step_fn, optimizer=optimizer,
                state_shapes=state_shapes, state_shardings=state_sh,
                batch_specs=batch_spec(cfg, shape, rules),
                batch_shardings=b_sh, sharder=sharder)
