"""Collectives over a process group — the port's one caller of
``torch.distributed``.

Every byte the tensor-parallel engine moves between ranks goes through
here, so a later backend or byte counter is a local change.  The group is
a ``torch.distributed`` process group (``None`` is the default group),
initialised by the caller.

* :func:`all_to_all` is autograd-aware: its backward is the mirrored
  all-to-all (split and concat axes swapped), written out explicitly
  rather than taken from ``torch.distributed.nn``.
* :func:`all_gather` is too: its backward is the reduce-scatter, the
  cotangent summed across ranks and then this rank's slice.  Every rank
  uses the whole gathered vector (GAT's attention scores), so the
  gradient of one rank's slice is the sum of every rank's use of it.
* :func:`psum` sums across ranks.  Its backward passes the cotangent
  through unchanged: the summed value is the same on every rank, and each
  rank seeds its backward from it, so the gradient of what each rank
  contributed is exactly that cotangent.  Parameters replicated on every
  rank then get the sum of the ranks' gradients by a :func:`psum` of the
  gradients after the backward (``core.decouple``, recorded as
  ``grad_psum``) — the step JAX's ``shard_map`` transpose performs
  implicitly.

Each call reports its operand to the collecting ledgers
(:mod:`.telemetry`) under its ``axis`` label (the mesh's, ``"model"``).
The backward of the all-to-all and of the all-gather reports the mirrored
call when it runs, under the forward operand's shape and into the ledgers
that were collecting when its forward ran: autograd runs the backward of
CUDA tensors on a thread of its own, which does not see the caller's
context.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import telemetry as T


def axis_index(group=None) -> int:
    """This rank's coordinate in ``group``."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    """Number of ranks in ``group``."""
    return dist.get_world_size(group)


def _record(op: str, axis: str, x: torch.Tensor, group, ledgers,
            backward: bool = False) -> None:
    if ledgers:
        T.record(op, axis, x, group_size=axis_size(group),
                 backward=backward, ledgers=ledgers)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: axis {split_axis} of shape {tuple(x.shape)} does "
            f"not divide the group size {n} — pad it first "
            f"(runtime.padded_size)")
    send = torch.stack(torch.chunk(x, n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, axis):
        ctx.args = (group, split_axis, concat_axis, axis)
        ctx.ledgers = T.active_ledgers()
        _record("all_to_all", axis, x, group, ctx.ledgers)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, axis = ctx.args
        _record("all_to_all", axis, g, group, ctx.ledgers, backward=True)
        return (_all_to_all(g, group, concat_axis, split_axis),
                None, None, None, None)


def all_to_all(x: torch.Tensor, group=None, *, split_axis: int,
               concat_axis: int, axis: str = "model") -> torch.Tensor:
    """Exchange equal blocks: ``x`` is cut into ``n`` equal blocks along
    ``split_axis``, block ``j`` goes to rank ``j``, and the blocks received
    are concatenated along ``concat_axis`` in rank order (JAX's tiled
    ``all_to_all``; with ``split_axis == concat_axis == 0`` and
    ``x.shape[0] == n`` it is also the untiled one)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        ctx.ledgers = T.active_ledgers()
        _record("all_gather", axis, x, group, ctx.ledgers)
        parts = [torch.empty_like(x) for _ in range(axis_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        group, axis = ctx.args
        # the reduce-scatter, as an all-reduce and a slice: the list-free
        # reduce-scatter is missing from older gloo builds, and the
        # operand is one (V,) vector
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out = g.chunk(axis_size(group))[axis_index(group)]
        _record("all_gather", axis, out, group, ctx.ledgers, backward=True)
        return out, None, None


def all_gather(x: torch.Tensor, group=None, *,
               axis: str = "model") -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (JAX's
    tiled ``all_gather`` on axis 0).  Its backward is the reduce-scatter
    (module docstring)."""
    return _AllGather.apply(x, group, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group=None, *, axis: str = "model",
         op: str = "psum") -> torch.Tensor:
    """Sum ``x`` across the ranks of ``group`` (see the module docstring
    for its backward).  ``op`` is the ledger's op kind: ``"grad_psum"``
    for the replicated parameters' gradient all-reduce."""
    _record(op, axis, x, group, T.active_ledgers())
    return _Psum.apply(x, group)
