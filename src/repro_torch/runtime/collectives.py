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
  uses the whole gathered tensor (GAT's attention scores, the replica
  gathers' rows), so the gradient of one rank's slice is the sum of every
  rank's use of it.  NCCL runs it as one ``reduce_scatter_tensor``; gloo,
  which has none, as an all-reduce and a slice.  ``op="param_gather"``
  records a sharded parameter's gather at use under its own op kind.
* :func:`ppermute` sends along a permutation of the group's ranks (point
  to point, one ``batch_isend_irecv``); its backward sends the cotangent
  along the inverse permutation.
* :func:`psum` sums across ranks.  Its backward passes the cotangent
  through unchanged: the summed value is the same on every rank, and each
  rank seeds its backward from it, so the gradient of what each rank
  contributed is exactly that cotangent.  Parameters replicated on every
  rank then get the sum of the ranks' gradients by a :func:`psum` of the
  gradients after the backward (``core.decouple``, recorded as
  ``grad_psum``) — the step JAX's ``shard_map`` transpose performs
  implicitly.

Replica ops (:func:`replica_gather`, :func:`replica_slice`,
:func:`psum_replicas`, :func:`replica_index`, :func:`replica_size`) carry
hybrid DP×TP traffic across the data/pod axes, named by a
:class:`Replicas`; each is the identity for ``Replicas()`` (pure TP).

Each call reports its operand to the collecting ledgers
(:mod:`.telemetry`) under its ``axis`` label (the mesh's, ``"model"``; a
tuple of axes, such as ``("pod", "data")``, for a group that spans them).
The backward of the all-to-all and of the all-gather reports the mirrored
call when it runs, under the forward operand's shape and into the ledgers
that were collecting when its forward ran: autograd runs the backward of
CUDA tensors on a thread of its own, which does not see the caller's
context.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from . import telemetry as T


def axis_index(group=None) -> int:
    """This rank's coordinate in ``group``."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    """Number of ranks in ``group``."""
    return dist.get_world_size(group)


def _record(op: str, axis, x: torch.Tensor, group, ledgers,
            backward: bool = False) -> None:
    """Report ``x`` under ``axis`` (a name or a tuple of names), whose
    group size is ``group``'s: for a tuple, the product of its axes'."""
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
    def forward(ctx, x, group, axis, op, dim):
        ctx.args = (group, axis, op, dim)
        ctx.ledgers = T.active_ledgers()
        _record(op, axis, x, group, ctx.ledgers)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, axis, op, dim = ctx.args
        n, g = axis_size(group), g.movedim(dim, 0).contiguous()
        if dist.get_backend(group) == dist.Backend.NCCL:
            out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM,
                                       group=group)
        else:
            # gloo has no reduce-scatter of one tensor: an all-reduce and
            # this rank's slice, which moves about twice the bytes the
            # ledger records (the reduce-scatter's)
            g = g.clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
            out = g.chunk(n)[axis_index(group)]
        _record(op, axis, out, group, ctx.ledgers, backward=True)
        return out.movedim(0, dim), None, None, None, None


def all_gather(x: torch.Tensor, group=None, *, axis: str = "model",
               op: str = "all_gather", dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (JAX's
    tiled ``all_gather``), contiguous.  Its backward is the reduce-scatter
    (module docstring).  ``op`` is the ledger's op kind:
    ``"param_gather"`` for a sharded parameter gathered at use."""
    return _AllGather.apply(x, group, axis, op, dim)


def _send_recv(x: torch.Tensor, group, perm) -> torch.Tensor:
    """One ``batch_isend_irecv`` of ``perm``: this rank sends ``x`` to the
    rank it maps to and receives from the rank that maps to it (zeros
    where none does); a pair (i, i) is a local copy."""
    me = axis_index(group)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, dst[0])
                              if group is not None else dst[0], group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src[0])
                              if group is not None else src[0], group))
    if src and src[0] == me:
        out.copy_(x)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, axis):
        ctx.args = (group, perm, axis)
        ctx.ledgers = T.active_ledgers()
        _record("ppermute", axis, x, group, ctx.ledgers)
        return _send_recv(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        group, perm, axis = ctx.args
        _record("ppermute", axis, g, group, ctx.ledgers, backward=True)
        return (_send_recv(g, group, [(j, i) for i, j in perm]),
                None, None, None)


def ppermute(x: torch.Tensor, group=None, perm=(), *,
             axis: str = "model") -> torch.Tensor:
    """Send ``x`` along the permutation ``perm`` of ``group``'s ranks
    (pairs (source, destination)): rank j receives the ``x`` of the rank i
    with (i, j) in ``perm``, zeros where no pair ends at j (JAX's
    ``ppermute``).  Its backward sends the cotangent back along the
    inverse permutation.  Point-to-point, as one ``batch_isend_irecv``
    (gloo and NCCL), recorded at the ring factor 1."""
    perm = tuple((int(i), int(j)) for i, j in perm)
    return _Ppermute.apply(x, group, perm, axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group=None, *, axis="model",
         op: str = "psum") -> torch.Tensor:
    """Sum ``x`` across the ranks of ``group`` (see the module docstring
    for its backward); ``axis`` is the ledger's label, a tuple where the
    group spans several axes.  ``op`` is the ledger's op kind:
    ``"grad_psum"`` for the replicated parameters' gradient all-reduce."""
    _record(op, axis, x, group, T.active_ledgers())
    return _Psum.apply(x, group)


# ---------------------------------------------------------------------------
# Replica (data/pod) axis ops — hybrid DP×TP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Replicas:
    """The replica axes a hybrid DP×TP op spans: their names, outermost
    first, this rank's group on each, and its group over all of them
    together, whose rank order is the flattened replica coordinate
    (``TPMesh.replicas`` builds one).  ``Replicas()`` is pure TP."""

    axes: tuple[str, ...] = ()
    groups: tuple = ()
    group: Any = None


def replica_index(rep: Replicas) -> int:
    """Flattened replica coordinate over ``rep.axes`` (major-to-minor,
    outermost first — the block order of the hybrid vertex layout).  0
    for ``Replicas()``."""
    idx = 0
    for g in rep.groups:
        idx = idx * axis_size(g) + axis_index(g)
    return idx


def replica_size(rep: Replicas) -> int:
    """Total replica count (product of the data-axis sizes; 1 for
    ``Replicas()``)."""
    return math.prod(axis_size(g) for g in rep.groups)


def replica_gather(x: torch.Tensor, rep: Replicas, *,
                   mirror: bool = True) -> torch.Tensor:
    """Concatenate the replica shards of ``x`` along dim 0.

    One all-gather per data axis, innermost first, so that for rows
    sharded model-major over ``(model,) + axes`` the result is the model
    worker's contiguous block in global row order.  Its backward is the
    all-gather's reduce-scatter on each axis — the cross-replica gradient
    reduction of hybrid DP×TP — and records as the reference's
    ``mirror=True`` entry.  ``mirror=False`` declares that ``x`` carries
    no gradient (layer 0's input features), so no backward runs and none
    is recorded; a ``x`` that does require one raises.  Identity for
    ``Replicas()``."""
    if not mirror and x.requires_grad:
        raise ValueError(
            "replica_gather(mirror=False) on a tensor that requires grad: "
            "its backward would run and be recorded — pass mirror=True")
    for a, g in zip(reversed(rep.axes), reversed(rep.groups)):
        x = all_gather(x, g, axis=a)
    return x


def _replica_block(length: int, n: int, axis: int,
                   data_axes: tuple[str, ...]) -> int:
    """Per-replica block length, refusing to silently truncate: a floor
    would drop the trailing ``length % n`` rows of every replica."""
    block, rem = divmod(length, n)
    if rem:
        raise ValueError(
            f"replica_slice: axis {axis} of length {length} does not "
            f"divide the replica count {n} (= product of data axes "
            f"{data_axes!r}) — flooring would silently drop {rem} "
            f"trailing rows per replica; pad the axis to a multiple of "
            f"{n} first (runtime.padded_size)")
    return block


def replica_slice(x: torch.Tensor, rep: Replicas) -> torch.Tensor:
    """This replica's block of ``x`` along dim 0 (inverse of
    :func:`replica_gather` on replica-identical values).  Identity for
    ``Replicas()``; raises when dim 0 does not divide the replica count
    instead of silently truncating."""
    if not rep.axes:
        return x
    block = _replica_block(x.shape[0], replica_size(rep), 0, rep.axes)
    return x.narrow(0, replica_index(rep) * block, block)


def psum_replicas(x: torch.Tensor, rep: Replicas) -> torch.Tensor:
    """Sum ``x`` across the replica axes (recorded under their joined
    label, ``"pod+data"``).  Identity for ``Replicas()``."""
    if not rep.axes:
        return x
    return psum(x, rep.group, axis=rep.axes)
