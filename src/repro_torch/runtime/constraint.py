"""The constraint engine backend: global-view tensors on DTensor, every
layout transition through the collective choke point.

The explicit backend writes a per-rank body that calls
:mod:`repro_torch.runtime.collectives` by hand.  This backend keeps the
reference's other spelling (``repro.runtime.constraint``): a function of
*global* tensors, whose layouts are stated by specs, with the paper's
gather/split written as layout transitions (``(axis, None) ↔ (None,
axis)``).  Here a global tensor is a ``torch.distributed.tensor.DTensor``
on the mesh's ``DeviceMesh`` (:meth:`repro_torch.runtime.mesh.TPMesh
.device_mesh`), and DTensor carries the NN phase, the loss and the
replicated parameters.

**The rule: DTensor carries layouts; transitions run through
``runtime/collectives.py``; DTensor issues only the reductions in**
:func:`replicate`.  No ``redistribute`` that moves data is called
anywhere in the port.  A transition (:func:`layout_cast`,
:func:`note_transition`) runs its all-gathers, all-to-alls and slices on
``x.to_local()`` through the choke point, which records them in the
collective ledger, and re-wraps the result with ``DTensor.from_local``.
DTensor's own ``redistribute`` would move the data by another collective
outside the ledger: on gloo, ``Shard(0) → Shard(1)`` prints "CPU process
group does not support alltoall yet, falling back with allgather +
chunk!" and runs an ``all_gather_into_tensor`` (N× the paper's bytes), and
on NCCL it takes another path again, so the CPU tests would hold another
program than the one the card runs.  The only collectives DTensor issues
itself are the Partial → Replicate all-reduces of the loss sums and of
the parameter gradients, in :func:`replicate`.

Gradients follow the choke point's autograd, as on the explicit backend:
a transition's backward is its collective's mirror (the all-gather's is
the reduce-scatter, the slice's a zero pad), so a tensor replicated over
an axis by a transition carries, on each rank, that rank's contribution to
its gradient.  A replicated parameter's gradient on a rank is therefore
its partial sum over every mesh dim, whatever placement DTensor gives it,
and :func:`reduce_grads` sums it over every rank.

Specs are the reference's ``PartitionSpec`` vocabulary as plain tuples:
one entry per array dim, ``None`` (replicated), an axis name, or a tuple
of names, outermost first; trailing dims left out are replicated.  While
a factory runs the forward, the mesh is visible through
:func:`current_mesh`; outside one, :func:`constrain` and
:func:`layout_cast` are no-ops, as in the reference.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from ..params import tree_leaves, tree_map, tree_unflatten
from . import collectives as C
from . import telemetry as T

#: The mesh of the innermost active :func:`mesh_context` (a TPMesh).
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_constraint_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a :class:`repro_torch.runtime.mesh.TPMesh`) the
    active mesh of the block."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh():
    """The mesh of the innermost active :func:`mesh_context` (or None)."""
    return _ACTIVE_MESH.get()


def _names(mesh) -> tuple[str, ...]:
    """The mesh's axes in ``DeviceMesh`` dim order: model first."""
    return (mesh.axis,) + mesh.data_axes


def validate_specs(mesh, specs) -> None:
    """Reject a spec (in the sequence ``specs``; ``None`` entries pass)
    that names an axis the mesh does not have, or one axis on two dims,
    with an error naming the culprit."""
    axes = set(mesh.shape)
    for spec in specs:
        if spec is None:
            continue
        used: list[str] = []
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax not in axes:
                    raise ValueError(
                        f"spec {spec} names mesh axis {ax!r} but the mesh "
                        f"only has axes {sorted(axes)}")
                if ax in used:
                    raise ValueError(
                        f"spec {spec} uses mesh axis {ax!r} on more than "
                        f"one dimension")
                used.append(ax)


def placements(spec, mesh=None) -> tuple:
    """The DTensor placements of ``spec``, one per mesh dim ``(model,
    *data_axes)``.  A dim sharded over several axes must list them in that
    order: DTensor splits it in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = current_mesh() if mesh is None else mesh
    validate_specs(mesh, [spec])
    names = _names(mesh)
    for entry in spec:
        if isinstance(entry, tuple):
            order = [names.index(a) for a in entry]
            if order != sorted(order):
                raise ValueError(
                    f"spec {spec}: the axes {entry} of one dim must follow "
                    f"the mesh's dim order {names}")
    where = T._spec_placement(spec, len(spec))
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def spec_of(x) -> tuple:
    """The spec of DTensor ``x``'s layout on the active mesh (trailing
    replicated dims dropped).  A Partial placement has no spec: raises."""
    names = _names(current_mesh())
    entries: list[list[str]] = [[] for _ in range(x.ndim)]
    for a, p in zip(names, x.placements):
        if p.is_partial():
            raise ValueError(
                f"a Partial tensor ({x.placements}) has no layout spec: "
                f"reduce it first (constraint.replicate)")
        if p.is_shard():
            entries[p.dim].append(a)
    spec = tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)
    return T.normalize_spec(spec)


def from_local(t: torch.Tensor, spec, mesh=None):
    """This rank's shard ``t`` as a global DTensor laid out ``spec`` on
    ``mesh`` (the active mesh by default).  Moves nothing."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh() if mesh is None else mesh
    return DTensor.from_local(t, mesh.device_mesh(t.device.type),
                              placements(spec, mesh), run_check=False)


def _check_stageable(src: dict, dst: dict, src_spec, dst_spec) -> None:
    """The transitions :func:`_move` runs as local collectives: a dropped
    axis innermost on its dim, a moved axis alone on both its dims, an
    added axis innermost on its dim."""
    def axes_on(where, dim):
        return [a for a, d in where.items() if d == dim]

    current = dict(src)
    for a in reversed([a for a in src if a not in dst]):
        if axes_on(current, src[a])[-1] != a:
            raise NotImplementedError(
                f"{src_spec} → {dst_spec}: axis {a!r} is not the innermost "
                f"of its dim")
        del current[a]
    for a in current:
        if a in dst and dst[a] != current[a] and (
                axes_on(current, current[a]) != [a]
                or axes_on(current, dst[a])):
            raise NotImplementedError(
                f"{src_spec} → {dst_spec}: axis {a!r} moves between dims "
                f"that other axes also shard")
    for d in set(dst.values()):
        on = axes_on(dst, d)
        kept = [a for a in on if a in src]
        if on[:len(kept)] != kept:
            raise NotImplementedError(
                f"{src_spec} → {dst_spec}: an axis is added outside the "
                f"axes dim {d} keeps")


def move_local(y: torch.Tensor, src_spec, dst_spec, mesh, *,
               gather_op: str = "all_gather") -> torch.Tensor:
    """The transition ``src_spec → dst_spec`` of a global tensor, on this
    rank's shard ``y``, through the choke point: the dropped axes'
    all-gathers innermost first (recorded as ``gather_op``), the moved
    axes' all-to-alls, the added axes' slices (the staging of
    :func:`repro_torch.runtime.telemetry.implied_collectives`)."""
    src = T._spec_placement(src_spec, y.ndim)
    dst = T._spec_placement(dst_spec, y.ndim)
    _check_stageable(src, dst, src_spec, dst_spec)
    for a in reversed([a for a in src if a not in dst]):
        y = C.all_gather(y, mesh.group_of(a), axis=a, op=gather_op,
                         dim=src[a])
    for a in src:
        if a in dst and src[a] != dst[a]:
            y = C.all_to_all(y, mesh.group_of(a), split_axis=dst[a],
                             concat_axis=src[a], axis=a)
    for a in dst:
        if a not in src:
            d, g = dst[a], mesh.group_of(a)
            y = C.replica_slice(y.movedim(d, 0),
                                C.Replicas((a,), (g,), g)).movedim(0, d)
    return y


def _move(x, src_spec, dst_spec, *, mirror: bool, anchored: bool):
    """Run the transition ``src_spec → dst_spec`` of DTensor ``x`` through
    the choke point (:func:`move_local` on its shard)."""
    mesh = current_mesh()
    if x.placements != placements(src_spec, mesh):
        raise ValueError(
            f"transition from {src_spec}: the tensor is laid out "
            f"{spec_of(x)}")
    if not mirror and x.requires_grad:
        raise ValueError(
            "a transition with mirror=False on a tensor that requires "
            "grad: its backward would run and be recorded — pass "
            "mirror=True")
    y = move_local(x.to_local(), src_spec, dst_spec, mesh)
    T.record_transition(tuple(x.shape), str(x.dtype).removeprefix("torch."),
                        src_spec, dst_spec, mirror=mirror, anchored=anchored)
    return from_local(y, dst_spec, mesh)


def constrain(x, spec):
    """Lay ``x`` out as ``spec`` where that is free: a no-op when it is
    already so, or a Replicate → Shard move, which is a local slice.  A
    move that needs a collective raises: spell it as a transition
    (:func:`layout_cast`), which runs it through the choke point.  No-op
    outside an active mesh."""
    mesh = current_mesh()
    if mesh is None or x.placements == placements(spec, mesh):
        return x
    have = spec_of(x)
    src = T._spec_placement(have, x.ndim)
    dst = T._spec_placement(spec, x.ndim)
    if any(a not in dst or dst[a] != d for a, d in src.items()):
        raise ValueError(
            f"constrain {have} → {T.normalize_spec(spec)} needs a "
            f"collective; write it as layout_cast(x, {spec}, "
            f"src_spec={have}), which runs it through "
            f"runtime/collectives.py")
    return _move(x, have, spec, mirror=True, anchored=False)


def layout_cast(x, spec, src_spec=None, *, mirror: bool = True):
    """A layout transition: anchor ``x`` at ``src_spec`` (a free
    :func:`constrain`), then move it to ``spec`` through the choke point,
    recorded as an anchored :class:`~repro_torch.runtime.telemetry
    .TransitionRecord`.  ``mirror=False`` declares that ``x`` carries no
    gradient (layer 0's input features), and raises if it does.  No-op
    outside an active mesh; without ``src_spec``, a :func:`constrain`."""
    if current_mesh() is None:
        return x
    if src_spec is None:
        return constrain(x, spec)
    return _move(constrain(x, src_spec), src_spec, spec, mirror=mirror,
                 anchored=True)


def note_transition(x, src_spec, dst_spec, *, mirror: bool = True):
    """The transition ``src_spec → dst_spec`` of ``x``, already laid out
    ``src_spec``, through the choke point — for a move spelled as a
    relabelling (the DP halo's transpose), recorded unanchored.  No-op
    outside an active mesh."""
    if current_mesh() is None:
        return x
    return _move(x, src_spec, dst_spec, mirror=mirror, anchored=False)


def local_map(fn, out_spec, *args, partial: bool = False):
    """``fn`` on the local shards of the DTensor ``args`` (other arguments
    pass as they are), its tensor result wrapped laid out ``out_spec`` —
    or, with ``partial=True``, as this rank's partial sum (Partial on
    every mesh dim).  For the compute DTensor has no rule for (the chunk
    loop's ``index_add_``, the SpMM kernel, the loss): without it DTensor
    raises or replicates.  Moves nothing."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = current_mesh()
    out = fn(*(a.to_local() if isinstance(a, DTensor) else a
               for a in args))
    if not partial:
        return from_local(out, out_spec, mesh)
    dm = mesh.device_mesh(out.device.type)
    return DTensor.from_local(out, dm, [Partial()] * dm.ndim,
                              run_check=False)


def replicate(x):
    """Partial → Replicate on every mesh dim where ``x`` is Partial: the
    all-reduces of the loss sums and of the gradients.  The one function
    that lets DTensor issue a collective itself."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in x.placements):
        raise ValueError(f"replicate: {x.placements} has no Partial dim")
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p
                           for p in x.placements])


def reduce_grads(grads, mesh) -> list:
    """The replicated parameters' gradients (DTensors or tensors) summed
    over every rank in one :func:`replicate`, as plain tensors.  Each
    rank's local gradient is its partial sum over every mesh dim (module
    docstring), so it is reduced as Partial everywhere."""
    from torch.distributed.tensor import DTensor, Partial
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    flat = torch.cat([g.reshape(-1) for g in local])
    dm = mesh.device_mesh(flat.device.type)
    total = replicate(DTensor.from_local(flat, dm, [Partial()] * dm.ndim,
                                         run_check=False)).to_local()
    return [t.view_as(g) for t, g in
            zip(total.split([g.numel() for g in local]), local)]


def replicated_params(params, mesh, requires_grad: bool = False):
    """A parameter tree as Replicate DTensors (leaves that require grad
    where asked)."""
    from torch.distributed.tensor import DTensor, Replicate
    dm = mesh.device_mesh(tree_leaves(params)[0].device.type)
    return tree_map(
        lambda t: DTensor.from_local(
            t.detach(), dm, [Replicate()] * dm.ndim,
            run_check=False).requires_grad_(requires_grad), params)


def value_and_grad(global_loss, mesh):
    """(params, mask) → (loss, grads) over a global-view
    ``global_loss(params, mask) → (loss, acc)`` whose params are
    Replicate DTensors: plain tensors in and out, the grads summed over
    every rank (:func:`reduce_grads`)."""
    def value_and_grad_fn(params, mask):
        p = replicated_params(params, mesh, requires_grad=True)
        with mesh_context(mesh):
            loss, _ = global_loss(p, mask)
        # a parameter the path does not use gets zeros, as under JAX
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        return loss.to_local().detach(), tree_unflatten(
            params, reduce_grads(grads, mesh))

    return value_and_grad_fn


def plain(global_loss, mesh):
    """``global_loss`` on plain tensors: (params, mask) → (loss, acc)."""
    def loss_and_acc(params, mask):
        with mesh_context(mesh):
            loss, acc = global_loss(replicated_params(params, mesh), mask)
        return loss.to_local(), acc.to_local()

    return loss_and_acc
