"""The tensor-parallel "model" axis and the replica axes over
``torch.distributed`` process groups.

:class:`TPMesh` names the process group whose ranks are the paper's TP
workers and answers the "how many workers, which one am I" questions; the
rectangular gather/split all-to-alls need both the vertex count and the
feature dim to divide the TP degree (pad with :func:`padded_size`).

Hybrid DP×TP adds replica axes: ``("data",)`` or ``("pod", "data")``,
outermost first, each with its process group, beside the model axis.  TP
runs inside a replica group; the vertex dim shards over every rank,
model-major; gradients are summed over every rank.  :func:`hybrid_mesh`
builds such a mesh over the whole world.  ``TPMesh()`` with no data axes
is pure TP over the default group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import collectives as C
from . import distributed

DEFAULT_AXIS = "model"


def padded_size(size: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``size``."""
    return -(-size // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The TP workers: the ranks of ``group`` (``None``: the default
    group, which the caller has initialised), labelled ``axis`` in the
    collective ledger (:mod:`.telemetry`).

    Hybrid DP×TP: ``data_axes`` names the replica axes, outermost first;
    ``data_groups`` holds this rank's group on each of them, and
    ``replica_group`` its group over all of them together (its index the
    flattened replica coordinate; one data axis: that axis's group).  A
    hybrid mesh spans the default group, which carries the gradient
    all-reduce over every rank.  :func:`hybrid_mesh` builds one."""

    group: Any = None
    axis: str = DEFAULT_AXIS
    data_axes: tuple[str, ...] = ()
    data_groups: tuple = ()
    replica_group: Any = None

    def __post_init__(self):
        object.__setattr__(self, "data_axes", tuple(self.data_axes))
        object.__setattr__(self, "data_groups", tuple(self.data_groups))
        if len(self.data_groups) != len(self.data_axes):
            raise ValueError(
                f"TPMesh needs one group per data axis: data_axes "
                f"{self.data_axes} but {len(self.data_groups)} groups")
        if len(set(self.data_axes)) != len(self.data_axes):
            raise ValueError(f"TPMesh data axes {self.data_axes} repeat")
        for a in self.data_axes:
            if a == self.axis:
                raise ValueError(
                    f"TPMesh axis {a!r} cannot be both the model axis and "
                    f"a data axis")
        if len(self.data_axes) == 1 and self.replica_group is None:
            object.__setattr__(self, "replica_group", self.data_groups[0])
        if self.data_axes and self.n_devices != C.axis_size(None):
            raise ValueError(
                f"a hybrid TPMesh spans the default group: {self.size} × "
                f"{self.data_size} ranks but the world has "
                f"{C.axis_size(None)}")

    @property
    def size(self) -> int:
        """TP degree N."""
        return C.axis_size(self.group)

    @property
    def index(self) -> int:
        """This rank's worker index on the model axis."""
        return C.axis_index(self.group)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, the model axis first."""
        return {self.axis: self.size,
                **{a: C.axis_size(g)
                   for a, g in zip(self.data_axes, self.data_groups)}}

    @property
    def data_size(self) -> int:
        """Number of replica groups (product of the data axis sizes)."""
        return C.replica_size(self.replicas())

    @property
    def n_devices(self) -> int:
        """Ranks of the mesh: data_size × size."""
        return self.data_size * self.size

    def group_of(self, name: str):
        """The process group of axis ``name``."""
        if name == self.axis:
            return self.group
        if name not in self.data_axes:
            raise KeyError(name)
        return self.data_groups[self.data_axes.index(name)]

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` view of this mesh for tensors on
        ``device_type``, built once per device type over the mesh's own
        process groups (``DeviceMesh.from_group``: NCCL builds no second
        set of communicators).

        Its dims are ``(model, *data_axes)``, model first: the vertex dim
        shards over the mesh model-major (rank (m, r) holds block
        ``m·R + r``, :func:`repro_torch.core.tp.vertex_block`), and
        DTensor splits a dim sharded on several mesh dims in mesh-dim
        order.  In the rank order of the axes (``pod, data, model``) the
        rows of ``from_local``/``full_tensor`` would land on the wrong
        ranks."""
        cache = self.__dict__.setdefault("_device_meshes", {})
        if device_type not in cache:
            cache[device_type] = _device_mesh(self, device_type)
        return cache[device_type]

    def replicas(self) -> C.Replicas:
        """The replica ops' view of the mesh's data axes (``Replicas()``
        for pure TP)."""
        return C.Replicas(self.data_axes, self.data_groups,
                          self.replica_group)

    def for_data_axes(self, data_axes=None) -> "TPMesh":
        """The mesh an execution over ``data_axes`` runs on: ``None`` or
        the mesh's own axes → this mesh; ``()`` → its pure-TP view, the
        model group alone (TP inside each replica group).  The port runs
        hybrid DP×TP over all of the mesh's replica axes or none: a part
        of them raises, and an axis the mesh does not have raises
        ``KeyError``, as a lookup in the reference's mesh shape does."""
        if data_axes is None:
            return self
        data_axes = tuple(data_axes)
        for a in data_axes:
            self.group_of(a)
        if data_axes == self.data_axes:
            return self
        if data_axes:
            raise ValueError(
                f"data_axes {data_axes} are a part of the mesh's "
                f"{self.data_axes}: the port runs hybrid DP×TP over all of "
                f"the mesh's replica axes or, with data_axes=(), none")
        return dataclasses.replace(self, data_axes=(), data_groups=(),
                                   replica_group=None)

    # ---- padding / divisibility contract -------------------------------

    def validate_divisible(self, n_vertices: int, dim: int) -> None:
        """Raise with a padding hint when (V, D) violate the TP contract.

        ``n_vertices`` is checked against *all* workers (model × data:
        the vertex dim shards over every rank in the hybrid layout);
        ``dim`` only against the model degree (features never shard over
        replica axes).
        """
        n = self.size
        k = self.n_devices
        problems = []
        if n_vertices % k:
            problems.append(
                f"vertex count {n_vertices} % {k} != 0 "
                f"(pad to {padded_size(n_vertices, k)})")
        if dim % n:
            problems.append(
                f"feature dim {dim} % {n} != 0 "
                f"(pad to {padded_size(dim, n)})")
        if problems:
            raise ValueError(
                "TPMesh divisibility violated — rectangular gather/split "
                "all-to-alls need both dims to divide the TP degree "
                "(and the vertex dim to divide the full device count): "
                + "; ".join(problems)
                + ". Use runtime.padded_size.")


def _device_mesh(mesh: TPMesh, device_type: str):
    """:meth:`TPMesh.device_mesh`: dims ``(model, *data_axes)`` over the
    mesh's groups, the rank grid :func:`hybrid_mesh`'s (rank
    ``(p·data + d)·model + m``).  Raises when a hand-built mesh's groups
    do not follow that grid."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    names = (mesh.axis,) + mesh.data_axes
    groups = [mesh.group_of(a) for a in names]
    groups = [dist.group.WORLD if g is None else g for g in groups]
    if len(names) == 1:
        return DeviceMesh.from_group(groups[0], device_type,
                                     mesh_dim_names=names)
    sizes = [mesh.shape[a] for a in names]
    grid = torch.arange(mesh.n_devices).reshape(sizes[1:] + sizes[:1])
    grid = grid.movedim(-1, 0)
    coords = (grid == dist.get_rank()).nonzero()[0].tolist()
    for dim, (a, g) in enumerate(zip(names, groups)):
        line = grid[tuple(c if i != dim else slice(None)
                          for i, c in enumerate(coords))].tolist()
        if dist.get_process_group_ranks(g) != line:
            raise ValueError(
                f"TPMesh axis {a!r}: group ranks "
                f"{dist.get_process_group_ranks(g)} are not the rank grid "
                f"line {line} of hybrid_mesh's layout (rank "
                f"(p·data + d)·model + m)")
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=names)


def resolve_mesh_shape(n_devices: int, model: int | None = None,
                       data: int = 1, pod: int = 1,
                       note: str = "") -> tuple[int, int, int]:
    """Resolve an (pod, data, model) request against a device count.

    * every degree must be a positive integer;
    * ``model=None`` infers the model degree as
      ``n_devices // (pod·data)``, which must divide exactly;
    * the resolved shape must consume **all** ``n_devices`` — requesting
      fewer is an error, never a silent truncation of the device list.

    ``note`` is appended verbatim to the device-accounting errors.
    """
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}{note}")
    for name, deg in (("pod", pod), ("data", data), ("model", model)):
        if deg is not None and (not isinstance(deg, int) or deg < 1):
            raise ValueError(
                f"mesh degree {name}={deg!r} must be a positive int")
    groups = pod * data
    if model is None:
        if n_devices % groups:
            raise ValueError(
                f"cannot infer model degree: {n_devices} devices do not "
                f"divide into pod×data = {pod}×{data} = {groups} replica "
                f"groups{note}")
        model = n_devices // groups
    if groups * model != n_devices:
        raise ValueError(
            f"mesh shape (pod={pod}, data={data}, model={model}) needs "
            f"{groups * model} devices but {n_devices} are visible — "
            f"refusing to silently truncate the device list; pass an "
            f"explicit devices= slice to use a subset{note}")
    return pod, data, model


def _own_group(rank_lists: list[list[int]], rank: int):
    """Create one process group per list — every rank creates every group,
    in the same order, as ``new_group`` requires — and return the one that
    holds ``rank``."""
    import torch.distributed as dist
    mine = None
    for ranks in rank_lists:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def hybrid_mesh(model: int | None = None, data: int = 1,
                pod: int = 1) -> TPMesh:
    """Build a hybrid DP×TP mesh over every rank of the default group:
    (data, model), or (pod, data, model).

    Rank ``(p·data + d)·model + m`` is model worker m of replica
    ``p·data + d`` (the reference's row-major device grid).  Groups: one
    model group per replica, one group per data axis for each of the
    other coordinates, the replica group over both data axes when pod >
    1, and the default group as the whole mesh.  The "data" axis is
    always present (degree 1 keeps it); "pod" appears only when
    ``pod > 1``.  Every rank must call this, with the same arguments.

    Strict accounting — see :func:`resolve_mesh_shape`: the shape must
    use the whole world.
    """
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    pod, data, model = resolve_mesh_shape(
        world, model=model, data=data, pod=pod,
        note=f" (world size {world})" + distributed.topology_note())

    def r(p, d, m):
        return (p * data + d) * model + m

    model_g = _own_group([[r(p, d, m) for m in range(model)]
                          for p in range(pod) for d in range(data)], rank)
    data_g = _own_group([[r(p, d, m) for d in range(data)]
                         for p in range(pod) for m in range(model)], rank)
    if pod == 1:
        return TPMesh(model_g, DEFAULT_AXIS, ("data",), (data_g,), data_g)
    pod_g = _own_group([[r(p, d, m) for p in range(pod)]
                        for d in range(data) for m in range(model)], rank)
    replica_g = _own_group([[r(p, d, m) for p in range(pod)
                             for d in range(data)]
                            for m in range(model)], rank)
    return TPMesh(model_g, DEFAULT_AXIS, ("pod", "data"), (pod_g, data_g),
                  replica_g)


def resolve_replicas(mesh: TPMesh, data_axes=None) -> tuple[int, int]:
    """(model degree, replica count) of ``mesh`` for the given replica
    axes (:meth:`TPMesh.for_data_axes`): ``None`` takes the mesh's own,
    ``()`` is the pure-TP escape hatch."""
    mesh = mesh.for_data_axes(data_axes)
    return mesh.size, mesh.data_size


def resolve_bundle_degrees(mesh: TPMesh, n_workers: int | None = None,
                           n_replicas: int | None = None, *,
                           caller: str = "prepare_bundle",
                           worker_name: str = "n_workers"
                           ) -> tuple[int, int]:
    """Resolve a bundle preparer's (workers, replicas) request against
    ``mesh``: ``None`` degrees are derived from the mesh, explicit ones
    must match it exactly — a bundle padded for other degrees than the
    execution mesh would only fail later and further from the mistake."""
    mesh_workers, mesh_replicas = resolve_replicas(mesh)
    n_workers = mesh_workers if n_workers is None else n_workers
    n_replicas = mesh_replicas if n_replicas is None else n_replicas
    if (n_workers, n_replicas) != (mesh_workers, mesh_replicas):
        raise ValueError(
            f"{caller}({worker_name}={n_workers}, n_replicas="
            f"{n_replicas}) contradicts mesh degrees (model="
            f"{mesh_workers}, replicas={mesh_replicas}) — drop the "
            f"explicit counts or pass the matching mesh")
    return n_workers, n_replicas
