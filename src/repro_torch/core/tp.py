"""GNN tensor parallelism: the gather/split layout collectives (paper §3.1).

Two activation layouts exist for an (V, D) embedding matrix on N TP ranks:

* **vertex-sharded**  ``(V/N, D)`` per rank — NN (UPDATE) phase layout;
* **dim-sharded**     ``(V, D/N)`` per rank — graph-aggregation layout.

``split``  : vertex-sharded → dim-sharded
``gather`` : dim-sharded  → vertex-sharded

Both are single all-to-alls moving ``V·D/N`` elements per rank regardless
of graph topology — the paper's load-balance argument.  Each is the other's
backward.

Hybrid DP×TP adds a third layout, **vertex-sharded over every rank** —
the vertex dim over ``(model,) + data_axes``, model-major
(:func:`vertex_block`) — used by the NN phase so its dense compute also
divides over the replica axes.  The replica ops
(``runtime.collectives.replica_gather`` / ``replica_slice``) move in and
out of it; the gather/split all-to-alls stay on the model axis.

Each transition has a second spelling for the constraint backend
(:mod:`repro_torch.runtime.constraint`): :func:`split_constraint` and
:func:`gather_constraint` re-lay a global DTensor ``(axis, None) ↔ (None,
axis)``, the same all-to-alls run through the same choke point.
"""
from __future__ import annotations

import torch

from ..runtime import collectives as C
from ..runtime import constraint as K
from ..runtime.mesh import TPMesh


def vertex_block(mesh: TPMesh) -> tuple[int, int]:
    """(index, count) of this rank's block of the vertex dim, which
    shards over ``(model,) + data_axes``, model-major — block ``m·R + r``
    for model index m and replica index r of R, so that gathering the
    replica shards back together
    (:func:`repro_torch.runtime.collectives.replica_gather`) rebuilds each
    model worker's contiguous pure-TP vertex block."""
    rep = mesh.replicas()
    r = C.replica_size(rep)
    return mesh.index * r + C.replica_index(rep), mesh.size * r


def split(h: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """vertex-sharded (V/N, D) → dim-sharded (V, D/N)."""
    return C.all_to_all(h, mesh.group, split_axis=1, concat_axis=0,
                        axis=mesh.axis)


def gather(z: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """dim-sharded (V, D/N) → vertex-sharded (V/N, D)."""
    return C.all_to_all(z, mesh.group, split_axis=0, concat_axis=1,
                        axis=mesh.axis)


# ---------------------------------------------------------------------------
# Constraint backend: the same transitions on global DTensors
# ---------------------------------------------------------------------------

def vertex_spec(axis: str = "model", data_axes: tuple[str, ...] = (),
                trailing: int = 1) -> tuple:
    """Spec of the vertex-sharded layout: the vertex dim over ``axis``, or
    under hybrid DP×TP over ``(axis,) + data_axes``, model-major (see
    :func:`vertex_block`); ``trailing`` unsharded dims after it."""
    rows = (axis,) + tuple(data_axes) if data_axes else axis
    return (rows,) + (None,) * trailing


def split_constraint(h, axis: str = "model",
                     data_axes: tuple[str, ...] = (), *,
                     mirror: bool = True):
    """Constraint-backend split: global (V, D) from ``(axis, None)`` to
    ``(None, axis)``.  Under hybrid DP×TP the source is
    :func:`vertex_spec`'s, and the transition takes two hops as the
    reference's does: the data-axis gather to ``(axis, None)``, then the
    model all-to-all — the explicit backend's replica_gather + split."""
    if data_axes:
        h = K.layout_cast(h, (axis, None),
                          src_spec=vertex_spec(axis, data_axes),
                          mirror=mirror)
    return K.layout_cast(h, (None, axis), src_spec=(axis, None),
                         mirror=mirror)


def gather_constraint(z, axis: str = "model",
                      data_axes: tuple[str, ...] = (), *,
                      mirror: bool = True):
    """Constraint-backend gather: global (V, D) from ``(None, axis)`` to
    ``(axis, None)``, and under hybrid DP×TP on to :func:`vertex_spec`'s
    layout by a local slice (the explicit backend's gather +
    replica_slice)."""
    z = K.layout_cast(z, (axis, None), src_spec=(None, axis),
                      mirror=mirror)
    if data_axes:
        z = K.layout_cast(z, vertex_spec(axis, data_axes),
                          src_spec=(axis, None), mirror=mirror)
    return z
