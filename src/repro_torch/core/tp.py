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
"""
from __future__ import annotations

import torch

from ..runtime import collectives as C
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
