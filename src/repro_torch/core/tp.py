"""GNN tensor parallelism: the gather/split layout collectives (paper §3.1).

Two activation layouts exist for an (V, D) embedding matrix on N TP ranks:

* **vertex-sharded**  ``(V/N, D)`` per rank — NN (UPDATE) phase layout;
* **dim-sharded**     ``(V, D/N)`` per rank — graph-aggregation layout.

``split``  : vertex-sharded → dim-sharded
``gather`` : dim-sharded  → vertex-sharded

Both are single all-to-alls moving ``V·D/N`` elements per rank regardless
of graph topology — the paper's load-balance argument.  Each is the other's
backward.
"""
from __future__ import annotations

import torch

from ..runtime import collectives as C
from ..runtime.mesh import TPMesh


def split(h: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """vertex-sharded (V/N, D) → dim-sharded (V, D/N)."""
    return C.all_to_all(h, mesh.group, split_axis=1, concat_axis=0,
                        axis=mesh.axis)


def gather(z: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """dim-sharded (V, D/N) → vertex-sharded (V/N, D)."""
    return C.all_to_all(z, mesh.group, split_axis=0, concat_axis=1,
                        axis=mesh.axis)
