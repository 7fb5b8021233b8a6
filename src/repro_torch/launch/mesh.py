"""The launch-facing mesh builder — the port of ``repro/launch/mesh.py``'s
``make_host_mesh``, on :func:`repro_torch.runtime.mesh.hybrid_mesh`.

The production meshes (256 and 512 chips) and the dry-run that lowers on
them are the LM launch tools, ROADMAP queue 1 item 25b."""
from __future__ import annotations

from ..runtime.mesh import TPMesh, hybrid_mesh


def make_host_mesh(model: int | None = None, data: int = 1,
                   pod: int = 1) -> TPMesh:
    """A (data, model) mesh — (pod, data, model) when ``pod > 1`` — over
    every rank of the initialised default process group; the shape must
    use the whole world (``model=None`` infers the model degree).  Every
    rank calls it with the same arguments."""
    return hybrid_mesh(model=model, data=data, pod=pod)
