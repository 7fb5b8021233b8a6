"""Production and host mesh builders — the port of ``repro/launch/mesh.py``,
on :func:`repro_torch.runtime.mesh.hybrid_mesh`.

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model) — the pod
axis extends data parallelism across the inter-pod link.

Functions, not module constants: a mesh needs the initialised default
process group (``launch/dryrun.py`` initialises torch's ``fake`` backend
at 256 or 512 ranks to build these without a card).
"""
from __future__ import annotations

from ..runtime.mesh import TPMesh, hybrid_mesh


def make_production_mesh(*, multi_pod: bool = False) -> TPMesh:
    """The fleet meshes over the first 256 (or 512) ranks of the default
    process group: (data 16, model 16), or (pod 2, data 16, model 16) —
    rank ``(p·16 + d)·16 + m``, the reference's row-major device grid.
    Raises when the world is smaller.  The world must be exactly that
    size (``hybrid_mesh`` never truncates it).

    The reference's ``topology=True`` orders the devices so that the
    model axis lies on ICI-adjacent chips; torch exposes no interconnect
    topology, so the port has no counterpart: the rank grid is the
    placement (on a node of NVLink-connected cards, model groups of
    consecutive ranks)."""
    import torch.distributed as dist
    n = 512 if multi_pod else 256
    world = dist.get_world_size()
    if world < n:
        raise ValueError(
            f"production mesh needs {n} devices, {world} visible")
    if multi_pod:
        return hybrid_mesh(model=16, data=16, pod=2)
    return hybrid_mesh(model=16, data=16)


def make_host_mesh(model: int | None = None, data: int = 1,
                   pod: int = 1) -> TPMesh:
    """A (data, model) mesh — (pod, data, model) when ``pod > 1`` — over
    every rank of the initialised default process group; the shape must
    use the whole world (``model=None`` infers the model degree).  Every
    rank calls it with the same arguments."""
    return hybrid_mesh(model=model, data=data, pod=pod)
