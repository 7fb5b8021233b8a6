"""The tensor-parallel "model" axis over a ``torch.distributed`` group.

:class:`TPMesh` names the process group whose ranks are the paper's TP
workers and answers the "how many workers, which one am I" questions; the
rectangular gather/split all-to-alls need both the vertex count and the
feature dim to divide the TP degree (pad with :func:`padded_size`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import collectives as C


def padded_size(size: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``size``."""
    return -(-size // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The TP workers: the ranks of ``group`` (``None``: the default
    group, which the caller has initialised), labelled ``axis`` in the
    collective ledger (:mod:`.telemetry`)."""

    group: Any = None
    axis: str = "model"

    @property
    def size(self) -> int:
        """TP degree N."""
        return C.axis_size(self.group)

    @property
    def index(self) -> int:
        """This rank's worker index on the model axis."""
        return C.axis_index(self.group)

    def validate_divisible(self, n_vertices: int, dim: int) -> None:
        n = self.size
        problems = [f"{what} {v} % {n} != 0 (pad to {padded_size(v, n)})"
                    for what, v in (("vertex count", n_vertices),
                                    ("feature dim", dim)) if v % n]
        if problems:
            raise ValueError(
                "TPMesh divisibility violated — rectangular gather/split "
                "all-to-alls need both dims to divide the TP degree: "
                + "; ".join(problems))
