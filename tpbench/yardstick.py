"""The yardstick: the H100's published peaks, and the operations and
least bytes of one training step worked out from its shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67
TFLOP/s float32 outside the tensor cores (the configurations train in
float32 with TF32 off) and 3.35 TB/s of HBM.

Model FLOPs of a step (nothing recomputed is counted):

* the NN phase's GEMMs, forward and backward: every layer's forward and
  weight gradient, and every input gradient but the features';
* 2·E·d for each propagation round, forward and backward;
* for GAT, the α-gradient product of each round, 2·E·d more.

Least bytes of one aggregation round, forward or backward: its edges'
index and weight once (4 + 4 bytes an edge), the row offsets once, its
input rows once and its output rows once; GAT's backward round also
reads the round's input rows beside the incoming gradient and writes one
α-gradient an edge.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def gemm_flops(n: int, dims: list[int]) -> float:
    """Forward, weight gradients and input gradients but the first of an
    NN phase of widths ``dims`` over ``n`` rows."""
    pairs = list(zip(dims[:-1], dims[1:]))
    fwd = sum(2 * n * a * b for a, b in pairs)
    return 2 * fwd + sum(2 * n * a * b for a, b in pairs[1:])


def step_flops(model: str, n: int, e: int, dims: list[int],
               rounds: int) -> float:
    """Model FLOPs of one step on ``n`` vertices and ``e`` edges."""
    d = dims[-1]
    agg = rounds * 2 * (2 * e * d)
    if model == "gat":
        agg += rounds * 2 * e * d
    return gemm_flops(n, dims) + agg


def round_bytes(n: int, e: int, d: int, gat_backward: bool = False) -> float:
    """Least HBM bytes of one aggregation round at width ``d``."""
    b = e * (4 + 4) + (n + 1) * 8 + 2 * n * d * F32
    if gat_backward:
        b += n * d * F32 + e * F32
    return b


def agg_least_s(model: str, n: int, e: int, d: int, rounds: int) -> float:
    """Least device seconds of a step's aggregation rounds, forward and
    backward, each the larger of its bytes at the HBM rate and its FLOPs
    at the float32 rate."""
    total = 0.0
    for backward in (False, True):
        gat_bwd = backward and model == "gat"
        flops = 2 * e * d * (2 if gat_bwd else 1)
        total += rounds * max(round_bytes(n, e, d, gat_bwd)
                              / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)
    return total
