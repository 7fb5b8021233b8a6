"""Share of the traced steps' wall time in which no operation ran on rank
0's device: 1 − (union of its kernels, copies and memsets ÷ wall time),
from ``torch.profiler``."""


def read(run):
    tr = run["ranks"][0]["trace"]
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
