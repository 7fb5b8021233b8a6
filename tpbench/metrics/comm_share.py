"""Device time of rank 0's NCCL kernels over the traced steps' wall
time."""


def read(run):
    r0 = run["ranks"][0]
    tr = r0["trace"]
    if not tr or r0["shapes"]["world"] == 1:
        return None
    return 100.0 * tr["nccl_s"] / tr["wall_s"]
