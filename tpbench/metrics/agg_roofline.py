"""A floor on the aggregation's share of its roofline: the least time of
every aggregation round of a step on rank 0, forward and backward, at its
share of the class columns (``tpbench/yardstick.py``), over rank 0's
device busy time a traced step.  Taken over the busy time, it reads the
same work whatever backend does the rounds."""
from tpbench import yardstick


def read(run):
    r0 = run["ranks"][0]
    tr, s = r0["trace"], r0["shapes"]
    if not tr:
        return None
    least = yardstick.agg_least_s(s["model"], s["n"], s["e"],
                                  s["dims"][-1] // s["world"], s["rounds"])
    return 100.0 * least / (tr["busy_s"] / tr["steps"])
