"""Milliseconds in which rank 0's device is idle inside one of the
program's steps: from the ``tp.train_step`` span's start to the end of
the last device operation launched inside it, on the profiler's clock,
less the device's busy time there, the median over the traced steps; the
harness's time between steps is left out (``tpbench/spans.py``)."""
import statistics

from tpbench import spans


def read(run):
    sp = spans.of_rank0(run)
    if sp is None:
        return None
    return statistics.median(sp["step_idle_s"]) * 1e3
