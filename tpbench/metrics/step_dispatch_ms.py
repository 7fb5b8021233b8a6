"""Host milliseconds of the program's ``tp.train_step`` span, enqueue to
return, before the harness's synchronise; the median over rank 0's traced
steps (``tpbench/spans.py``)."""
import statistics

from tpbench import spans


def read(run):
    sp = spans.of_rank0(run)
    if sp is None:
        return None
    return statistics.median(sp["step_host_s"]) * 1e3
