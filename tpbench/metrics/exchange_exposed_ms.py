"""Milliseconds a step in which rank 0's device runs the exchange and
nothing else: the union of the device intervals under the program's
``tp.split*`` and ``tp.gather*`` spans (forward and backward) less the
part that device work of any other span covers, per step, the median over
the traced steps (``tpbench/spans.py``).  The median leaves out the wait
a rank's first collective makes for the rank that entered the profiler
last.  On one card it is the cost of an exchange that moves nothing
between cards."""
import statistics

from tpbench import spans


def read(run):
    sp = spans.of_rank0(run)
    if sp is None or not any(n.startswith(spans.EXCHANGE)
                             for n in sp["host_s"]):
        return None
    return statistics.median(sp["step_exchange_exposed_s"]) * 1e3
