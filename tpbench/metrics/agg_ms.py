"""Device milliseconds a step under the program's ``agg.r{r}.c{c}`` spans
(each chunk's aggregation in each round, whatever the backend) and their
backward, rank 0 (``tpbench/spans.py``)."""
from tpbench import spans


def read(run):
    return spans.device_ms(run, spans.AGG.fullmatch)
