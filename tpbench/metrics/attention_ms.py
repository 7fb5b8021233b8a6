"""Device milliseconds a step under the program's ``gat.alpha`` span
(GAT's score products, the two score all-gathers and the edge softmax)
and its backward, rank 0 (``tpbench/spans.py``)."""
from tpbench import spans


def read(run):
    return spans.device_ms(run, lambda name: name == "gat.alpha")
