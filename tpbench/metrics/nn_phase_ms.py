"""Device milliseconds a step under the program's ``gnn.nn_phase`` span
(the vertex-sharded NN phase, ``mlp_phase``) and its backward, rank 0
(``tpbench/spans.py``)."""
from tpbench import spans


def read(run):
    return spans.device_ms(run, lambda name: name == "gnn.nn_phase")
