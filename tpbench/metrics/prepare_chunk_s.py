"""Host seconds of ``prepare_bundle``'s chunking and comm-plan stages
(the program's ``prepare.chunk_graph`` and ``prepare.comm_plan`` spans,
collected in a ``SpanLog``), on the slowest rank."""
from tpbench import spans


def read(run):
    return spans.prepare_s(run, ("prepare.chunk_graph", "prepare.comm_plan"))
