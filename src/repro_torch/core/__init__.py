# The paper's primary contribution: GNN tensor parallelism (feature-dim
# sharding + gather/split all-to-alls), the decoupled training engine, and
# the chunk-based task scheduler with inter-chunk pipelining.
from . import tp, chunks, agg, decouple, stream  # noqa: F401
from .stream import (StreamBundle, prepare_stream_bundle,
                     make_stream_value_and_grad,
                     stream_gnn_config)  # noqa: F401
from .decouple import (TPBundle, TPGraph, prepare_bundle, padded_gnn_config,
                       make_tp_loss_fn, make_tp_train_fns,
                       make_tp_value_and_grad,
                       tp_decoupled_forward, tp_naive_forward)  # noqa: F401
