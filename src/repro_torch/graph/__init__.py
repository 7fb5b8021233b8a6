from .format import (Graph, ChunkedGraph, BlockSparseGraph, BlockSparsePlan,
                     build_graph, chunk_graph, block_sparse,
                     block_sparse_transpose, rect_block_sparse, stack_plans,
                     chunk_plans, chunk_block_sparse, pad_features,
                     HostFeatureStore)  # noqa: F401
from .synthetic import (GraphData, sbm_power_law, barabasi_albert,
                        heterogeneous_sbm, reddit_like)  # noqa: F401
