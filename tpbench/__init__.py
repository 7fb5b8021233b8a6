"""The benchmark of the PyTorch and CUDA port (``repro_torch``): full-graph
GCN and GAT training through its decoupled tensor-parallel engine."""
