"""Minitron-8B: width-pruned Nemotron-4 [arXiv:2407.14679]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=256000,
    act="silu", rope_theta=10000.0,
    source="arXiv:2407.14679 (Minitron: pruned Nemotron-4 15B -> 8B)",
)
