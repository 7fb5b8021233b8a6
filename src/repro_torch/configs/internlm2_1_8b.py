"""InternLM2-1.8B [arXiv:2403.17297]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", arch_type="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=92544,
    act="silu", rope_theta=1000000.0,
    source="arXiv:2403.17297 (InternLM2 1.8B: 24L, d=2048, GQA kv=8)",
)
