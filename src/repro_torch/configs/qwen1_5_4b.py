"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family card]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", arch_type="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    head_dim=128, d_ff=6912, vocab_size=151936,
    qkv_bias=True, act="silu", rope_theta=5000000.0,
    source="hf:Qwen/Qwen1.5 model cards (4B: 40L, d=2560, 20H, QKV bias)",
)
