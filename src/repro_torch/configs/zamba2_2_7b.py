"""Zamba2-2.7B: Mamba2 backbone + periodically-applied weight-shared
attention block [arXiv:2411.15242].

54 layers: 45 mamba2 layers and one *shared* (weight-tied) transformer
block invoked every 6th layer (9 invocations, single parameter copy) —
modeled by ``hybrid_attn_every=6``.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=10240, vocab_size=32000,
    ssm=True, ssm_state_dim=64, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_kernel=4,
    hybrid_attn_every=6,
    source="arXiv:2411.15242 (Zamba2: Mamba2 + shared attention blocks)",
)
