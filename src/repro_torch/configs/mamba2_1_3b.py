"""Mamba2-1.3B: attention-free SSD state-space model [arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", arch_type="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=True, ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_kernel=4,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2 1.3B: 48L, d=2048, state=128, "
           "headdim=64, SSD)",
)
