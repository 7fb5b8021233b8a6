"""Gemma2-9B: alternating local(4096-window)/global attention, logit
softcapping, post-norms [arXiv:2408.00118]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", arch_type="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    head_dim=256, d_ff=14336, vocab_size=256000,
    local_global_pattern=True, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, act="gelu", tie_embeddings=True,
    source="arXiv:2408.00118 (Gemma2-9B: 42L, local/global alternating, "
           "softcaps 50/30, head_dim=256)",
)
