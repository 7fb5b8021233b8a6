"""Granite-3.0-1B-A400M: fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", arch_type="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    moe=True, num_experts=32, num_experts_per_tok=8, num_shared_experts=0,
    moe_d_ff=512, first_dense_layers=0,
    pad_vocab_to=256,                   # 49155 ∤ 16: keep logits shardable
    tie_embeddings=True, act="silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (32 experts, top-8)",
)
