"""InternVL2-1B: InternViT-300M vision encoder + Qwen2-0.5B LM
[arXiv:2404.16821].

The ViT + MLP projector frontend is a stub: the caller provides 256
precomputed patch embeddings per image; this config is the LM backbone that
consumes them before the text tokens.  The port's copy of the JAX package's
config, field for field.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", arch_type="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151655,
    qkv_bias=True,                      # Qwen2 backbone uses QKV bias
    pad_vocab_to=256,                   # 151655 ∤ 16: keep logits shardable
    modality="vision", num_prefix_embeddings=256,
    tie_embeddings=True, act="silu",
    source="arXiv:2404.16821 (InternVL2-1B: InternViT + Qwen2-0.5B LM)",
)
