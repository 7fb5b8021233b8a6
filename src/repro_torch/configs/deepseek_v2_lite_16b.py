"""DeepSeek-V2-Lite (15.7B total / 2.4B active) [arXiv:2405.04434].

MLA attention with kv_lora_rank=512 compressed KV cache (no q-lora in the
Lite variant), decoupled-RoPE head dim 64; MoE with 2 shared + 64 routed
experts, top-6 routing, expert FFN width 1408; the first layer uses a dense
MLP (width 10944).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=10944, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
    moe=True, num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1408, first_dense_layers=1,
    act="silu",
    source="arXiv:2405.04434 (DeepSeek-V2; Lite config: MLA kv_lora=512, "
           "2 shared + 64 routed experts, top-6)",
)
