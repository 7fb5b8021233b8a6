"""Architecture and input-shape configs: the port's copies of the JAX
package's ``ArchConfig`` (field for field and value for value, with its
parameter counts) and ``InputShape``, with the four named shapes.

``reduced()`` gives the CPU smoke variant (a few layers, d_model ≤ 256)
of the same family.  The port runs ``attn_impl`` ``"naive" | "blockwise"
| "flash"`` and ``ssm_impl`` ``"jnp" | "fused"`` (the names are the
reference's: ``"jnp"`` is the plain-torch chunked SSD here); any other
value raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

ATTN_IMPLS = ("naive", "blockwise", "flash")
SSM_IMPLS = ("jnp", "fused")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                     # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 → d_model // num_heads
    pad_vocab_to: int = 0              # pad the vocab dim to this multiple

    # attention flavor
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False
    rope_theta: float = 10000.0

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm: bool = False
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # hybrid (zamba2): one weight-tied attention block every k layers
    hybrid_attn_every: int = 0

    # multimodal stubs: frontend provides precomputed embeddings
    modality: Optional[str] = None
    num_prefix_embeddings: int = 0

    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    post_norm: bool = False
    dtype: str = "bfloat16"

    # implementation knobs
    attn_impl: str = "naive"           # naive | blockwise | flash (CUDA)
    ssm_impl: str = "jnp"              # jnp | fused (CUDA SSD kernel)
    attn_block_q: int = 512            # blockwise's query and KV block
    attn_block_kv: int = 1024          # (the CUDA flash kernel picks its own)
    moe_impl: str = "gather"
    explicit_a2a: bool = False

    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"{self.name}: attn_impl={self.attn_impl!r} is not one of "
                f"{ATTN_IMPLS}")
        if self.ssm_impl not in SSM_IMPLS:
            raise ValueError(
                f"{self.name}: ssm_impl={self.ssm_impl!r} is not one of "
                f"{SSM_IMPLS}")

    # ---- derived -----------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab_size
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm else 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'dense' | 'moe' | 'mamba' | 'shared_attn'
        | 'local' | 'global'."""
        kinds = []
        for i in range(self.num_layers):
            if self.ssm and not self.hybrid_attn_every:
                kinds.append("mamba")
            elif self.hybrid_attn_every:
                if (i + 1) % self.hybrid_attn_every == 0:
                    kinds.append("shared_attn")
                else:
                    kinds.append("mamba")
            elif self.local_global_pattern:
                kinds.append("local" if i % 2 == 0 else "global")
            elif self.moe:
                kinds.append("dense" if i < self.first_dense_layers
                             else "moe")
            else:
                kinds.append("dense")
        return kinds

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.layer_kinds():
            if kind == "mamba":
                di = self.d_inner
                nh = self.ssm_heads
                total += d * (2 * di + 2 * self.ssm_state_dim + nh)
                total += di * d      # out proj
                total += (di + 2 * self.ssm_state_dim) * self.conv_kernel
            else:
                hd = self.head_dim
                if self.use_mla:
                    r = self.kv_lora_rank
                    total += d * (self.num_heads * hd) * 2  # q, o (approx)
                    total += d * (r + self.rope_head_dim)
                    total += r * self.num_heads * 2 * hd
                else:
                    total += d * self.num_heads * hd        # wq
                    total += 2 * d * self.num_kv_heads * hd  # wk, wv
                    total += self.num_heads * hd * d        # wo
                if kind == "moe":
                    total += (self.num_experts + self.num_shared_experts) \
                        * 3 * d * self.moe_d_ff
                    total += d * self.num_experts            # router
                    if self.first_dense_layers:
                        pass
                else:
                    total += 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        # subtract inactive experts
        inactive = self.num_experts - self.num_experts_per_tok
        n_moe_layers = sum(k == "moe" for k in self.layer_kinds())
        total -= n_moe_layers * inactive * 3 * d * self.moe_d_ff
        return total

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims."""
        def shrink(v, cap):
            return min(v, cap) if v else v
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        d_model = min(self.d_model, 256)
        head_dim = d_model // num_heads if num_heads else 0
        attn_every = min(self.hybrid_attn_every, 3)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 * max(1, attn_every)),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=min(self.num_kv_heads, max(1, num_heads // 2))
            if self.num_kv_heads else 0,
            head_dim=head_dim,
            d_ff=shrink(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            kv_lora_rank=shrink(self.kv_lora_rank, 64),
            q_lora_rank=shrink(self.q_lora_rank, 64),
            rope_head_dim=shrink(self.rope_head_dim, 32),
            num_experts=shrink(self.num_experts, 4),
            num_experts_per_tok=shrink(self.num_experts_per_tok, 2),
            num_shared_experts=shrink(self.num_shared_experts, 1),
            moe_d_ff=shrink(self.moe_d_ff, 128),
            ssm_state_dim=shrink(self.ssm_state_dim, 32),
            ssm_head_dim=shrink(self.ssm_head_dim, 32),
            ssm_chunk=shrink(self.ssm_chunk, 16),
            sliding_window=shrink(self.sliding_window, 64),
            num_prefix_embeddings=shrink(self.num_prefix_embeddings, 8),
            first_dense_layers=min(self.first_dense_layers, 1),
            hybrid_attn_every=attn_every,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    def reduced(self, seq_len: int = 64, batch: int = 2) -> "InputShape":
        return dataclasses.replace(self, name=self.name + "-reduced",
                                   seq_len=seq_len, global_batch=batch)


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
