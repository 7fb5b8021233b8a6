"""MusicGen-large decoder [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens.  The EnCodec conv codec and
the T5 text conditioner are modality-frontend stubs: the caller supplies
precomputed conditioning embeddings; the model
here is the 48-layer LM backbone over the audio-token vocabulary (2048
codes/codebook; codebook interleave handled by the delay pattern outside
the backbone).  The port's copy of the JAX package's config, field for
field.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    modality="audio", num_prefix_embeddings=64,   # conditioning frames
    act="gelu",
    source="arXiv:2306.05284 (MusicGen large: 48L/2048d decoder over "
           "EnCodec tokens)",
)
