"""musicgen-medium [audio] — decoder-only over EnCodec residual-VQ tokens
(4 codebooks, delay pattern), cross-attention to text conditioning.
[arXiv:2306.05284]

Backbone only: the EnCodec tokenizer and T5 text encoder are stub
frontends; ``models.multimodal.make_inputs`` supplies codebook token ids
and random conditioning embeddings. Self-attention KV cache is evictable;
the cross-attention KV over the (static) conditioning is exempt.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="arXiv:2306.05284 (MusicGen)",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    modality="audio",
    num_codebooks=4,
    cross_attention=True,
    cond_len=64,
    rope_theta=10_000.0,
    norm="layernorm",
    act="gelu",
)
