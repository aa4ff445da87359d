"""chameleon-34b [vlm] — early-fusion, VQ image tokens in the text vocab,
QK-norm for training stability. [arXiv:2405.09818]

Backbone only: the VQ-GAN image tokenizer is a stub frontend; image tokens
arrive as ordinary token ids / precomputed embeddings (early fusion means
the decoder is modality-agnostic — exactly why PagedEviction applies
unchanged to its KV cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    source="arXiv:2405.09818 (Chameleon)",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10_000.0,
    modality="vlm",
    norm="rmsnorm",
    act="silu",
)
