"""stablelm-3b [dense] — MHA (kv=heads), LayerNorm, partial-rotary family.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b (family card; assigned dims)",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    qkv_bias=True,
    rope_theta=10_000.0,
    norm="layernorm",
    act="silu",
)
