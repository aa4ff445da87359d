"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    source="arXiv:2401.04088 (Mixtral)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    num_experts=8,
    num_experts_per_tok=2,
    moe_every=1,
    norm="rmsnorm",
    act="silu",
)
