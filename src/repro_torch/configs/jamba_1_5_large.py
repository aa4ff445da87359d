"""jamba-1.5-large-398b [hybrid] — Mamba + attention at 1:7 interleave,
MoE (16 experts, top-2) every other layer. [arXiv:2403.19887]

Layer pattern (period 8): layer 0 = attention, layers 1..7 = Mamba;
MoE MLP on every 2nd layer. PagedEviction applies only to the attention
layers' KV cache; Mamba layers hold O(1) recurrent state (see DESIGN.md
§Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887 (Jamba)",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    norm="rmsnorm",
    act="silu",
)
