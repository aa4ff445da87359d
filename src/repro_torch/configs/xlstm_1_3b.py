"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]); attention-free,
constant-size recurrent memory. [arXiv:2405.04517]

PagedEviction is inapplicable (no KV cache exists); the arch is still a
first-class config: training via scan, decode via O(1) state updates
(see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,                      # xLSTM blocks carry their own projections
    vocab_size=50304,
    slstm_every=8,               # 7 mLSTM : 1 sLSTM
    xlstm_proj_factor=2.0,
    norm="layernorm",
    act="gelu",
)
