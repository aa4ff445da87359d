"""gemma3-27b [dense] — 5 local (sliding 1024) : 1 global interleave, 128k
context, huge vocab, logit soft-capping. [hf:google/gemma-3-1b-pt family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt (family card; assigned dims)",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    local_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    qk_norm=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
)
