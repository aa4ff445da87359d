"""The paper's own evaluation models: Llama-3.2-1B/3B and Llama-3.1-8B
Instruct. [hf:meta-llama/Llama-3.1-8B-Instruct & Llama-3.2 model cards]"""
from repro_torch.configs.base import ModelConfig

LLAMA_3_2_1B = ModelConfig(
    name="llama-3.2-1b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-1B-Instruct",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)

LLAMA_3_2_3B = ModelConfig(
    name="llama-3.2-3b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-3B-Instruct",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)

LLAMA_3_1_8B = ModelConfig(
    name="llama-3.1-8b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.1-8B-Instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
)
