"""Config registry of the torch port: every family of the JAX package.

The paper's Llama trio, qwen2.5-3b, mistral-nemo-12b, stablelm-3b
(LayerNorm), gemma3-27b (local/global windows, qk-norm, GeGLU),
chameleon-34b (qk-norm; image tokens arrive as ordinary ids), the two
mixtrals (MoE MLP, sliding window), the recurrent ones: jamba-1.5-large
(mamba layers beside attention, MoE) and xlstm-1.3b (mLSTM and sLSTM, no
attention), and musicgen-medium (cross-attention to static conditioning,
four parallel codebooks). musicgen runs one-shot, through
``forward_step`` and in training; the serving engine refuses it, as the
JAX package's serve driver does."""
from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.llama3 import LLAMA_3_1_8B, LLAMA_3_2_1B, LLAMA_3_2_3B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA_3_2_1B, LLAMA_3_2_3B, LLAMA_3_1_8B, QWEN2_5_3B,
                        MISTRAL_NEMO_12B, STABLELM_3B, GEMMA3_27B,
                        CHAMELEON_34B, MIXTRAL_8X7B, MIXTRAL_8X22B,
                        JAMBA_1_5_LARGE, XLSTM_1_3B, MUSICGEN_MEDIUM)
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "CacheConfig", "LayerSpec", "ModelConfig", "get_arch"]
