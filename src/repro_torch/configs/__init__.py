"""Config registry of the torch port: the architectures it serves today.

The port serves every family of the JAX package but musicgen: the paper's
Llama trio, qwen2.5-3b, mistral-nemo-12b, stablelm-3b (LayerNorm),
gemma3-27b (local/global windows, qk-norm, GeGLU), chameleon-34b (qk-norm;
image tokens arrive as ordinary ids), the two mixtrals (MoE MLP, sliding
window), and the recurrent ones: jamba-1.5-large (mamba layers beside
attention, MoE) and xlstm-1.3b (mLSTM and sLSTM, no attention). musicgen
(cross-attention, codebooks) is known by name so that asking for it fails
with a clear message."""
from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.llama3 import LLAMA_3_1_8B, LLAMA_3_2_1B, LLAMA_3_2_3B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_1_3B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA_3_2_1B, LLAMA_3_2_3B, LLAMA_3_1_8B, QWEN2_5_3B,
                        MISTRAL_NEMO_12B, STABLELM_3B, GEMMA3_27B,
                        CHAMELEON_34B, MIXTRAL_8X7B, MIXTRAL_8X22B,
                        JAMBA_1_5_LARGE, XLSTM_1_3B)
}

# families the JAX package serves that need modalities the port does not
# have yet (cross-attention with codebooks)
NOT_YET_PORTED = ("musicgen-medium",)


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is served by the JAX package only; the torch port "
            f"serves {sorted(ARCHS)} so far")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "CacheConfig", "LayerSpec", "ModelConfig", "get_arch"]
