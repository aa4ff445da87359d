"""Config registry of the torch port: the architectures it serves today.

The port serves every family of the JAX package whose mixers are all
attention: the paper's Llama trio, qwen2.5-3b, mistral-nemo-12b,
stablelm-3b (LayerNorm), gemma3-27b (local/global windows, qk-norm, GeGLU),
chameleon-34b (qk-norm; image tokens arrive as ordinary ids) and the two
mixtrals (MoE MLP, sliding window). The other families are known by name so
that asking for one fails with a clear message."""
from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.llama3 import LLAMA_3_1_8B, LLAMA_3_2_1B, LLAMA_3_2_3B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA_3_2_1B, LLAMA_3_2_3B, LLAMA_3_1_8B, QWEN2_5_3B,
                        MISTRAL_NEMO_12B, STABLELM_3B, GEMMA3_27B,
                        CHAMELEON_34B, MIXTRAL_8X7B, MIXTRAL_8X22B)
}

# families the JAX package serves that need mixers or modalities the port
# does not have yet (mamba, xLSTM, cross-attention with codebooks)
NOT_YET_PORTED = ("jamba-1.5-large-398b", "xlstm-1.3b", "musicgen-medium")


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is served by the JAX package only; the torch port "
            f"serves {sorted(ARCHS)} so far")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "CacheConfig", "LayerSpec", "ModelConfig", "get_arch"]
