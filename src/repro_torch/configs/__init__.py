"""Config registry of the torch port: the architectures it serves today.

Only dense pure-attention families are served by this slice (the paper's
Llama trio and qwen2.5-3b). The other families of the JAX package are known
by name so that asking for one fails with a clear message."""
from repro_torch.configs.base import CacheConfig, LayerSpec, ModelConfig
from repro_torch.configs.llama3 import LLAMA_3_1_8B, LLAMA_3_2_1B, LLAMA_3_2_3B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (LLAMA_3_2_1B, LLAMA_3_2_3B, LLAMA_3_1_8B, QWEN2_5_3B)
}

# families the JAX package serves that need mixers / MLPs / modalities the
# port does not have yet (MoE, mamba, xLSTM, windows, cross-attention)
NOT_YET_PORTED = (
    "chameleon-34b", "stablelm-3b", "mixtral-8x22b", "mistral-nemo-12b",
    "jamba-1.5-large-398b", "gemma3-27b", "mixtral-8x7b", "xlstm-1.3b",
    "musicgen-medium",
)


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is served by the JAX package only; the torch port "
            f"serves {sorted(ARCHS)} so far")
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "CacheConfig", "LayerSpec", "ModelConfig", "get_arch"]
