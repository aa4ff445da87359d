"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, dtype_of


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.dtype)
    return {
        "w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dt),
        "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dt),
        "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dt),
    }


def mlp_forward(params: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    h = activation(cfg.act)(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
