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


def mlp_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                group=None) -> torch.Tensor:
    """Gated MLP. Under tensor parallelism (``group``) ``d_ff`` is split
    over the ranks (w_gate / w_up by column, w_down by row) and the partial
    outputs are summed over them."""
    h = activation(cfg.act)(x @ params["w_gate"]) * (x @ params["w_up"])
    out = h @ params["w_down"]
    return out if group is None else group.all_reduce_sum(out)
