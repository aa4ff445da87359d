"""Modality inputs of the torch port: codebook token shapes and the stub
conditioning, as the JAX package's ``models/multimodal.py``.

musicgen's EnCodec audio codec and T5 text encoder are stubs there and
here: a model takes (B, K, S) codebook token ids and precomputed
conditioning embeddings (B, cond_len, d_model) for its cross-attention.
chameleon's VQ-GAN image tokens arrive as ordinary ids, so a text model's
inputs serve it.

``make_inputs`` draws concrete random inputs from an explicit
``torch.Generator``: the draws differ from the JAX package's (the parity
tests hand its numpy inputs over instead). The JAX ``input_specs``
(``jax.ShapeDtypeStruct`` stand-ins for the dry-run lowering) has no
counterpart until the port has a sharded dry run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import dtype_of


def token_shape(cfg: ModelConfig, batch: int, seq_len: int) -> tuple:
    if cfg.num_codebooks > 1:
        return (batch, cfg.num_codebooks, seq_len)
    return (batch, seq_len)


def decode_token_shape(cfg: ModelConfig, batch: int) -> tuple:
    if cfg.num_codebooks > 1:
        return (batch, cfg.num_codebooks)
    return (batch,)


def make_inputs(gen: torch.Generator, cfg: ModelConfig, batch: int,
                seq_len: int, device=None) -> dict:
    """Random inputs on ``device`` (default CUDA; raises without a card):
    {"tokens": int32 of :func:`token_shape`, "cond": (batch, cond_len,
    d_model) standard normal in the model's dtype, or None without
    cross-attention}. ``gen`` must live on ``device``."""
    device = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size,
                           token_shape(cfg, batch, seq_len), generator=gen,
                           device=device, dtype=torch.int32)
    cond = None
    if cfg.cross_attention:
        cond = torch.randn((batch, cfg.cond_len, cfg.d_model), generator=gen,
                           device=device).to(dtype_of(cfg.dtype))
    return {"tokens": tokens, "cond": cond}
