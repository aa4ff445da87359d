"""Shared model substrate: RMSNorm, RoPE, initialisers, and the plain
causal attention of the one-shot prefill on the CPU (the full score
matrix; on the card every prompt goes to the flash kernel).

Parameters are plain dicts of tensors laid out as in the JAX package:
weights are (in, out) and applied as ``x @ W``."""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# initialisers (seeded torch.Generator, made on the target device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype
               ) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def init_norm(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm, computed in f32."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, hd); positions broadcastable to x's seq axes.
    Rotates INTERLEAVED pairs (x[2i], x[2i+1]), as the JAX package does
    (not the rotate-half layout)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# causal attention over contiguous K/V (plain torch, as the JAX package's
# jnp path; the flash kernel is the card's path)
# ---------------------------------------------------------------------------

def full_causal_attention(q, k, v, *, q_positions, kv_positions,
                          window: int = 0, scale: float | None = None):
    """Causal (optionally windowed) GQA attention over the full (Sq, Sk)
    score matrix, masked by POSITION: a key is visible iff kv_pos <= q_pos
    (and kv_pos > q_pos - window). q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd);
    rows with no visible key give zeros."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = kv_positions[:, None, :] <= q_positions[:, :, None]  # (B, Sq, Sk)
    if window:
        mask &= kv_positions[:, None, :] > (q_positions[:, :, None] - window)
    p = torch.softmax(torch.where(mask[:, None, None], s, -torch.inf), -1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
