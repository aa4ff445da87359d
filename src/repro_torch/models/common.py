"""Shared model substrate: RMSNorm and LayerNorm, qk-norm, RoPE,
activations, logit soft-capping, initialisers, and plain causal
attention over contiguous K/V: the full score matrix (the one-shot prefill
on the CPU; on the card every prompt goes to the flash kernel) and the
memory-bounded blocked form with an online softmax, which
:func:`causal_attention` picks for long sequences. ``forward_train`` trains
through :func:`causal_attention` on the card as on the CPU, as the JAX
package does: no kernel has a backward pass.

Parameters are plain dicts of tensors laid out as in the JAX package:
weights are (in, out) and applied as ``x @ W``."""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.rules import whole_like

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


def init_norm(norm: str, dim: int, dtype, device) -> dict:
    """RMSNorm params ({"scale"}), or LayerNorm's ({"scale", "bias"}) for
    any other ``norm``, as the JAX package's."""
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if norm != "rmsnorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """LayerNorm when ``params`` carry a bias (population variance, as
    ``jnp.var``), else RMSNorm; computed in f32."""
    xf = x.float()
    if "bias" in params:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """qk-norm: RMS over the head dim (the last axis), in f32."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# activations and logit soft-capping
# ---------------------------------------------------------------------------

def activation(name: str):
    """"silu", or "gelu": the tanh approximation, as the JAX package's
    ``jax.nn.gelu(approximate=True)``."""
    return {"silu": F.silu, "gelu": partial(F.gelu, approximate="tanh")}[name]


def soft_cap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


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
    freqs = whole_like(rope_freqs(x.shape[-1], theta, x.device), positions)
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


def _kv_block(m, l, acc, qb, kb, vb, qpb, kpb, *, scale: float,
              window: int):
    """One kv block of the online softmax: carries m, l (B, KV, G, qc) and
    acc (B, KV, G, qc, hd) f32; qb (B, qc, KV, G, hd) f32. Rows that no key
    has reached yet keep m = -inf, as in the JAX package."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb.float()) * scale
    mask = kpb[:, None, :] <= qpb[:, :, None]
    if window:
        mask &= kpb[:, None, :] > (qpb[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, -torch.inf)
    m_new = torch.maximum(m, s.amax(-1))
    # fully masked rows keep m = -inf; exp(-inf - -inf) would be nan
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    m_inf = torch.isneginf(m)
    corr = torch.exp(torch.where(m_inf, 0.0, m) - safe_m)
    corr = torch.where(m_inf, 0.0, corr)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, vb.float())
    return m_new, l_new, acc * corr[..., None] + pv


def blocked_causal_attention(q, k, v, *, q_positions, kv_positions,
                             window: int = 0, q_chunk: int = 1024,
                             kv_chunk: int = 1024,
                             scale: float | None = None):
    """Memory-bounded causal GQA attention by an online softmax over kv
    chunks, as the JAX package's: never more than (q_chunk, kv_chunk)
    scores per head at once, and each kv block recomputed in the backward
    pass (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint(kv_block)``), so that autograd keeps only the
    (m, l, acc) carries. Every block is computed, masked ones included.
    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); Sq and Sk multiples of their
    chunks; rows with no visible key give zeros."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"sequence lengths {Sq}, {Sk} are not multiples of "
                         f"the chunks {q_chunk}, {kv_chunk}")
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qb = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, KV, G, hd).float()
        qpb = q_positions[:, q0:q0 + q_chunk]
        m = torch.full((B, KV, G, q_chunk), -torch.inf, **f32)
        l = torch.zeros((B, KV, G, q_chunk), **f32)
        acc = torch.zeros((B, KV, G, q_chunk, hd), **f32)
        for k0 in range(0, Sk, kv_chunk):
            sl = slice(k0, k0 + kv_chunk)
            m, l, acc = checkpoint(
                _kv_block, m, l, acc, qb, k[:, sl], v[:, sl],
                qpb, kv_positions[:, sl], scale=scale, window=window,
                use_reentrant=False)
        out = acc / l.clamp_min(1e-30)[..., None]          # (B,KV,G,qc,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd)
                    .to(q.dtype))
    return torch.cat(outs, 1)


def causal_attention(q, k, v, *, q_positions, kv_positions, window: int = 0,
                     scale: float | None = None,
                     blocked_threshold: int = 8192):
    """Dispatch, as the JAX package's: the full score matrix when
    Sq * Sk <= blocked_threshold**2 / 16 or Sq < 1024, else the blocked
    form over chunks of min(1024, S) rows and columns."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq * Sk <= blocked_threshold * blocked_threshold // 16 or Sq < 1024:
        return full_causal_attention(q, k, v, q_positions=q_positions,
                                     kv_positions=kv_positions,
                                     window=window, scale=scale)
    return blocked_causal_attention(q, k, v, q_positions=q_positions,
                                    kv_positions=kv_positions, window=window,
                                    q_chunk=min(1024, Sq),
                                    kv_chunk=min(1024, Sk), scale=scale)
