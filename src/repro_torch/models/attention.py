"""GQA attention: over the paged KV pool (serving and one-shot decode) and
over contiguous K/V (the one-shot prefill).

``step_attention`` is the unified step's dispatch: T == 1 goes to the
split-K decode kernel, longer chunks to the G-fold chunked-prefill kernel.
``attention_forward`` sends a whole prompt on the card to the flash kernel,
whatever its length. On the CPU it routes as the JAX package does: the
flash kernel's plain version when S % 128 == 0 and hd % 8 == 0 (128 is the
Pallas kernel's tile), the position-masked full causal attention otherwise.
Kernels go through ``kernels.ops`` (CUDA kernel on the card, plain torch on
the CPU). With ``train=True`` (``forward_train``) it takes plain autograd
attention (``common.causal_attention``) on every device, as the JAX
package's ``use_pallas=False``: no kernel has a backward pass.

Cross-attention to a static conditioning cache (musicgen:
``make_cross_cache``, ``cross_attention_forward``) is plain torch, as the
JAX package's plain jnp: no Pallas kernel computes it there."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, causal_attention,
                                       dense_init, dtype_of,
                                       full_causal_attention, rms_head_norm)


@dataclass
class StaticKVCache:
    """K/V over the conditioning (cross-attention): written once, never
    evicted, O(cond_len) per row and read by every step."""
    k: torch.Tensor  # (B, Sc, KV, hd)
    v: torch.Tensor  # (B, Sc, KV, hd)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> dict:
    """wq / wk / wv / wo, the qkv bias (``cfg.qkv_bias``, never on a
    cross-attention block) and qk-norm scales (``cfg.qk_norm``; a
    cross-attention block carries them unused, as in the JAX package)."""
    hd = cfg.resolved_head_dim
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg.dtype)
    p = {
        "wq": dense_init(gen, D, H * hd, dt),
        "wk": dense_init(gen, D, KV * hd, dt),
        "wv": dense_init(gen, D, KV * hd, dt),
        "wo": dense_init(gen, H * hd, D, dt, scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


def project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B, S, D) -> q (B, S, H, hd), k, v (B, S, KV, hd): the bias, then
    qk-norm (when the params carry it), then RoPE, as in the JAX package.
    Head counts come from the projection widths."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    H, KV = q.shape[-1] // hd, k.shape[-1] // hd
    q, k = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd)
    if "q_norm" in params:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def spec_window(cfg: ModelConfig, spec: LayerSpec) -> int:
    if spec.attn_kind == "swa":
        return cfg.sliding_window
    if spec.attn_kind == "local":
        return cfg.local_window
    return 0


def attention_forward(params: dict, cfg: ModelConfig, spec: LayerSpec, x,
                      positions, plain: bool = False, train: bool = False):
    """Causal self-attention over a contiguous sequence. x: (B, S, D);
    positions: (B, S) (-1 on padding, RoPE'd as is, as in the JAX package)
    -> (out (B, S, D), (k, v) post-RoPE). ``plain``: the flash kernel's
    plain version on the card (a test switch). ``train``: the training
    route, :func:`causal_attention` (differentiable, position-masked) on
    every device.

    The flash kernel masks by index, so with right-padded prompts the valid
    queries never see padding; the position-masked route lets them see the
    padding keys (position -1), as the JAX package's plain route does. Only
    the CPU takes that route, for parity with the JAX package at S % 128."""
    q, k, v = project_qkv(params, cfg, x, positions)
    window = spec_window(cfg, spec)
    B, S = x.shape[:2]
    if train:
        out = causal_attention(q, k, v, q_positions=positions,
                               kv_positions=positions, window=window)
    elif q.is_cuda or (S % 128 == 0 and cfg.resolved_head_dim % 8 == 0):
        out = ops.flash_attention(q, k, v, window=window, plain=plain)
    else:
        out = full_causal_attention(q, k, v, q_positions=positions,
                                    kv_positions=positions, window=window)
    return out.reshape(B, S, -1) @ params["wo"], (k, v)


def cross_attention_forward(params: dict, cfg: ModelConfig, x,
                            cache: StaticKVCache) -> torch.Tensor:
    """Attention of x (B, S, D) to the static conditioning K/V: no
    causality, no RoPE, no bias, no qk-norm. Scores, softmax and P V in
    f32, cast back to x's dtype before ``wo``, as in the JAX package."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["wq"]).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                     cache.k.float()) * (1.0 / math.sqrt(hd))
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1),
                     cache.v.float())
    return o.reshape(B, S, H * hd).to(x.dtype) @ params["wo"]


def make_cross_cache(params: dict, cfg: ModelConfig, cond) -> StaticKVCache:
    """cond (B, Sc, D) conditioning embeddings -> its static K/V."""
    B, Sc, _ = cond.shape
    shape = (B, Sc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return StaticKVCache(k=(cond @ params["wk"]).reshape(shape),
                         v=(cond @ params["wv"]).reshape(shape))


def decode_project_qkv(params: dict, cfg: ModelConfig, x, cur_pos):
    """x: (B, D) single token -> q (B, H, hd), k, v (B, KV, hd), RoPE at
    cur_pos."""
    q, k, v = project_qkv(params, cfg, x[:, None], cur_pos[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def decode_attention(q, cache: PagedLayerCache, *, cur_pos, window: int = 0,
                     num_splits: int = 1, want_scores: bool = False,
                     plain: bool = False, group=None):
    """Single-token attention (float or int8 pool). q: (B, H, hd) ->
    (o, page_scores | None)."""
    return ops.paged_attention(q, cache, cur_pos=cur_pos, window=window,
                               num_splits=num_splits,
                               return_scores=want_scores, plain=plain,
                               group=group)


def step_attention(q, cache: PagedLayerCache, *, q_pos, window: int = 0,
                   decode_splits: int = 1, want_scores: bool = False,
                   plain: bool = False, group=None):
    """Unified-step attention. q: (B, T, H, hd), q_pos: (B, T) ->
    (o (B, T, H, hd), page_scores (B, P) | None). Under tensor parallelism
    q and the pool hold this rank's heads; attention needs no collective
    (each query group attends its own KV head), only the page scores'
    head means cross ``group``'s ranks."""
    if q.shape[1] == 1:
        o, ps = decode_attention(q[:, 0], cache, cur_pos=q_pos[:, 0],
                                 window=window, num_splits=decode_splits,
                                 want_scores=want_scores, plain=plain,
                                 group=group)
        return o[:, None], ps
    return ops.paged_prefill_attention(q, cache, q_pos=q_pos, window=window,
                                       return_scores=want_scores,
                                       plain=plain, group=group)
