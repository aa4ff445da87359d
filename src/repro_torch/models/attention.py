"""GQA attention over the paged KV pool (the serving path).

``step_attention`` is the unified step's dispatch: T == 1 goes to the
split-K decode kernel, longer chunks to the G-fold chunked-prefill kernel,
both through ``kernels.ops`` (CUDA kernel on the card, plain torch on the
CPU)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, dtype_of


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dt = dtype_of(cfg.dtype)
    p = {
        "wq": dense_init(gen, D, H * hd, dt),
        "wk": dense_init(gen, D, KV * hd, dt),
        "wv": dense_init(gen, D, KV * hd, dt),
        "wo": dense_init(gen, H * hd, D, dt, scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B, S, D) -> q (B, S, H, hd), k, v (B, S, KV, hd), RoPE applied.
    Head counts come from the projection widths, as in the JAX package."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    H, KV = q.shape[-1] // hd, k.shape[-1] // hd
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def decode_attention(q, cache: PagedLayerCache, *, cur_pos, window: int = 0,
                     num_splits: int = 1, want_scores: bool = False,
                     plain: bool = False):
    """Single-token attention. q: (B, H, hd) -> (o, page_scores | None)."""
    return ops.paged_attention(q, cache, cur_pos=cur_pos, window=window,
                               num_splits=num_splits,
                               return_scores=want_scores, plain=plain)


def step_attention(q, cache: PagedLayerCache, *, q_pos, window: int = 0,
                   decode_splits: int = 1, want_scores: bool = False,
                   plain: bool = False):
    """Unified-step attention. q: (B, T, H, hd), q_pos: (B, T) ->
    (o (B, T, H, hd), page_scores (B, P) | None)."""
    if q.shape[1] == 1:
        o, ps = decode_attention(q[:, 0], cache, cur_pos=q_pos[:, 0],
                                 window=window, num_splits=decode_splits,
                                 want_scores=want_scores, plain=plain)
        return o[:, None], ps
    return ops.paged_prefill_attention(q, cache, q_pos=q_pos, window=window,
                                       return_scores=want_scores,
                                       plain=plain)
