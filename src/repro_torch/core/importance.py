"""Token / page importance proxies (paper §4.1, Algorithm 1).

Scores follow the convention **higher = more important = keep**. The
paper's proxy is S_i = ||V_i|| / ||K_i||, each norm averaged over the KV
heads so one block table per (request, layer) suffices.
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def _norms(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over head_dim, mean over KV heads. (..., KV, hd) -> (...,)."""
    return torch.linalg.vector_norm(x.float(), dim=-1).mean(-1)


def vk_ratio_score(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Paper Alg.1 token importance: mean_h ||V|| / mean_h ||K||.
    k, v: (..., KV, hd) -> (...,) f32."""
    return _norms(v) / _norms(k).clamp_min(_EPS)


def inverse_key_l2_score(k: torch.Tensor) -> torch.Tensor:
    """InverseKeyL2 baseline (Devoto et al. 2024): a high key norm marks a
    token to evict, so importance = -mean_h ||K||. (..., KV, hd) -> (...,)."""
    return -_norms(k)


def keydiff_score(k: torch.Tensor, key_mean: torch.Tensor) -> torch.Tensor:
    """KeyDiff baseline (Park et al. 2025): a key close to the mean key
    direction is the least diverse, so importance = -mean_h cos(k, k_mean),
    the norm product floored at 1e-6. k: (..., KV, hd); key_mean
    broadcastable to it."""
    kf, mf = k.float(), key_mean.float()
    num = (kf * mf).sum(-1)
    den = (torch.linalg.vector_norm(kf, dim=-1) *
           torch.linalg.vector_norm(mf, dim=-1)).clamp_min(_EPS)
    return -(num / den).mean(-1)


def recency_score(positions: torch.Tensor) -> torch.Tensor:
    """StreamingLLM ordering: newer = more important. positions: (...)."""
    return positions.float()


def page_scores_from_norms(kn, vn, pos_pages, mapped) -> torch.Tensor:
    """Paper Alg.1 page scores from the attention kernels' norm epilogue.

    kn, vn: (B, KV, P, page) per-token K/V L2 norms; pos_pages: (B, P, page)
    positions, -1 for empty slots (``cache.pos_view()``); mapped: (B, P)
    bool. Returns (B, P) f32; empty or unmapped pages score +inf. Plain
    torch, as in the JAX package (it runs outside the kernels there too)."""
    tok = vn.mean(1) / kn.mean(1).clamp_min(_EPS)
    valid = (pos_pages >= 0) & mapped[:, :, None]
    cnt = valid.sum(-1, dtype=torch.int32)
    ssum = torch.where(valid, tok, 0.0).sum(-1)
    return torch.where(cnt > 0, ssum / cnt.clamp_min(1), torch.inf)


def block_scores_from_token_scores(token_scores, valid, page_size: int
                                   ) -> torch.Tensor:
    """Paper Alg.1 block mode: the mean token score of each block of
    ``page_size`` tokens. token_scores, valid: (..., S) with S a multiple of
    the page size -> (..., S // page_size); empty blocks score +inf."""
    *lead, S = token_scores.shape
    if S % page_size:
        raise ValueError(f"{S} tokens are not whole blocks of {page_size}")
    ts = token_scores.reshape(*lead, S // page_size, page_size)
    vm = valid.reshape(*lead, S // page_size, page_size)
    cnt = vm.sum(-1, dtype=torch.int32)
    ssum = torch.where(vm, ts, 0.0).sum(-1)
    return torch.where(cnt > 0, ssum / cnt.clamp_min(1), torch.inf)
