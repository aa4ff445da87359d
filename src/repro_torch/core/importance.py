"""Token / page importance proxies (paper §4.1, Algorithm 1).

Scores follow the convention **higher = more important = keep**. The
paper's proxy is S_i = ||V_i|| / ||K_i||, each norm averaged over the KV
heads so one block table per (request, layer) suffices.

Under tensor parallelism (``group``, a ``launch.mesh.TPGroup``) each rank
holds KV/tp of the heads: the means over its local heads are averaged over
the ranks *before* any nonlinear step (the ratio, the negation, the cosine
mean), as the JAX package's ``pmean``s, so that every rank ranks by the
global score and evicts the same victim (equal local head counts make the
mean of means the mean).
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def _mean(group, *ms: torch.Tensor):
    """``ms``, means over this rank's KV heads, each averaged over the
    ranks of ``group`` in one all-reduce; themselves without a group."""
    if group is None:
        return ms
    return tuple(group.all_reduce_mean(torch.stack(ms)).unbind(0))


def _head_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over head_dim, mean over KV heads. (..., KV, hd) -> (...,)."""
    return torch.linalg.vector_norm(x.float(), dim=-1).mean(-1)


def vk_ratio_score(k: torch.Tensor, v: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Paper Alg.1 token importance: mean_h ||V|| / mean_h ||K||.
    k, v: (..., KV, hd) -> (...,) f32. Under TP both head means cross the
    ranks in one all-reduce."""
    vn, kn = _mean(group, _head_norm(v), _head_norm(k))
    return vn / kn.clamp_min(_EPS)


def inverse_key_l2_score(k: torch.Tensor, group=None) -> torch.Tensor:
    """InverseKeyL2 baseline (Devoto et al. 2024): a high key norm marks a
    token to evict, so importance = -mean_h ||K||. (..., KV, hd) -> (...,)."""
    return -_mean(group, _head_norm(k))[0]


def keydiff_score(k: torch.Tensor, key_mean: torch.Tensor,
                  group=None) -> torch.Tensor:
    """KeyDiff baseline (Park et al. 2025): a key close to the mean key
    direction is the least diverse, so importance = -mean_h cos(k, k_mean),
    the norm product floored at 1e-6. k: (..., KV, hd); key_mean
    broadcastable to it (per head: under TP each rank's own heads')."""
    kf, mf = k.float(), key_mean.float()
    num = (kf * mf).sum(-1)
    den = (torch.linalg.vector_norm(kf, dim=-1) *
           torch.linalg.vector_norm(mf, dim=-1)).clamp_min(_EPS)
    return -_mean(group, (num / den).mean(-1))[0]


def recency_score(positions: torch.Tensor) -> torch.Tensor:
    """StreamingLLM ordering: newer = more important. positions: (...)."""
    return positions.float()


def page_scores_from_norms(kn, vn, pos_pages, mapped,
                           group=None) -> torch.Tensor:
    """Paper Alg.1 page scores from the attention kernels' norm epilogue.

    kn, vn: (B, KV, P, page) per-token K/V L2 norms (of this rank's KV
    heads under TP; their means cross the ranks in one all-reduce);
    pos_pages: (B, P, page) positions, -1 for empty slots
    (``cache.pos_view()``); mapped: (B, P) bool. Returns (B, P) f32; empty
    or unmapped pages score +inf. Plain torch, as in the JAX package (it
    runs outside the kernels there too)."""
    vm, km = _mean(group, vn.mean(1), kn.mean(1))
    tok = vm / km.clamp_min(_EPS)
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
