"""Paper Algorithm 2, one-shot form: prefill-phase token compression.

After the prompt's forward pass produces contiguous K/V for a layer, the
policy selects the tokens that survive (budget C), *then* the survivors are
divided into pages, so no data moves across pages (paper §4.2). The result
is a ready-to-decode :class:`PagedLayerCache`, as ``repro.core.prefill``
builds it in the JAX package. The serving path compresses incrementally
instead (``EvictionPolicy.chunk_prefill_evict``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CacheConfig
from repro_torch.core.paged_cache import (PagedLayerCache, init_layer_cache,
                                          write_prompt_pages)
from repro_torch.core.policies import EvictionPolicy, top_k_sorted


def compress_and_page(k, v, positions, valid, policy: EvictionPolicy,
                      cfg: CacheConfig, seq_len_hint: int | None = None,
                      cache_dtype=None) -> PagedLayerCache:
    """Build a paged cache from contiguous prompt K/V, on ``k``'s device.

    k, v      : (B, S, KV, hd)  (RoPE already applied to k)
    positions : (B, S) int32 original token positions
    valid     : (B, S) bool     (padding mask of ragged prompts)
    cache_dtype: the pool's dtype ("int8" quantizes); default k's."""
    B, S, KV, hd = k.shape
    page = cfg.page_size
    num_pages = policy.slab_pages(cfg, seq_len_hint or S)

    idx, scores = policy.prefill_keep(k, v, positions, valid, cfg)
    idx = idx.long()
    keep = idx.shape[1]
    # slab-capacity cap: windowed layers size their slab to the attention
    # window, which can be smaller than the policy's keep set
    cap = num_pages * page
    if keep > cap:
        sub = top_k_sorted(scores.gather(1, idx), cap)
        idx = idx.gather(1, sub)
        keep = cap

    take = lambda a: a.gather(1, idx.reshape(B, keep, *([1] * (a.ndim - 2)))
                              .expand(B, keep, *a.shape[2:]))
    k_sel, v_sel = take(k), take(v)
    pos_sel = positions.gather(1, idx)
    score_sel = scores.gather(1, idx)
    # -inf marks padding / unselectable; +inf is a legitimate score
    valid_sel = valid.gather(1, idx) & ~torch.isneginf(score_sel)
    pos_sel = torch.where(valid_sel, pos_sel, -1)

    pad = (-keep) % page
    if pad:
        k_sel = F.pad(k_sel, (0, 0, 0, 0, 0, pad))
        v_sel = F.pad(v_sel, (0, 0, 0, 0, 0, pad))
        pos_sel = F.pad(pos_sel, (0, pad), value=-1)
        score_sel = F.pad(score_sel, (0, pad), value=-torch.inf)

    cache = init_layer_cache(B, num_pages, page, KV, hd,
                             cache_dtype or k.dtype, device=k.device)
    return write_prompt_pages(cache, k_sel, v_sel, pos_sel, score_sel)
