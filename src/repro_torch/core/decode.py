"""Paper Algorithm 3: decode-phase block-wise compression, one token at a
time (``repro.core.decode`` of the JAX package): append K/V at the write
head, then let the policy evict and roll the page over."""
from __future__ import annotations

import torch

from repro_torch.configs.base import CacheConfig
from repro_torch.core.paged_cache import (PagedLayerCache, chunk_rollover,
                                          write_token)
from repro_torch.core.policies import EvictionOutcome, EvictionPolicy
from repro_torch.obs.trace import annotation


def decode_append(cache: PagedLayerCache, k_tok, v_tok, pos_tok,
                  policy: EvictionPolicy, cfg: CacheConfig,
                  active=None, attend=None) -> EvictionOutcome:
    """Append one token per request and run the policy's eviction hook.
    k_tok, v_tok: (B, KV, hd); pos_tok: (B,) int32. Updates ``cache`` in
    place and returns it with the eviction outcome.

    ``attend(cache) -> page_scores | None`` is the step's attention: it runs
    after the write and before the eviction, so that its fused score
    epilogue sees the new token and ranks the pages the policy evicts.

    The write is the span ``decode.append`` and the policy's hook the span
    ``decode.evict``."""
    with annotation("decode.append"):
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        score = policy.write_score(k_tok, v_tok, pos_tok)
        # lazy rollover: a chunked prefill parks the head full when a chunk
        # ends on a page boundary; the first decode write allocates the page
        chunk_rollover(cache, active & (cache.cur_off >= cache.page_size))
        write_token(cache, k_tok, v_tok, pos_tok, score, active=active)
    page_scores = attend(cache) if attend is not None else None
    with annotation("decode.evict"):
        return policy.post_write(cache, cfg, active=active,
                                 page_scores=page_scores)
