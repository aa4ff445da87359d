"""Paper Algorithm 3: decode-phase block-wise compression, one token at a
time (``repro.core.decode`` of the JAX package): append K/V at the write
head, then let the policy evict and roll the page over."""
from __future__ import annotations

from repro_torch.configs.base import CacheConfig
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.core.policies import (EvictionOutcome, EvictionPolicy,
                                       plain_kw)
from repro_torch.kernels.pool_step import pool_append_cuda, pool_append_plain
from repro_torch.obs.trace import annotation


def decode_append(cache: PagedLayerCache, k_tok, v_tok, pos_tok,
                  policy: EvictionPolicy, cfg: CacheConfig,
                  active=None, attend=None, plain: bool = False
                  ) -> EvictionOutcome:
    """Append one token per request and run the policy's eviction hook.
    k_tok, v_tok: (B, KV, hd); pos_tok: (B,) int32. Updates ``cache`` in
    place and returns it with the eviction outcome.

    ``attend(cache) -> page_scores | None`` is the step's attention: it runs
    after the write and before the eviction, so that its fused score
    epilogue sees the new token and ranks the pages the policy evicts.

    On a CUDA pool the append is one launch of ``pool_append``
    (kernels/pool_step.py), which computes the policy's token score itself
    where that score is Alg. 1's ratio over this device's heads; on a CPU
    pool, or with ``plain``, it is the kernel's plain version. The write is
    the span ``decode.append`` and the policy's hook the span
    ``decode.evict``."""
    with annotation("decode.append"):
        if cache.device.type == "cuda" and not plain:
            score = None if policy.local_vk_ratio else \
                policy.write_score(k_tok, v_tok, pos_tok)
            pool_append_cuda(cache, k_tok, v_tok, pos_tok, score, active)
        else:
            pool_append_plain(cache, k_tok, v_tok, pos_tok,
                              policy.write_score(k_tok, v_tok, pos_tok),
                              active)
    page_scores = attend(cache) if attend is not None else None
    with annotation("decode.evict"):
        return policy.post_write(cache, cfg, active=active,
                                 page_scores=page_scores, **plain_kw(plain))
