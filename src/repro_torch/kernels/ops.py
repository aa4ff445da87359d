"""The wrappers the model calls: paged decode and paged chunked-prefill
attention over a :class:`PagedLayerCache`, each returning
``(out, page_scores | None)``; the pool's page scores; contiguous causal
flash attention.

On a CUDA tensor a wrapper launches its hand-written kernel (or raises); on
a CPU tensor it takes the kernel's plain torch version. It never falls back
from one to the other. ``plain=True`` takes the plain version on the card
too: an explicit switch for holding the kernels against it, never a
fallback. The pool is read in its native (N, page, KV, hd) strides.

``return_scores`` adds the paper's Alg.1 page scores (B, P), reduced from
the kernels' per-token ||K|| / ||V|| epilogue by ``page_scores_from_norms``
(plain torch, as in the JAX package); under tensor parallelism ``group``
(a ``launch.mesh.TPGroup``) averages its KV-head means over the ranks. The
kernels themselves take ``KV`` and ``G`` from the local shapes: a rank's
pool holds its KV/tp heads.

int8 pools: decode and chunked prefill read them natively on the card.
The decode kernel dequantizes in registers; the prefill kernel takes a bf16
query on its int8 tensor-core route (int8 pages widened to bf16 in shared
memory, the scales applied to the scores and folded into the
probabilities) and an f32 query on its int8 split-TF32 route (int8 pages
widened to f32 in shared memory as ``x * (s / 127)``; at a head dim without
a tensor-core tile, the int8 CUDA-core route, dequantized in registers).
Neither dequantizes the pool first. Their plain versions
dequantize and run the float ones, as the JAX package does for the
prefill. Page scoring (the pool pass, an oracle on no path) still
dequantizes the pool in plain torch first.
"""
from __future__ import annotations

import torch

from repro_torch.core.importance import page_scores_from_norms
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.kernels.block_score import block_score_cuda, block_score_plain
from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                               flash_attention_plain,
                                               paged_prefill_cuda,
                                               paged_prefill_int8_plain,
                                               paged_prefill_plain)
from repro_torch.kernels.paged_attention import (combine_splits,
                                                 paged_attention_cuda,
                                                 paged_attention_int8_cuda,
                                                 paged_attention_int8_plain,
                                                 paged_attention_plain)


def _scores(cache: PagedLayerCache, norms, group):
    if norms is None:
        return None
    kn, vn = norms
    return page_scores_from_norms(kn, vn, cache.pos_view(),
                                  cache.mapped_mask(), group)


def paged_attention(q, cache: PagedLayerCache, *, cur_pos, window: int = 0,
                    scale: float | None = None, num_splits: int = 1,
                    return_scores: bool = False, plain: bool = False,
                    group=None):
    """Decode attention. q: (B, H, hd) current-token queries; cur_pos: (B,)
    -> ((B, H, hd), page_scores (B, P) or None). ``num_splits``: split-K
    factor of the page walk."""
    B, H, hd = q.shape
    KV = cache.k.shape[2]
    kernel = not plain and q.is_cuda
    args = (q.reshape(B, KV, H // KV, hd), cache.k, cache.v)
    if cache.quantized:
        fn = paged_attention_int8_cuda if kernel \
            else paged_attention_int8_plain
        args += (cache.k_scale, cache.v_scale)
    else:
        fn = paged_attention_cuda if kernel else paged_attention_plain
    acc, m, l, norms = fn(*args, cache.pos, cache.block_table, cur_pos,
                          window=window, scale=scale, num_splits=num_splits,
                          return_scores=return_scores)
    out = combine_splits(acc, m, l).to(q.dtype).reshape(B, H, hd)
    return out, _scores(cache, norms, group)


def paged_prefill_attention(q, cache: PagedLayerCache, *, q_pos,
                            window: int = 0, scale: float | None = None,
                            return_scores: bool = False, plain: bool = False,
                            group=None):
    """Chunked-prefill attention (G-fold). q: (B, T, H, hd); q_pos: (B, T)
    int32, -1 == padding -> ((B, T, H, hd), page_scores (B, P) or None).
    The chunk's K/V must already be appended to the pool. An int8 pool goes
    to the kernel as int8 values and scales (never dequantized first)."""
    kernel = not plain and q.is_cuda
    kw = dict(window=window, scale=scale, return_scores=return_scores)
    args = (cache.pos, cache.block_table, q_pos)
    if not cache.quantized:
        fn = paged_prefill_cuda if kernel else paged_prefill_plain
        out, norms = fn(q, cache.k, cache.v, *args, **kw)
    elif kernel:
        out, norms = paged_prefill_cuda(q, cache.k, cache.v, *args,
                                        k_scale=cache.k_scale,
                                        v_scale=cache.v_scale, **kw)
    else:
        out, norms = paged_prefill_int8_plain(q, cache.k, cache.v,
                                              cache.k_scale, cache.v_scale,
                                              *args, **kw)
    return out, _scores(cache, norms, group)


def page_scores(cache: PagedLayerCache) -> torch.Tensor:
    """Standalone Alg.1 page scoring (B, P) f32: each physical page is
    scored once on the (dequantized) pool, then gathered through the block
    tables; unmapped slots +inf. The oracle of the fused epilogue."""
    k, v = cache.k_dequant(), cache.v_dequant()
    fn = block_score_cuda if k.is_cuda else block_score_plain
    pool = fn(k, v, cache.pos)                                  # (N,)
    return torch.where(cache.mapped_mask(), pool[cache._phys()], torch.inf)


def flash_attention(q, k, v, *, window: int = 0, scale: float | None = None,
                    plain: bool = False):
    """Causal GQA flash attention (causal by index). q: (B, S, H, hd);
    k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    fn = flash_attention_plain if plain or not q.is_cuda \
        else flash_attention_cuda
    return fn(q, k, v, window=window, scale=scale)
