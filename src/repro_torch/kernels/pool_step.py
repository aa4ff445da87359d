"""Alg. 3's per-layer pool bookkeeping of one decode step: the wrappers of
the two CUDA kernels and their plain torch versions.

``pool_append`` is the append of ``core.decode.decode_append``: the lazy
rollover of the rows whose head page is full, then the write of each active
row's token (K, V, int8 scales, position, score) at its head.
``paged_evict`` is ``PagedEviction.post_write``: the victim by the argmin of
the page scores over full pages, its eviction, then the same rollover.

The callers (``decode_append``, ``PagedEviction.post_write``) launch the
kernels on a CUDA pool, or raise; on a CPU pool, or with ``plain=True``
(an explicit switch for holding the kernels against the plain versions,
never a fallback), they run the plain versions, the torch code of
``core/paged_cache.py`` and ``core/policies.py``. The pool state a kernel
leaves is the plain version's bit for bit, the trash row aside; a token
score the append kernel computes itself (Alg. 1 over this device's heads,
``score=None``) lies within 2 ulp of ``importance.vk_ratio_score``.

The kernel source is ``csrc/pool_step.cu``: one block of 1024 threads per
launch, so that the protocol's scans and ORs are barriers, not launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.paged_cache import (PagedLayerCache, chunk_rollover,
                                          write_token)
from repro_torch.kernels import build
from repro_torch.kernels.build import INT, LONG, PTR

_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TOKEN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024


def _pool_args(cache: PagedLayerCache) -> list:
    return [cache.block_table.data_ptr(), cache.ref_count.data_ptr(),
            cache.cur_page.data_ptr(), cache.cur_off.data_ptr(),
            cache.pos_buf.data_ptr(), cache.score_buf.data_ptr()]


def _check_pool(cache: PagedLayerCache, lib, kernel: str) -> None:
    """What both kernels take: every pool tensor on the card, the int32
    tables and the positions / scores contiguous, a batch whose per-row
    state fits 48 KB of shared memory."""
    tables = (cache.block_table, cache.ref_count, cache.cur_page,
              cache.cur_off, cache.pos_buf)
    for t in tables + (cache.score_buf,):
        if not t.is_cuda:
            raise ValueError(f"{kernel}: the pool is not on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: pool tables must be contiguous")
    if any(t.dtype != torch.int32 for t in tables) or \
            cache.score_buf.dtype != torch.float32:
        raise TypeError(f"{kernel}: pool tables must be int32, scores f32")
    if cache.stats is not None and (cache.stats.dtype != torch.int32 or
                                    not cache.stats.is_cuda):
        raise TypeError(f"{kernel}: stats must be an int32 CUDA tensor")
    if lib.pool_step_smem(cache.batch) > _SMEM_LIMIT:
        raise ValueError(f"{kernel}: a batch of {cache.batch} rows does not "
                         f"fit one block's shared memory")


def _rows_mask(active, cache: PagedLayerCache, kernel: str):
    if active is None:
        return None
    if active.dtype != torch.bool or not active.is_cuda or \
            active.shape != (cache.batch,):
        raise ValueError(f"{kernel}: active must be a (B,) bool CUDA tensor")
    return active.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def pool_append_plain(cache: PagedLayerCache, k_tok, v_tok, pos_tok, score,
                      active=None) -> PagedLayerCache:
    """Plain torch version of the append kernel: roll the rows whose head is
    full onto fresh pages (``chunk_rollover``; lazy, because a chunked
    prefill parks the head full when a chunk ends on a page boundary, and
    the first decode write allocates the page), then ``write_token``.
    k_tok, v_tok: (B, KV, hd); pos_tok (B,) int32; score (B,) f32."""
    if active is None:
        active = torch.ones((cache.batch,), dtype=torch.bool,
                            device=cache.device)
    chunk_rollover(cache, active & (cache.cur_off >= cache.page_size))
    return write_token(cache, k_tok, v_tok, pos_tok, score, active=active)


def pool_append_cuda(cache: PagedLayerCache, k_tok, v_tok, pos_tok,
                     score=None, active=None) -> PagedLayerCache:
    """Launch the append kernel; the contract of :func:`pool_append_plain`,
    except that ``score=None`` makes the kernel compute Alg. 1's score of
    each token itself. Raises on an input that requires grad under
    autograd, on CPU tensors, a shape or type the kernel does not take, or
    a failed launch. ``pool_append_cuda.launches`` counts the launches."""
    build.refuse_autograd("pool_append", k_tok, v_tok)
    lib = build.load("pool_step", _SIGNATURES)
    _check_pool(cache, lib, "pool_append")
    B, P, N, page = cache.batch, cache.num_pages, cache.pool_pages, \
        cache.page_size
    KV, hd = cache.k_buf.shape[2:]
    for name, t in (("k_tok", k_tok), ("v_tok", v_tok)):
        if not t.is_cuda or t.dtype not in _TOKEN_DTYPES or \
                t.shape != (B, KV, hd) or t.stride(-1) != 1:
            raise ValueError(f"pool_append: {name} must be a float32 or "
                             f"bfloat16 CUDA tensor (B, KV, hd) = "
                             f"{(B, KV, hd)} with a contiguous head dim")
    if v_tok.dtype != k_tok.dtype:
        raise TypeError("pool_append: k_tok and v_tok dtypes differ")
    kp, vp = cache.k_buf, cache.v_buf
    if kp.dtype not in _POOL_DTYPES or kp.stride() != vp.stride() or \
            kp.stride(-1) != 1:
        raise ValueError("pool_append: the K / V pools need a float32, "
                         "bfloat16 or int8 type, equal strides and a "
                         "contiguous head dim")
    if cache.quantized and not (cache.k_scale_buf.is_contiguous() and
                                cache.v_scale_buf.is_contiguous()):
        raise ValueError("pool_append: int8 scales must be contiguous")
    pos_tok = pos_tok.to(torch.int32).contiguous()
    if score is not None:
        score = score.float().contiguous()
    active = _rows_mask(active, cache, "pool_append")
    scratch = torch.empty((B * P + N + 2 * B * KV,), dtype=torch.int32,
                          device=kp.device)
    sn, sp, skv, _ = kp.stride()
    rc = lib.pool_append(
        *_pool_args(cache), kp.data_ptr(), vp.data_ptr(),
        _ptr(cache.k_scale_buf), _ptr(cache.v_scale_buf), k_tok.data_ptr(),
        v_tok.data_ptr(), pos_tok.data_ptr(), _ptr(score), _ptr(active),
        _ptr(cache.stats), scratch.data_ptr(), B, P, N, page, KV, hd, sn, sp,
        skv, k_tok.stride(0), k_tok.stride(1), v_tok.stride(0),
        v_tok.stride(1), _POOL_DTYPES[kp.dtype], _TOKEN_DTYPES[k_tok.dtype],
        torch.cuda.current_stream(kp.device).cuda_stream)
    build.check(lib, rc, "pool_append")
    pool_append_cuda.launches += 1
    return cache


def paged_evict_cuda(cache: PagedLayerCache, budget: int, protect: bool,
                     active=None, page_scores=None):
    """Launch the eviction kernel: ``PagedEviction.post_write`` for one
    layer. ``page_scores`` (B, P) f32 ranks the pages; None ranks them by
    the stored-score means (``cache.page_scores()``, reduced by torch as the
    plain version does). Returns (pages_evicted, tokens_evicted,
    forced_evictions, victim_page, victim_score), (B,) views of one
    buffer. Raises as :func:`pool_append_cuda`;
    ``paged_evict_cuda.launches`` counts the launches."""
    lib = build.load("pool_step", _SIGNATURES)
    _check_pool(cache, lib, "paged_evict")
    B, P, N, page = cache.batch, cache.num_pages, cache.pool_pages, \
        cache.page_size
    if page_scores is None:
        page_scores = cache.page_scores()
    ps = page_scores.float().contiguous()
    if not ps.is_cuda or ps.shape != (B, P):
        raise ValueError(f"paged_evict: page_scores must be a (B, P) = "
                         f"{(B, P)} CUDA tensor")
    active = _rows_mask(active, cache, "paged_evict")
    buf = torch.empty((4 * (2 * B + B * P + N) + 3 * B,), dtype=torch.uint8,
                      device=ps.device)
    victim = buf[:4 * B].view(torch.int32)
    vscore = buf[4 * B:8 * B].view(torch.float32)
    scratch = buf[8 * B:8 * B + 4 * (B * P + N)].view(torch.int32)
    flags = buf[8 * B + 4 * (B * P + N):].view(torch.bool)
    evicted, tokens, forced = flags[:B], flags[B:2 * B], flags[2 * B:]
    rc = lib.paged_evict(
        *_pool_args(cache), _ptr(active), ps.data_ptr(), int(budget),
        int(bool(protect)), evicted.data_ptr(), tokens.data_ptr(),
        forced.data_ptr(), victim.data_ptr(), vscore.data_ptr(),
        _ptr(cache.stats), scratch.data_ptr(), B, P, N, page,
        torch.cuda.current_stream(ps.device).cuda_stream)
    build.check(lib, rc, "paged_evict")
    paged_evict_cuda.launches += 1
    return evicted, tokens, forced, victim, vscore


_SIGNATURES = {
    "pool_append": [PTR] * 17 + [INT] * 6 + [LONG] * 7 + [INT, INT, PTR],
    "paged_evict": [PTR] * 8 + [INT, INT] + [PTR] * 7 + [INT] * 4 + [PTR],
    "pool_step_smem": [INT],
}
pool_append_cuda.launches = 0
paged_evict_cuda.launches = 0
