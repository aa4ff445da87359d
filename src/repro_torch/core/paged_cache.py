"""Paged KV cache: one physical page pool shared by every request.

The torch counterpart of the JAX package's ``repro.core.paged_cache``, with
the same layout and the same mutators, bit-equal on every integer field.

Layout (per attention layer):
    k, v        : (N, page, KV, hd)   the shared physical page pool
    pos         : (N, page) int32     original token position; -1 invalid
    score       : (N, page) float32   per-token policy score (higher==keep)
    block_table : (B, P) int32        logical page -> physical page; -1 unmapped
    ref_count   : (N,) int32          block-table entries mapping the page;
                                      0 == on the free list
    cur_page, cur_off : (B,) int32    write head (LOGICAL slot, offset)
    k_scale, v_scale  : (N, page, KV) f32  int8 pools only: absmax scale per
                                      (token, head); K = int8 * scale / 127

Differences from the JAX package, all invisible at the public layout:

- **In place.** Mutators update the cache's tensors in place (the pool is
  the bulk of device memory; a functional copy per step would double it)
  and return the cache for chaining.
- **Trash row.** JAX drops scatters to the out-of-bounds index ``N``; torch
  raises (CPU) or device-asserts (CUDA). The pool tensors therefore hold
  ``N + 1`` rows and ``k``/``v``/``pos``/``score`` are views of the first
  ``N``: every masked write lands in row ``N``, which nothing reads.
- **Branch-free.** Where JAX skips work under ``lax.cond(any(mask))``, the
  port masks, so no step waits on the host for a decision. The one piece
  that is not an identity under an all-False mask, the empty-page reclaim
  of a rollover, takes the ``any`` as a device-side gate.
- **Chunked append by runs.** ``append_chunk`` writes each run of tokens up
  to the next page boundary in one scatter and rolls over only at the
  boundaries (``rollover_times``), instead of JAX's per-token scan.

Invariants: F1 allocated + free == N; F2 ref_count[p] == number of
block-table entries mapping p; F3 no page mapped twice by one block table;
F4 free pages hold no live tokens.

Sharing semantics: shared pages are COMPLETE prompt pages and immutable;
page-level eviction of a shared page is an unmap, token-level eviction
copy-on-write forks first (:func:`fork_page`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import devstats
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import dequantize


@dataclass
class PagedLayerCache:
    k_buf: torch.Tensor        # (N + 1, page, KV, hd); row N is the trash row
    v_buf: torch.Tensor        # (N + 1, page, KV, hd)
    pos_buf: torch.Tensor      # (N + 1, page) int32
    score_buf: torch.Tensor    # (N + 1, page) f32
    block_table: torch.Tensor  # (B, P) int32, -1 unmapped
    ref_count: torch.Tensor    # (N,) int32, 0 == free
    cur_page: torch.Tensor     # (B,) int32 logical slot
    cur_off: torch.Tensor      # (B,) int32
    stats: torch.Tensor | None = None  # (devstats.NSTATS,) int32; None == off
    # int8 pools: (N + 1, page, KV) f32 absmax scales; None when not quantized
    k_scale_buf: torch.Tensor | None = None
    v_scale_buf: torch.Tensor | None = None

    # ---------------------------------------------------------- pool views
    @property
    def k(self) -> torch.Tensor:
        return self.k_buf[:-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[:-1]

    @property
    def pos(self) -> torch.Tensor:
        return self.pos_buf[:-1]

    @property
    def score(self) -> torch.Tensor:
        return self.score_buf[:-1]

    @property
    def k_scale(self) -> torch.Tensor | None:
        return None if self.k_scale_buf is None else self.k_scale_buf[:-1]

    @property
    def v_scale(self) -> torch.Tensor | None:
        return None if self.v_scale_buf is None else self.v_scale_buf[:-1]

    # ------------------------------------------------------- quantization
    @property
    def quantized(self) -> bool:
        return self.k_scale_buf is not None

    def k_dequant(self) -> torch.Tensor:
        """The K pool (N, page, KV, hd) in f32 when quantized, else as is
        (``kernels.paged_attention.dequantize``)."""
        if not self.quantized:
            return self.k
        return dequantize(self.k, self.k_scale)

    def v_dequant(self) -> torch.Tensor:
        if not self.quantized:
            return self.v
        return dequantize(self.v, self.v_scale)

    # ------------------------------------------------------------ derived
    @property
    def batch(self) -> int:
        return self.block_table.shape[0]

    @property
    def num_pages(self) -> int:
        """Logical pages per request (block-table width)."""
        return self.block_table.shape[1]

    @property
    def pool_pages(self) -> int:
        """Physical pages in the shared pool (the trash row excluded)."""
        return self.k_buf.shape[0] - 1

    @property
    def page_size(self) -> int:
        return self.k_buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.block_table.device

    # -------------------------------------------------- block-table views
    def mapped_mask(self) -> torch.Tensor:
        """(B, P) bool: which logical slots hold a physical page."""
        return self.block_table >= 0

    def _phys(self) -> torch.Tensor:
        """(B, P) int64: physical ids, clamped to 0 where unmapped."""
        return self.block_table.clamp_min(0).long()

    def gather_pages(self, pool_arr: torch.Tensor) -> torch.Tensor:
        """(N, page, ...) pool data -> (B, P, page, ...) through the block
        table. Unmapped slots carry page 0's data: mask with pos_view()."""
        return pool_arr[self._phys()]

    def pos_view(self) -> torch.Tensor:
        """(B, P, page) int32: per-request positions; -1 where unmapped."""
        return torch.where(self.mapped_mask()[..., None],
                           self.gather_pages(self.pos), -1)

    def score_view(self) -> torch.Tensor:
        """(B, P, page) f32: per-request scores; -inf where unmapped."""
        return torch.where(self.mapped_mask()[..., None],
                           self.gather_pages(self.score), -torch.inf)

    def k_view(self) -> torch.Tensor:
        """(B, P, page, KV, hd) dequantized per-request K (garbage where
        unmapped: mask with valid_mask())."""
        return self.gather_pages(self.k_dequant())

    def v_view(self) -> torch.Tensor:
        return self.gather_pages(self.v_dequant())

    def head_mapped(self) -> torch.Tensor:
        """(B,) bool: the write head's logical slot holds a page."""
        b = torch.arange(self.batch, device=self.device)
        return self.block_table[b, self.cur_page.long()] >= 0

    # ----------------------------------------------------- token accounting
    def valid_mask(self) -> torch.Tensor:
        return self.pos_view() >= 0

    def tokens_per_page(self) -> torch.Tensor:
        """(B, P) int32: live tokens in each logical page."""
        return self.valid_mask().sum(-1, dtype=torch.int32)

    def total_valid(self) -> torch.Tensor:
        """(B,) int32: live tokens per request."""
        return self.valid_mask().sum((1, 2), dtype=torch.int32)

    def page_scores(self) -> torch.Tensor:
        """(B, P) f32: mean stored token score per page (paper Alg. 1, block
        mode); pages with no valid tokens score +inf."""
        valid = self.valid_mask()
        cnt = valid.sum(-1, dtype=torch.int32)
        ssum = torch.where(valid, self.score_view(), 0.0).sum(-1)
        return torch.where(cnt > 0, ssum / cnt.clamp_min(1), torch.inf)

    # --------------------------------------------------------- free list
    def free_mask(self) -> torch.Tensor:
        return self.ref_count == 0

    def num_free(self) -> torch.Tensor:
        """() int32: pages on the free list."""
        return self.free_mask().sum(dtype=torch.int32)


def quantize_absmax(x: torch.Tensor):
    """x: (..., hd) -> (int8 values, (...,) f32 absmax scales). The order of
    the JAX package (divide, scale by 127, round half to even, clip), so
    equal inputs give bit-equal int8 values."""
    xf = x.float()
    scale = xf.abs().amax(-1)
    q = torch.round(xf / scale.clamp_min(1e-8)[..., None] * 127.0)
    return q.clamp(-127, 127).to(torch.int8), scale


def init_layer_cache(batch: int, num_pages: int, page_size: int,
                     num_kv_heads: int, head_dim: int, dtype,
                     pool_pages: int | None = None, track_stats: bool = False,
                     device=None) -> PagedLayerCache:
    """Empty cache: a pool of ``pool_pages`` (default batch*num_pages)
    physical pages, block tables of ``num_pages`` logical slots; slot 0 of
    request b is pre-mapped to physical page b. ``dtype`` "int8" (or
    torch.int8) makes a quantized pool with per-(token, head) scales.
    ``device``: default CUDA (raises without a card).

    A pool smaller than ``batch * num_pages`` (at least ``batch``) is
    allowed, as in JAX: a rollover may then find no free page, and the
    callers of :func:`append_chunk` check every token index for one
    (:func:`rollover_times` is exact only for full-size pools)."""
    N = pool_pages if pool_pages is not None else batch * num_pages
    if N < batch:
        raise ValueError(f"pool of {N} pages cannot give each of {batch} "
                         f"rows its working page")
    device = resolve_device(device)
    quantized = dtype in ("int8", torch.int8)
    dtype = torch.int8 if quantized else dtype
    shape = (N + 1, page_size, num_kv_heads, head_dim)
    sshape = (N + 1, page_size, num_kv_heads)
    bt = torch.full((batch, num_pages), -1, dtype=torch.int32, device=device)
    bt[:, 0] = torch.arange(batch, dtype=torch.int32, device=device)
    ref = torch.zeros((N,), dtype=torch.int32, device=device)
    ref[:batch] = 1
    return PagedLayerCache(
        k_buf=torch.zeros(shape, dtype=dtype, device=device),
        v_buf=torch.zeros(shape, dtype=dtype, device=device),
        pos_buf=torch.full((N + 1, page_size), -1, dtype=torch.int32,
                           device=device),
        score_buf=torch.full((N + 1, page_size), -torch.inf,
                             dtype=torch.float32, device=device),
        block_table=bt,
        ref_count=ref,
        cur_page=torch.zeros((batch,), dtype=torch.int32, device=device),
        cur_off=torch.zeros((batch,), dtype=torch.int32, device=device),
        stats=devstats.zeros(device) if track_stats else None,
        k_scale_buf=torch.zeros(sshape, dtype=torch.float32, device=device)
        if quantized else None,
        v_scale_buf=torch.zeros(sshape, dtype=torch.float32, device=device)
        if quantized else None,
    )


def _rows(cache: PagedLayerCache) -> torch.Tensor:
    return torch.arange(cache.batch, device=cache.device)


def _true(cache: PagedLayerCache) -> torch.Tensor:
    return torch.ones((cache.batch,), dtype=torch.bool, device=cache.device)


# ---------------------------------------------------------------------------
# free-list allocator
# ---------------------------------------------------------------------------
# Scatter targets use the pool size N as the masked-out sentinel: ref_count
# updates go through an (N + 1,) scratch, pool writes through the trash row.

def _count_at(cache: PagedLayerCache, tgt: torch.Tensor) -> torch.Tensor:
    """(N,) int32: how many entries of ``tgt`` (flat physical ids, N ==
    masked) hit each page. Duplicates accumulate."""
    N = cache.pool_pages
    tgt = tgt.reshape(-1).long()
    cnt = torch.zeros((N + 1,), dtype=torch.int32, device=cache.device)
    cnt.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return cnt[:N]


def alloc_pages(cache: PagedLayerCache, need):
    """Pop one free physical page per request where ``need`` (B,) bool.
    Returns (cache, phys (B,) int32, ok (B,) bool); ``phys`` is N where not
    ok. The i-th needing request receives the i-th lowest free page."""
    N = cache.pool_pages
    csum = torch.cumsum(cache.free_mask().long(), 0)
    rank = torch.cumsum(need.long(), 0) - 1
    ok = need & (rank < csum[-1])
    found = torch.searchsorted(csum, rank + 1, side="left")
    phys = torch.where(ok, found, N).to(torch.int32)
    cache.ref_count += _count_at(cache, phys)
    devstats.bump(cache.stats, devstats.PAGES_ALLOCATED, ok)
    return cache, phys, ok


def _unref_pages(cache: PagedLayerCache, tgt) -> PagedLayerCache:
    """Release one reference per entry of ``tgt`` (flat physical ids; N is
    the sentinel). The single funnel for every release path: decrements
    clamp at 0, and pos/score are invalidated only for pages whose count
    reaches 0 (a page another block table still maps stays intact)."""
    dec = _count_at(cache, tgt)
    ref = cache.ref_count
    new_ref = (ref - dec).clamp_min(0)
    newly_free = (dec > 0) & (ref > 0) & (new_ref == 0)
    devstats.bump(cache.stats, devstats.PAGES_RELEASED,
                  torch.minimum(dec, ref))
    devstats.bump(cache.stats, devstats.PAGES_FREED, newly_free)
    cache.pos.masked_fill_(newly_free[:, None], -1)
    cache.score.masked_fill_(newly_free[:, None], -torch.inf)
    ref.copy_(new_ref)
    return cache


def _free_phys(cache: PagedLayerCache, phys, enable) -> PagedLayerCache:
    return _unref_pages(cache, torch.where(enable, phys, cache.pool_pages))


def find_free_slot(cache: PagedLayerCache):
    """(B,) first UNMAPPED logical slot per request + (B,) bool existence."""
    unmapped = ~cache.mapped_mask()
    idx = torch.argmax(unmapped.to(torch.int32), dim=-1).to(torch.int32)
    return idx, unmapped.any(-1)


def start_new_page(cache: PagedLayerCache, slot, phys, enable=None
                   ) -> PagedLayerCache:
    """Map logical ``slot`` -> physical ``phys`` and move the head there."""
    b = _rows(cache)
    if enable is None:
        enable = _true(cache)
    s = slot.long()
    cache.block_table[b, s] = torch.where(enable, phys.to(torch.int32),
                                          cache.block_table[b, s])
    cache.cur_page.copy_(torch.where(enable, slot.to(torch.int32),
                                     cache.cur_page))
    cache.cur_off.masked_fill_(enable, 0)
    return cache


def reclaim_empty_pages(cache: PagedLayerCache, include_current=None,
                        gate=None) -> PagedLayerCache:
    """Unmap every logical slot whose page holds zero live tokens and
    release its page. The current write page is exempt unless
    ``include_current`` (B,) says the row is rolling over anyway. ``gate``
    (0-d bool tensor) disables the whole reclaim when False: it stands in
    for the ``lax.cond`` the JAX callers wrap around it."""
    B, P = cache.block_table.shape
    if include_current is None:
        include_current = torch.zeros((B,), dtype=torch.bool,
                                      device=cache.device)
    is_cur = torch.arange(P, device=cache.device)[None, :] == \
        cache.cur_page[:, None]
    dead = cache.mapped_mask() & (cache.tokens_per_page() == 0) & \
        (~is_cur | include_current[:, None])
    if gate is not None:
        dead &= gate
    _unref_pages(cache, torch.where(dead, cache._phys(), cache.pool_pages))
    cache.block_table.masked_fill_(dead, -1)
    return cache


# ---------------------------------------------------------------------------
# writes
# ---------------------------------------------------------------------------

def _write_run(cache: PagedLayerCache, k, v, pos, score, act
               ) -> PagedLayerCache:
    """Append a run of L tokens per request at the write head, with NO
    rollover inside the run. k, v: (B, L, KV, hd); pos/score/act: (B, L).
    Row b's active tokens land at offsets cur_off[b], cur_off[b] + 1, ...
    of its head page when that page is mapped; like JAX, offsets past the
    page end are dropped but still advance the head."""
    B, L = act.shape
    page = cache.page_size
    b = _rows(cache)
    phys = cache.block_table[b, cache.cur_page.long()]               # (B,)
    ok = act & (phys >= 0)[:, None]                                  # (B, L)
    oki = ok.to(torch.int32)
    off = cache.cur_off[:, None] + torch.cumsum(oki, 1, dtype=torch.int32) \
        - oki
    land = ok & (off < page)
    tgt = torch.where(land, phys[:, None], cache.pool_pages).long().reshape(-1)
    o = torch.where(land, off, 0).long().reshape(-1)
    KV, hd = k.shape[-2:]
    k, v = k.reshape(B * L, KV, hd), v.reshape(B * L, KV, hd)
    if cache.quantized:
        # per (token, head), as the JAX package's per-token write_token
        k, ks = quantize_absmax(k)
        v, vs = quantize_absmax(v)
        cache.k_scale_buf.index_put_((tgt, o), ks)
        cache.v_scale_buf.index_put_((tgt, o), vs)
    cache.k_buf.index_put_((tgt, o), k.to(cache.k_buf.dtype))
    cache.v_buf.index_put_((tgt, o), v.to(cache.v_buf.dtype))
    cache.pos_buf.index_put_((tgt, o), pos.reshape(-1).to(torch.int32))
    cache.score_buf.index_put_((tgt, o), score.reshape(-1).float())
    cache.cur_off += oki.sum(1, dtype=torch.int32)
    devstats.bump(cache.stats, devstats.TOKENS_WRITTEN, ok)
    return cache


def write_token(cache: PagedLayerCache, k_tok, v_tok, pos_tok, score_tok,
                active=None) -> PagedLayerCache:
    """Append one token per request at the write head. k_tok, v_tok:
    (B, KV, hd); pos_tok: (B,); score_tok: (B,); ``active`` (B,) bool."""
    if active is None:
        active = _true(cache)
    return _write_run(cache, k_tok[:, None], v_tok[:, None],
                      pos_tok[:, None], score_tok[:, None], active[:, None])


def write_prompt_pages(cache: PagedLayerCache, k_sel, v_sel, pos_sel,
                       score_sel) -> PagedLayerCache:
    """Bulk-write C selected prompt tokens (already compressed by the
    prefill policy) into logical pages [0, C / page). C must be a multiple
    of the page size. RESETS the whole cache: every row is rewritten and
    all previous mappings are dropped. A wholesale reset, it emits no
    devstats events (the engine's step never calls it; it is the one-shot
    path's).

    Placement is row-major over the first B * (n + 1) pool pages: row b's
    prompt page j goes to physical page b * stride + j, and one more page
    per row is mapped, empty, as the decode working page wherever the block
    table has room (else the head parks full on the last page).

    k_sel, v_sel: (B, C, KV, hd); pos_sel: (B, C) (-1 = padding);
    score_sel: (B, C)."""
    B, C = pos_sel.shape
    page, P, N = cache.page_size, cache.num_pages, cache.pool_pages
    if C % page:
        raise ValueError(f"{C} tokens do not fill whole pages of {page}")
    n = C // page
    extra = 1 if n < P else 0
    stride = n + extra
    if n > P or B * stride > N:
        raise ValueError(f"{B} rows of {n} + {extra} pages do not fit "
                         f"{P} slots / a pool of {N} pages")
    dev = cache.device
    KV, hd = k_sel.shape[2], k_sel.shape[3]
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * stride
    phys = rows + torch.arange(stride, dtype=torch.int32, device=dev)[None, :]
    idx = (rows + torch.arange(n, dtype=torch.int32, device=dev)[None, :]
           ).reshape(-1).long()
    k_sel = k_sel.reshape(B * n, page, KV, hd)
    v_sel = v_sel.reshape(B * n, page, KV, hd)
    for buf in (cache.k_buf, cache.v_buf, cache.k_scale_buf,
                cache.v_scale_buf):
        if buf is not None:
            buf.zero_()
    if cache.quantized:
        k_sel, ks = quantize_absmax(k_sel)
        v_sel, vs = quantize_absmax(v_sel)
        cache.k_scale_buf[idx] = ks
        cache.v_scale_buf[idx] = vs
    cache.k_buf[idx] = k_sel.to(cache.k_buf.dtype)
    cache.v_buf[idx] = v_sel.to(cache.v_buf.dtype)
    pos_pages = pos_sel.reshape(B * n, page).to(torch.int32)
    cache.pos_buf.fill_(-1)
    cache.pos_buf[idx] = pos_pages
    cache.score_buf.fill_(-torch.inf)
    cache.score_buf[idx] = torch.where(
        pos_pages >= 0, score_sel.reshape(B * n, page).float(), -torch.inf)
    cache.block_table.fill_(-1)
    cache.block_table[:, :stride] = phys
    cache.ref_count.zero_()
    cache.ref_count[phys.reshape(-1).long()] = 1
    cache.cur_page.fill_(min(n, P - 1))
    cache.cur_off.fill_(0 if extra else page)
    return cache


# ---------------------------------------------------------------------------
# page-level operations (used by eviction policies)
# ---------------------------------------------------------------------------

def evict_page(cache: PagedLayerCache, page_idx, enable=None
               ) -> PagedLayerCache:
    """Evict one LOGICAL page per request: release its physical page and
    unmap the slot. page_idx: (B,) int32; ``enable``: (B,) bool."""
    b = _rows(cache)
    if enable is None:
        enable = _true(cache)
    s = page_idx.long()
    phys = cache.block_table[b, s]
    en = enable & (phys >= 0)
    _free_phys(cache, phys.clamp_min(0), en)
    cache.block_table[b, s] = torch.where(en, -1, phys)
    devstats.bump(cache.stats, devstats.PAGES_EVICTED, en)
    return cache


def fork_page(cache: PagedLayerCache, slot, enable=None):
    """Copy-on-write fork where ``enable`` and the page at logical ``slot``
    is shared (ref_count > 1): copy it onto a fresh page, remap this row's
    slot to the copy, release one reference on the original. Returns
    (cache, forked (B,) bool); a dry pool leaves the row un-forked."""
    b = _rows(cache)
    N = cache.pool_pages
    if enable is None:
        enable = _true(cache)
    s = slot.long()
    phys = cache.block_table[b, s]
    src = phys.clamp_min(0).long()
    need = enable & (phys >= 0) & (cache.ref_count[src] > 1)
    _, newp, ok = alloc_pages(cache, need)
    do = need & ok
    tgt = torch.where(do, newp, N).long()
    for buf in (cache.k_buf, cache.v_buf, cache.pos_buf, cache.score_buf,
                cache.k_scale_buf, cache.v_scale_buf):
        if buf is not None:
            buf.index_put_((tgt,), buf[src])
    cache.block_table[b, s] = torch.where(do, newp, phys)
    devstats.bump(cache.stats, devstats.PAGES_FORKED, do)
    return _unref_pages(cache, torch.where(do, src, N)), do


def _shared_slots(cache: PagedLayerCache) -> torch.Tensor:
    """(B, P) bool: slots whose page more than one block table maps."""
    return cache.mapped_mask() & (cache.ref_count[cache._phys()] > 1)


def _cow_slots_mask(cache: PagedLayerCache, slot_mask) -> PagedLayerCache:
    """Fork, per row, the FIRST slot of the (B, P) mask whose page is
    shared (at most one fork per row per call: lazy CoW)."""
    hit = slot_mask & _shared_slots(cache)
    slot = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    fork_page(cache, slot, enable=hit.any(-1))
    return cache


def evict_token(cache: PagedLayerCache, flat_idx, enable=None
                ) -> PagedLayerCache:
    """Invalidate one token per request at flattened LOGICAL (P*page)
    index ``flat_idx`` (B,), forking a shared page first; a starved fork
    skips the eviction this round."""
    b = _rows(cache)
    page = cache.page_size
    N = cache.pool_pages
    if enable is None:
        enable = _true(cache)
    pi, oi = flat_idx // page, (flat_idx % page).long()
    fork_page(cache, pi, enable=enable)
    phys = cache.block_table[b, pi.long()]
    en = enable & (phys >= 0) & \
        (cache.ref_count[phys.clamp_min(0).long()] <= 1)
    tgt = torch.where(en, phys.clamp_min(0), N).long()
    live = en & (cache.pos_buf[tgt.clamp_max(N - 1), oi] >= 0)
    cache.pos_buf[tgt, oi] = -1
    cache.score_buf[tgt, oi] = -torch.inf
    devstats.bump(cache.stats, devstats.TOKENS_EVICTED, live)
    return cache


# ---------------------------------------------------------------------------
# chunked append (prefill writes straight into the shared pool)
# ---------------------------------------------------------------------------

def release_rows(cache: PagedLayerCache, enable) -> PagedLayerCache:
    """Release EVERY page the selected rows map (their request retired) and
    park their heads full on the unmapped slot 0."""
    dead = cache.mapped_mask() & enable[:, None]
    _unref_pages(cache, torch.where(dead, cache._phys(), cache.pool_pages))
    cache.block_table.masked_fill_(dead, -1)
    cache.cur_page.masked_fill_(enable, 0)
    cache.cur_off.masked_fill_(enable, cache.page_size)
    return cache


def adopt_prefix(cache: PagedLayerCache, src, n_pages, enable=None
                 ) -> PagedLayerCache:
    """Map the first ``n_pages`` logical slots of row ``src`` into each
    enabled row's block table, bumping the shared pages' ref counts; the
    head parks full on the last adopted slot. src: (B,) int32 (-1 == no
    sharing); n_pages: (B,) int32. Preconditions as in the JAX package:
    the row was just released and the source's slots hold full pages."""
    B, P = cache.block_table.shape
    if enable is None:
        enable = _true(cache)
    en = enable & (src >= 0) & (n_pages > 0)
    src_bt = cache.block_table[src.clamp_min(0).long()]             # copy
    take = en[:, None] & \
        (torch.arange(P, device=cache.device)[None, :] < n_pages[:, None]) & \
        (src_bt >= 0)
    cache.block_table.copy_(torch.where(take, src_bt, cache.block_table))
    cache.ref_count += _count_at(
        cache, torch.where(take, src_bt.clamp_min(0), cache.pool_pages))
    devstats.bump(cache.stats, devstats.PAGES_ADOPTED, take)
    cache.cur_page.copy_(torch.where(en, (n_pages - 1).clamp_min(0)
                                     .to(torch.int32), cache.cur_page))
    cache.cur_off.masked_fill_(en, cache.page_size)
    return cache


def rollover_to_free_page(cache: PagedLayerCache, need, gate=None):
    """Where ``need``, move the write head onto a fresh physical page:
    reclaim emptied pages, take the first unmapped slot, pop a free page,
    map it. A row with no unmapped slot or no free page force-evicts its
    fewest-token (> 0) non-current page, preferring exclusive pages.
    ``gate`` is forwarded to the reclaim (see reclaim_empty_pages); every
    other step is the identity where ``need`` is False.
    Returns (cache, must_force (B,) bool)."""
    reclaim_empty_pages(cache, include_current=need, gate=gate)
    slot, slot_ok = find_free_slot(cache)
    rank = torch.cumsum(need.long(), 0) - 1
    phys_ok = rank < cache.num_free()
    must_force = need & (~slot_ok | ~phys_ok)
    tpp = cache.tokens_per_page().float()
    P = tpp.shape[1]
    is_cur = torch.arange(P, device=cache.device)[None, :] == \
        cache.cur_page[:, None]
    shared_penalty = torch.where(_shared_slots(cache), 1e6, 0.0)
    cand = torch.where((tpp > 0) & ~is_cur, tpp + shared_penalty, torch.inf)
    victim = torch.argmin(cand, dim=-1).to(torch.int32)
    devstats.bump(cache.stats, devstats.FORCED_EVICTIONS, must_force)
    evict_page(cache, victim, enable=must_force)
    slot2, _ = find_free_slot(cache)
    slot = torch.where(must_force, slot2, slot)
    _, phys, ok = alloc_pages(cache, need)
    return start_new_page(cache, slot, phys, enable=need & ok), must_force


def chunk_rollover(cache: PagedLayerCache, need) -> PagedLayerCache:
    """Where ``need``, roll the head onto a fresh page; nothing at all
    happens when no row needs it (JAX: ``lax.cond(any(need))``)."""
    return rollover_to_free_page(cache, need, gate=need.any())[0]


def rollover_times(cur_off, head_mapped, n_tok, page_size: int) -> list[int]:
    """Host-side plan for :func:`append_chunk`: the token indices t at which
    some row's head is full (``cur_off >= page``) when its token t arrives.

    cur_off, head_mapped, n_tok: (B,) host arrays describing the heads just
    before the append. Row b rolls over first at t = 0 when its head is
    full, or after ``page - cur_off`` tokens when its head page is mapped
    (an unmapped head with room never lands a token, so never fills), then
    every ``page`` tokens while t < n_tok[b].

    Exact when the pool holds at least B * P pages: every rollover then
    moves the head. A row with no unmapped slot (token-level holes keep
    every slot mapped) or no free page force-evicts one of its own pages
    first, so it maps at most P - 1 pages, and the pool keeps a free page
    for each row that needs one. In a smaller pool a rollover can fail and
    leave the head full; callers then check every token index
    (:func:`append_plan`)."""
    times: set[int] = set()
    for off, mapped, n in zip(np.asarray(cur_off).tolist(),
                              np.asarray(head_mapped).tolist(),
                              np.asarray(n_tok).tolist()):
        if n <= 0:
            continue
        if off >= page_size:
            first = 0
        elif mapped:
            first = page_size - off
        else:
            continue
        times.update(range(first, n, page_size))
    return sorted(times)


def append_plan(cache: PagedLayerCache, cur_off, head_mapped, n_tok,
                T: int) -> list[int]:
    """The token indices at which :func:`append_chunk` checks for a
    rollover: :func:`rollover_times` in a pool of at least B * P pages,
    else every index below T (a check where no row's head is full is the
    identity)."""
    if cache.pool_pages < cache.batch * cache.num_pages:
        return list(range(T))
    return rollover_times(cur_off, head_mapped, n_tok, cache.page_size)


def append_chunk(cache: PagedLayerCache, k_chunk, v_chunk, pos_chunk,
                 score_chunk, n_tok, times: list[int]) -> PagedLayerCache:
    """Append up to T tokens per request at the write head, rolling onto
    fresh pages from the shared free list as pages fill.

    k_chunk, v_chunk: (B, T, KV, hd); pos_chunk: (B, T) int32 (-1 past
    n_tok); score_chunk: (B, T) f32; n_tok: (B,) int32.

    Equal, bit for bit, to the JAX per-token scan (rollover of the rows
    whose head is full, then write token t): the runs between consecutive
    rollover times hold no boundary, so each is one scatter, and the
    rollovers happen in the same order. ``times`` is the host plan of
    :func:`append_plan`, made by the caller from the heads as they stand
    before this append (the step reads them once for every layer)."""
    B, T = pos_chunk.shape
    page = cache.page_size
    act = torch.arange(T, device=cache.device)[None, :] < n_tok[:, None]
    t0 = 0
    for t in list(times) + [T]:
        if t > t0:
            _write_run(cache, k_chunk[:, t0:t], v_chunk[:, t0:t],
                       pos_chunk[:, t0:t], score_chunk[:, t0:t],
                       act[:, t0:t])
        if t < T:
            chunk_rollover(cache, act[:, t] & (cache.cur_off >= page))
        t0 = t
    return cache


# ---------------------------------------------------------------------------
# masked bulk eviction (chunk-boundary compression)
# ---------------------------------------------------------------------------

def evict_token_mask(cache: PagedLayerCache, mask) -> PagedLayerCache:
    """Invalidate every token selected by a LOGICAL (B, P, page) bool mask,
    CoW-forking shared pages first (a starved fork skips that slot)."""
    B, P, page = mask.shape
    N = cache.pool_pages
    _cow_slots_mask(cache, mask.any(-1))
    phys = cache._phys()
    exclusive = cache.ref_count[phys] <= 1
    en = mask & (cache.mapped_mask() & exclusive)[..., None]
    tgt = torch.where(en, phys[..., None], N).reshape(-1)
    off = torch.arange(page, device=cache.device).expand(B, P, page) \
        .reshape(-1)
    live = en & (cache.pos_view() >= 0)
    cache.pos_buf[tgt, off] = -1
    cache.score_buf[tgt, off] = -torch.inf
    devstats.bump(cache.stats, devstats.TOKENS_EVICTED, live)
    return cache


def evict_pages_mask(cache: PagedLayerCache, mask) -> PagedLayerCache:
    """Evict every LOGICAL page selected by a (B, P) bool mask: unmap the
    slot and release one reference (the page's data survives for other
    mappers)."""
    en = mask & cache.mapped_mask()
    _unref_pages(cache, torch.where(en, cache._phys(), cache.pool_pages))
    cache.block_table.masked_fill_(en, -1)
    devstats.bump(cache.stats, devstats.PAGES_EVICTED, en)
    return cache


def row_intact_prefix_pages(cache: PagedLayerCache, row: int) -> torch.Tensor:
    """() int32: length of the leading run of row ``row``'s slots holding
    complete, position-contiguous prompt pages, capped at P - 1."""
    P, page = cache.num_pages, cache.page_size
    bt = cache.block_table[row]
    pos = cache.pos[bt.clamp_min(0).long()]
    dev = cache.device
    want = torch.arange(P, dtype=torch.int32, device=dev)[:, None] * page + \
        torch.arange(page, dtype=torch.int32, device=dev)[None, :]
    ok = (bt >= 0) & (pos == want).all(-1)
    run = torch.cumprod(ok.to(torch.int32), 0).sum()
    return run.clamp_max(P - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# gather to contiguous (tests / reference paths)
# ---------------------------------------------------------------------------

def to_contiguous(cache: PagedLayerCache):
    """(k, v, pos, mask) flattened over logical pages: (B, P * page, KV, hd)
    dequantized, (B, P * page) positions and validity. Physical-within-
    logical order, not position order."""
    B, P, page = cache.batch, cache.num_pages, cache.page_size
    KV, hd = cache.k.shape[2], cache.k.shape[3]
    return (cache.k_view().reshape(B, P * page, KV, hd),
            cache.v_view().reshape(B, P * page, KV, hd),
            cache.pos_view().reshape(B, P * page),
            cache.valid_mask().reshape(B, P * page))


# ---------------------------------------------------------------------------
# forensics view (obs/lineage.py)
# ---------------------------------------------------------------------------

LINEAGE_FIELDS = ("block_table", "ref_count", "cur_page", "tokens_per_page",
                  "page_scores", "pos_base")


def lineage_snapshot(cache: PagedLayerCache) -> dict:
    """Forensics view of one layer's pool, as the JAX package's
    ``lineage_snapshot``: device tensors, block_table (B, P) int32,
    ref_count (N,) int32, cur_page (B,) int32 (the working slot),
    tokens_per_page (B, P) int32, page_scores (B, P) f32 (+inf == empty)
    and pos_base (B, P) int32 (first position on the page, -1 == empty).
    The lineage ledger diffs consecutive snapshots (plus the step plan)
    into alloc / adopt / fork / evict / release events; an eviction is
    priced by the PREVIOUS snapshot's ``page_scores``."""
    tpp = cache.tokens_per_page()
    first = torch.where(cache.valid_mask(), cache.pos_view(),
                        torch.iinfo(torch.int32).max).amin(-1)
    return {
        "block_table": cache.block_table,
        "ref_count": cache.ref_count,
        "cur_page": cache.cur_page,
        "tokens_per_page": tpp,
        "page_scores": cache.page_scores(),
        "pos_base": torch.where(tpp > 0, first, -1).to(torch.int32),
    }


def lineage_snapshot_host(cache: PagedLayerCache) -> dict:
    """:func:`lineage_snapshot` read to the host in ONE transfer: the six
    tensors flattened into one int32 buffer (the f32 scores by their bits),
    then split into numpy arrays."""
    snap = lineage_snapshot(cache)
    flat = torch.cat([snap[f].to(torch.float32).view(torch.int32).reshape(-1)
                      if f == "page_scores" else
                      snap[f].to(torch.int32).reshape(-1)
                      for f in LINEAGE_FIELDS]).cpu().numpy()
    out, at = {}, 0
    for f in LINEAGE_FIELDS:
        n = snap[f].numel()
        part = flat[at:at + n].reshape(tuple(snap[f].shape))
        out[f] = part.view(np.float32) if f == "page_scores" else part
        at += n
    return out
