"""Eviction policies, as in the JAX package's ``repro.core.policies``: the
paper's PagedEviction, the no-eviction FullCache, and the paper's baselines
StreamingLLM (sinks + recency), InverseKeyL2 and KeyDiff (token-level).

Each policy is a stateless strategy with three hooks:

  write_score(k_tok, v_tok, pos)        score stored with each written token
  prefill_keep(k, v, positions, valid)  paper Alg.2, one-shot form: pick the
                                        prompt tokens that survive, before
                                        paging (the one-shot path)
  chunk_prefill_evict(cache, cfg, ...)  paper Alg.2, incremental form: at a
                                        chunked-prefill boundary evict the
                                        lowest-score COMPLETED pages until
                                        the budget holds
  post_write(cache, cfg, active)        paper Alg.3: decode-time eviction
                                        and page rollover

Both eviction hooks take an optional ``page_scores`` (B, P): the attention
kernels' fused norm epilogue. When given, PagedEviction ranks pages by it
instead of the stored-score reduction ``cache.page_scores()``; the
token-level policies rank tokens and ignore it.

Where JAX skips a hook body under ``lax.cond(any(mask))``, the port runs it
masked (no host sync); the empty-page reclaim, the one part that is not an
identity under an all-False mask, takes ``mask.any()`` as a device gate.
Ranks and victims break ties as JAX does: stable sorts (the older token, the
lower slot) and the first index of an argmin.

Tensor parallelism: a policy built with ``tp_group`` (a
``launch.mesh.TPGroup``; ``get_policy(name, tp_group=...)`` makes a fresh
instance) averages its KV-head score means over the ranks, so every rank
ranks by the global scores; the registry's instances keep them local.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import CacheConfig
from repro_torch.core import importance
from repro_torch.core.paged_cache import (
    PagedLayerCache,
    alloc_pages,
    evict_page,
    evict_pages_mask,
    evict_token,
    evict_token_mask,
    find_free_slot,
    reclaim_empty_pages,
    rollover_to_free_page,
    start_new_page,
)
from repro_torch.kernels.pool_step import paged_evict_cuda


def plain_kw(plain: bool) -> dict:
    """The keyword arguments that pass ``plain`` on to ``decode_append``
    and ``EvictionPolicy.post_write``: ``{"plain": True}`` when set and
    nothing otherwise, so that a hook put in their place with the older
    signature, which takes no ``plain``, still runs on the kernels' path."""
    return {"plain": True} if plain else {}


class EvictionOutcome(NamedTuple):
    cache: PagedLayerCache
    pages_evicted: torch.Tensor     # (B,) bool: a full page was evicted
    tokens_evicted: torch.Tensor    # (B,) bool: a single token was evicted
    forced_evictions: torch.Tensor  # (B,) bool: fragmentation forced a page
    # which logical page lost the argmin and at what score (meaningful
    # where pages_evicted); None for policies that never evict pages
    victim_page: torch.Tensor | None = None   # (B,) int32
    victim_score: torch.Tensor | None = None  # (B,) f32


def _false(cache: PagedLayerCache) -> torch.Tensor:
    return torch.zeros((cache.batch,), dtype=torch.bool, device=cache.device)


def _is_cur(cache: PagedLayerCache) -> torch.Tensor:
    P = cache.num_pages
    return torch.arange(P, device=cache.device)[None, :] == \
        cache.cur_page[:, None]


def _out_of_window(cache: PagedLayerCache, window: int, active):
    """(B, P, page) bool: live tokens a windowed layer can never attend
    again (pos <= newest - window)."""
    pos = cache.pos_view()
    valid = pos >= 0
    cur = torch.where(valid, pos, -1).amax(dim=(1, 2), keepdim=True)
    return valid & (pos <= cur - window) & active[:, None, None]


class EvictionPolicy:
    name: str = "base"
    # the paper's classification: False for the policies whose token-level
    # holes fragment pages (InverseKeyL2, KeyDiff)
    structured: bool = True

    def __init__(self, tp_group=None):
        self.tp_group = tp_group

    @property
    def local_vk_ratio(self) -> bool:
        """Whether :meth:`write_score` is Alg. 1's ratio over this device's
        heads alone (no group averages them across ranks): then the decode
        append kernel (kernels/pool_step.py) computes it itself."""
        return False

    # --- slab sizing --------------------------------------------------------
    def _round_slab(self, cfg: CacheConfig, pages: int) -> int:
        m = max(cfg.slab_multiple, 1)
        return -(-pages // m) * m

    def slab_pages(self, cfg: CacheConfig, seq_len: int) -> int:
        total = -(-seq_len // cfg.page_size)
        return self._round_slab(cfg, min(total, cfg.budget_pages + 1))

    # --- scores -------------------------------------------------------------
    def write_score(self, k_tok, v_tok, pos_tok):
        """k_tok, v_tok: (..., KV, hd) -> (...,) f32."""
        raise NotImplementedError

    def prefill_scores(self, k, v, positions):
        """k, v: (B, S, KV, hd); positions (B, S) -> (B, S) f32."""
        raise NotImplementedError

    # --- Alg.2: prefill compression ------------------------------------------
    def prefill_keep(self, k, v, positions, valid, cfg: CacheConfig):
        """Select ``keep = min(budget, S)`` tokens. Returns (indices
        (B, keep) in ascending position order, scores (B, S); padding
        scores -inf)."""
        S = positions.shape[1]
        scores = torch.where(valid, self.prefill_scores(k, v, positions),
                             -torch.inf)
        return top_k_sorted(scores, min(cfg.cache_budget, S)), scores

    # --- Alg.2, incremental: chunk-boundary compression ----------------------
    def chunk_prefill_evict(self, cache: PagedLayerCache, cfg: CacheConfig,
                            active=None, window: int = 0,
                            page_scores=None) -> PagedLayerCache:
        """Compress the pooled cache back to the budget at a chunked-prefill
        boundary. ``active``: (B,) rows that consumed a prompt chunk;
        ``window``: the layer's attention window; ``page_scores``: optional
        fused-epilogue scores. A no-op when no row is active."""
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        return self._chunk_evict_body(cache, cfg, active, window,
                                      page_scores, gate=active.any())

    def _evict_scores(self, cache: PagedLayerCache, cfg: CacheConfig):
        """(B, P, page) importance that token eviction ranks by; the stored
        write scores unless a policy overrides it."""
        return cache.score_view()

    def _chunk_evict_body(self, cache, cfg, active, window, page_scores,
                          gate):
        """Token-level default: drop out-of-window tokens, keep the top
        ``cache_budget`` live tokens of each active row by
        :meth:`_evict_scores` (ranked by stable sorts, so ties keep the
        older token), evict the rest by mask, then return emptied pages to
        the free list. Ranks tokens, so the fused page scores do not apply."""
        B, P, page = cache.batch, cache.num_pages, cache.page_size
        if window:
            evict_token_mask(cache, _out_of_window(cache, window, active))
        valid = cache.valid_mask()
        scores = torch.where(valid, self._evict_scores(cache, cfg),
                             -torch.inf)
        order = torch.argsort(-scores.reshape(B, -1), dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)       # 0 == best
        evict = valid.reshape(B, -1) & (ranks >= cfg.cache_budget) & \
            active[:, None]
        evict_token_mask(cache, evict.reshape(B, P, page))
        return reclaim_empty_pages(cache, gate=gate)

    # --- Alg.3: decode bookkeeping -------------------------------------------
    def post_write(self, cache: PagedLayerCache, cfg: CacheConfig,
                   active=None, page_scores=None,
                   plain: bool = False) -> EvictionOutcome:
        """``plain``: the torch version on a CUDA pool too, where a policy
        has a kernel for the hook (PagedEviction)."""
        raise NotImplementedError


def top_k_sorted(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S) -> (B, k) indices of the k largest scores per row, ties to
    the lower index (as ``jax.lax.top_k``; ``torch.topk`` promises no order
    on ties, and the -inf of padding always ties), in ascending order."""
    order = torch.sort(-scores, dim=-1, stable=True).indices[:, :k]
    return order.sort(dim=-1).values


class FullCache(EvictionPolicy):
    name = "full"

    def slab_pages(self, cfg, seq_len):
        return self._round_slab(cfg, -(-seq_len // cfg.page_size))

    def write_score(self, k_tok, v_tok, pos_tok):
        return torch.zeros(k_tok.shape[:-2], dtype=torch.float32,
                           device=k_tok.device)

    def prefill_scores(self, k, v, positions):
        # recency: irrelevant when nothing is dropped; for windowed layers
        # the slab-capacity cap (compress_and_page) then keeps the newest
        return importance.recency_score(positions)

    def prefill_keep(self, k, v, positions, valid, cfg):
        B, S = positions.shape
        idx = torch.arange(S, device=positions.device).expand(B, S)
        return idx, torch.where(valid, self.prefill_scores(k, v, positions),
                                -torch.inf)

    def _chunk_evict_body(self, cache, cfg, active, window, page_scores,
                          gate):
        # no budget: only windowed layers shed never-again-attendable tokens
        if window:
            evict_token_mask(cache, _out_of_window(cache, window, active))
            reclaim_empty_pages(cache, gate=gate)
        return cache

    def post_write(self, cache, cfg, active=None, page_scores=None,
                   plain=False):
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        need = active & (cache.cur_off >= cache.page_size)
        slot, slot_ok = find_free_slot(cache)
        _, phys, ok = alloc_pages(cache, need & slot_ok)
        grow = need & slot_ok & ok
        start_new_page(cache, slot, phys, enable=grow)
        # saturated block table: never evict; park the head with off reset
        cache.cur_off.masked_fill_(need & ~grow, 0)
        f = _false(cache)
        return EvictionOutcome(cache, f, f, f)


class PagedEviction(EvictionPolicy):
    """Structured block-wise eviction (paper Alg. 1-3)."""
    name = "paged_eviction"

    @property
    def local_vk_ratio(self) -> bool:
        return self.tp_group is None

    def write_score(self, k_tok, v_tok, pos_tok):
        return importance.vk_ratio_score(k_tok, v_tok, self.tp_group)

    def prefill_scores(self, k, v, positions):
        return importance.vk_ratio_score(k, v, self.tp_group)

    def _chunk_evict_body(self, cache, cfg, active, window, page_scores,
                          gate):
        """Evict the lowest-mean-score COMPLETED pages until at most
        ``budget_pages`` remain (ranked by a stable argsort, so ties go to
        the lower slot). Windowed layers drop out-of-window tokens first and
        then rank by the stored scores: the fused ones predate the drop."""
        if window:
            page_scores = None
            evict_token_mask(cache, _out_of_window(cache, window, active))
        full = cache.tokens_per_page() >= cache.page_size
        if cfg.protect_recent:
            full &= ~_is_cur(cache)
        m = (full.sum(-1) - cfg.budget_pages).clamp_min(0)
        pscores = cache.page_scores() if page_scores is None else page_scores
        cand = torch.where(full, pscores, torch.inf)
        order = torch.argsort(cand, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)       # 0 == worst
        evict = full & (ranks < m[:, None]) & active[:, None]
        evict_pages_mask(cache, evict)
        return reclaim_empty_pages(cache, gate=gate)

    def post_write(self, cache, cfg, active=None, page_scores=None,
                   plain=False):
        """On a CUDA pool one launch of ``paged_evict``
        (kernels/pool_step.py); on a CPU pool, or with ``plain``, its plain
        version below."""
        if cache.device.type == "cuda" and not plain:
            return EvictionOutcome(cache, *paged_evict_cuda(
                cache, cfg.cache_budget, cfg.protect_recent, active,
                page_scores))
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        page_full = active & (cache.cur_off >= cache.page_size)
        do_evict = page_full & (cache.total_valid() > cfg.cache_budget)
        pscores = cache.page_scores() if page_scores is None else page_scores
        full_pages = cache.tokens_per_page() >= cache.page_size
        if cfg.protect_recent:
            full_pages &= ~_is_cur(cache)
        cand = torch.where(full_pages, pscores, torch.inf)
        victim = torch.argmin(cand, dim=-1).to(torch.int32)
        vscore = pscores.gather(1, victim[:, None].long())[:, 0].float()
        evict_page(cache, victim, enable=do_evict)
        _, forced = rollover_to_free_page(cache, page_full,
                                          gate=page_full.any())
        return EvictionOutcome(cache, do_evict, _false(cache), forced,
                               victim_page=victim, victim_score=vscore)


class StreamingLLM(EvictionPolicy):
    """Attention sinks + sliding window: the first ``num_sink_tokens``
    positions stay, the oldest other token goes, one per decode step."""
    name = "streaming_llm"

    def slab_pages(self, cfg, seq_len):
        # the sinks pin their page for good: one more slot of headroom
        total = -(-seq_len // cfg.page_size)
        return self._round_slab(cfg, min(total, cfg.budget_pages + 2))

    def write_score(self, k_tok, v_tok, pos_tok):
        return importance.recency_score(pos_tok)

    def prefill_scores(self, k, v, positions):
        return importance.recency_score(positions)

    def prefill_keep(self, k, v, positions, valid, cfg):
        # sinks score +inf so they always survive; the rest by recency
        S = positions.shape[1]
        scores = torch.where(positions < cfg.num_sink_tokens, torch.inf,
                             importance.recency_score(positions))
        scores = torch.where(valid, scores, -torch.inf)
        return top_k_sorted(scores, min(cfg.cache_budget, S)), scores

    def _evict_scores(self, cache, cfg):
        return torch.where(cache.pos_view() < cfg.num_sink_tokens,
                           torch.inf, cache.score_view())

    def post_write(self, cache, cfg, active=None, page_scores=None,
                   plain=False):
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        over = active & (cache.total_valid() > cfg.cache_budget)
        pos = cache.pos_view()
        B, P, page = pos.shape
        # the oldest non-sink token; int32 max (not inf) marks the rest
        cand = torch.where((pos >= 0) & (pos >= cfg.num_sink_tokens), pos,
                           torch.iinfo(torch.int32).max)
        victim = torch.argmin(cand.reshape(B, P * page), dim=-1) \
            .to(torch.int32)
        evict_token(cache, victim, enable=over)
        need = active & (cache.cur_off >= cache.page_size)
        _, forced = rollover_to_free_page(cache, need, gate=need.any())
        return EvictionOutcome(cache, _false(cache), over, forced)


class _UnstructuredTokenPolicy(EvictionPolicy):
    """Token-level eviction across pages: the lowest-importance live token
    goes, one per decode step; a page is freed only once all its tokens
    are gone (the paper's fragmentation, its Limitation 1)."""
    structured = False

    def slab_pages(self, cfg, seq_len):
        # holes keep pages mapped: headroom beyond budget / page
        total = -(-seq_len // cfg.page_size)
        return self._round_slab(cfg, min(total, 2 * cfg.budget_pages + 2))

    def post_write(self, cache, cfg, active=None, page_scores=None,
                   plain=False):
        if active is None:
            active = torch.ones((cache.batch,), dtype=torch.bool,
                                device=cache.device)
        over = active & (cache.total_valid() > cfg.cache_budget)
        valid = cache.valid_mask()
        B, P, page = valid.shape
        scores = torch.where(valid, self._evict_scores(cache, cfg),
                             torch.inf)
        victim = torch.argmin(scores.reshape(B, P * page), dim=-1) \
            .to(torch.int32)
        evict_token(cache, victim, enable=over)
        need = active & (cache.cur_off >= cache.page_size)
        _, forced = rollover_to_free_page(cache, need, gate=need.any())
        return EvictionOutcome(cache, _false(cache), over, forced)


class InverseKeyL2(_UnstructuredTokenPolicy):
    name = "inverse_key_l2"

    def write_score(self, k_tok, v_tok, pos_tok):
        return importance.inverse_key_l2_score(k_tok, self.tp_group)

    def prefill_scores(self, k, v, positions):
        return importance.inverse_key_l2_score(k, self.tp_group)


class KeyDiff(_UnstructuredTokenPolicy):
    name = "keydiff"

    def write_score(self, k_tok, v_tok, pos_tok):
        # the importance is global (it needs the mean key): recomputed from
        # the live cache at eviction time; the stored score is never read
        return torch.zeros(k_tok.shape[:-2], dtype=torch.float32,
                           device=k_tok.device)

    def prefill_scores(self, k, v, positions):
        # the mean over every prompt slot, padding included, as in JAX
        return importance.keydiff_score(k, k.float().mean(1, keepdim=True),
                                        self.tp_group)

    def _evict_scores(self, cache, cfg):
        # per-KV-head mean key over the valid tokens of the gathered view
        kf = cache.k_view().float()
        w = cache.valid_mask()[..., None, None].float()
        mean = (kf * w).sum((1, 2)) / w.sum((1, 2)).clamp_min(1.0)
        return importance.keydiff_score(kf, mean[:, None, None],
                                        self.tp_group)


POLICIES: dict[str, EvictionPolicy] = {
    p.name: p for p in (FullCache(), PagedEviction(), StreamingLLM(),
                        InverseKeyL2(), KeyDiff())
}


def get_policy(name: str, tp_group=None) -> EvictionPolicy:
    """The registered policy ``name``; with ``tp_group``, a fresh instance
    whose score means cross the group's ranks."""
    try:
        pol = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; the torch port has "
                       f"{sorted(POLICIES)}") from None
    return pol if tp_group is None else type(pol)(tp_group=tp_group)
