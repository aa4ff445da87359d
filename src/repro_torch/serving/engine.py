"""Continuous-batching serving engine of the torch port.

One unified step (``models.transformer.forward_step``) per iteration: the
scheduler packs up to ``token_budget`` tokens (one decode token per running
slot plus prompt chunks of up to ``chunk_size``), the step appends them into
the shared page pools, attends through block tables (the CUDA decode and
G-fold prefill kernels on the card), runs Alg.3 eviction on decode rows and
Alg.2 compression on prefill rows, and samples. Decode-only iterations run
the same step at T == 1. The policy is ``cache_cfg.policy``, any registered
one: the paper's PagedEviction, FullCache, or its baselines StreamingLLM,
InverseKeyL2 and KeyDiff (the kernels and their routes are the same).

Each step the per-layer devstats vectors are summed on the device and read
once, together with the sampled tokens, into :class:`EngineStats`. The JAX
engine's recompile sentinel has no counterpart: PyTorch runs eagerly and
compiles nothing per step shape. Observability hooks (trace, timeline,
lineage, regret) and tensor parallelism are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import CacheConfig, ModelConfig
from repro_torch.core import devstats
from repro_torch.core.policies import EvictionPolicy, get_policy
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    ModelCache,
    collect_step_stats,
    forward_step,
    init_decode_caches,
    intact_prefix_pages,
)
from repro_torch.serving.request import Request, RequestStatus, SamplingParams
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.scheduler import Scheduler


@dataclass
class EngineStats:
    steps: int = 0               # every unified step (mixed + decode-only)
    decode_steps: int = 0        # decode-only steps (their time is decode_s)
    tokens_generated: int = 0    # every emitted token (mixed steps included)
    decode_tokens: int = 0       # tokens from decode-only steps
    pages_evicted: int = 0
    tokens_evicted: int = 0
    forced_evictions: int = 0
    shared_prefix_hits: int = 0   # admissions that adopted resident pages
    shared_prefix_tokens: int = 0  # prompt tokens whose prefill was skipped
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, cache_cfg: CacheConfig,
                 max_batch: int = 8, max_prompt_len: int = 256,
                 max_new_tokens: int = 128,
                 sampling: SamplingParams | None = None, seed: int = 0,
                 chunk_size: int = 64, token_budget: int | None = None,
                 prefix_sharing: bool = True, decode_splits: int = 1,
                 fused_scores: bool | None = None, device=None,
                 plain_kernels: bool = False):
        """``params`` must lie on ``device``: default CUDA (raises without a
        card). ``fused_scores``: rank page evictions by the kernels' norm
        epilogue; defaults to True on CUDA, as the JAX engine turns it on
        with its kernels.
        ``plain_kernels``: run the kernels' plain versions on the card, to
        hold the kernels against them (a test switch, never a fallback)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ccfg = cache_cfg
        self.policy: EvictionPolicy = get_policy(cache_cfg.policy)
        self.max_batch = max_batch
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.total_len = max_prompt_len + max_new_tokens
        self.sampling = sampling or SamplingParams()
        self.decode_splits = decode_splits
        self.fused_scores = (self.device.type == "cuda" if fused_scores is None
                             else fused_scores)
        self.plain_kernels = plain_kernels
        self.chunk_size = min(chunk_size, max_prompt_len)
        self.scheduler = Scheduler(
            max_batch, chunk_size=self.chunk_size, token_budget=token_budget,
            page_size=cache_cfg.page_size if prefix_sharing else None,
            prefix_probe=self._prefix_probe if prefix_sharing else None)
        self.stats = EngineStats()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self.last_stats: np.ndarray | None = None  # last step's devstats

        self.cache: ModelCache = init_decode_caches(
            cfg, max_batch, self.total_len, self.policy, self.ccfg,
            chunk_tokens=self.chunk_size, track_stats=True,
            device=self.device)
        self.cur_tokens = np.zeros((max_batch,), np.int32)
        # running free-page count, kept from the devstats deltas
        # (Δfree == freed - allocated); each layer starts with `batch`
        # pre-mapped working pages
        self._pool_pages_total = sum(c.pool_pages for c in self.cache.layers)
        self._free_pages_est = self._pool_pages_total - \
            max_batch * len(self.cache.layers)

    def _prefix_probe(self, slot: int) -> int:
        """Device half of prefix-sharing admission (scheduler callback)."""
        return int(intact_prefix_pages(self.cache, slot))

    # ------------------------------------------------------------------- api
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int | None = None,
               eos_token_id: int | None = None) -> Request:
        if not 0 < len(prompt) <= self.max_prompt_len:
            raise ValueError(f"prompt len {len(prompt)} not in "
                             f"(0, {self.max_prompt_len}]")
        req = Request(request_id=self._next_id,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens or self.max_new_tokens,
                      eos_token_id=eos_token_id)
        self._next_id += 1
        self.scheduler.add(req)
        return req

    def _maybe_finish(self, req: Request) -> None:
        last = req.output_tokens[-1] if req.output_tokens else None
        if req.eos_token_id is not None and last == req.eos_token_id:
            req.status = RequestStatus.FINISHED_STOPPED
        elif req.num_generated >= req.max_new_tokens:
            req.status = RequestStatus.FINISHED_LENGTH
        if req.finished:
            self.scheduler.retire(req)

    def step(self) -> bool:
        """One engine iteration: plan a unified step and run it. Returns
        whether work remains."""
        plan = self.scheduler.plan()
        if plan.empty:
            return self.scheduler.has_work()
        B = self.max_batch
        T = self.chunk_size if plan.prefill else 1
        tokens = np.zeros((B, T), np.int32)
        n_tok = np.zeros((B,), np.int32)
        decode_mask = np.zeros((B,), bool)
        prefill_mask = np.zeros((B,), bool)
        reset_mask = np.zeros((B,), bool)
        reset_mask[plan.reset] = True
        share_src = np.full((B,), -1, np.int32)
        share_pages = np.zeros((B,), np.int32)
        for slot, src, n_pages in plan.adopt:
            share_src[slot] = src
            share_pages[slot] = n_pages
            self.stats.shared_prefix_hits += 1
            self.stats.shared_prefix_tokens += n_pages * self.ccfg.page_size
        for slot, req in plan.decode:
            tokens[slot, 0] = self.cur_tokens[slot]
            n_tok[slot] = 1
            decode_mask[slot] = True
        for slot, req, chunk, _ in plan.prefill:
            tokens[slot, :len(chunk)] = chunk
            n_tok[slot] = len(chunk)
            prefill_mask[slot] = True
            req.prefill_pos += len(chunk)

        t0 = time.perf_counter()
        dev = lambda a: torch.from_numpy(a).to(self.device)
        logits, self.cache = forward_step(
            self.params, self.cfg, dev(tokens), dev(n_tok), self.cache,
            self.policy, self.ccfg, decode_mask=dev(decode_mask),
            prefill_mask=dev(prefill_mask), reset_mask=dev(reset_mask),
            share_src=dev(share_src), share_pages=dev(share_pages),
            decode_splits=self.decode_splits, fused_scores=self.fused_scores,
            plain_kernels=self.plain_kernels)
        s = self.sampling
        next_tok = sample_tokens(self._gen, logits,
                                 temperature=s.temperature, top_k=s.top_k,
                                 top_p=s.top_p, greedy=s.greedy)
        # one device -> host read per step: sampled tokens + devstats
        out = torch.cat([next_tok, collect_step_stats(self.cache)])
        out = out.cpu().numpy()
        next_np, st = out[:B], out[B:]
        dt = time.perf_counter() - t0
        now = time.perf_counter()
        self.stats.steps += 1
        if plan.prefill:
            self.stats.prefill_s += dt
        else:
            self.stats.decode_s += dt
            self.stats.decode_steps += 1

        self.last_stats = st
        self.stats.pages_evicted += int(st[devstats.PAGES_EVICTED])
        self.stats.tokens_evicted += int(st[devstats.TOKENS_EVICTED])
        self.stats.forced_evictions += int(st[devstats.FORCED_EVICTIONS])
        self._free_pages_est += int(st[devstats.PAGES_FREED]) - \
            int(st[devstats.PAGES_ALLOCATED])

        for slot, req in plan.decode:
            req.output_tokens.append(int(next_np[slot]))
            req.decode_times.append(dt)
            self.cur_tokens[slot] = next_np[slot]
            self.stats.tokens_generated += 1
            if not plan.prefill:
                self.stats.decode_tokens += 1
            self._maybe_finish(req)
        for slot, req, chunk, completes in plan.prefill:
            req.prefill_time += dt
            if completes:
                req.output_tokens.append(int(next_np[slot]))
                req.first_token_time = now
                self.cur_tokens[slot] = next_np[slot]
                req.status = RequestStatus.RUNNING
                self.stats.tokens_generated += 1
                self._maybe_finish(req)
        return self.scheduler.has_work()

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive :meth:`step` to completion."""
        steps = 0
        while self.step() and steps < max_steps:
            steps += 1
        return self.scheduler.finished

    def pool_stats(self) -> dict:
        """Fleet-level page-pool occupancy over every layer: pages, free
        pages, utilisation, pages mapped by more than one block table and
        the physical pages sharing saves (sum of ref_count - 1)."""
        total = free = shared = extra = 0
        for c in self.cache.layers:
            ref = c.ref_count.cpu().numpy()
            total += ref.size
            free += int((ref == 0).sum())
            shared += int((ref > 1).sum())
            extra += int((ref[ref > 1] - 1).sum())
        return {"pool_pages": total, "free_pages": free,
                "utilization": (total - free) / total if total else 0.0,
                "shared_pages": shared, "pages_saved_by_sharing": extra}

    def pool_bytes(self) -> dict:
        """Device bytes of the page-pool payload (K/V and the int8 scales,
        trash row included) and of the pool metadata."""
        payload = meta = 0
        for c in self.cache.layers:
            for t in (c.k_buf, c.v_buf, c.k_scale_buf, c.v_scale_buf):
                if t is not None:
                    payload += t.numel() * t.element_size()
            for t in (c.pos_buf, c.score_buf, c.block_table, c.ref_count,
                      c.cur_page, c.cur_off, c.stats):
                if t is not None:
                    meta += t.numel() * t.element_size()
        return {"payload_total": payload, "metadata_total": meta}
