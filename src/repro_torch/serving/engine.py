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

Telemetry (``repro_torch.obs``, the JAX engine's hooks): with metrics on
(the default) the per-layer devstats vectors are summed on the device and
read once per step, together with the sampled tokens, into
:class:`EngineStats` and a :class:`~repro_torch.obs.MetricsRegistry`
(TTFT, TPOT, ITL, queue, plan and step histograms; pool counters and
gauges); ``ObsConfig(metrics=False)`` gives bare caches with no stats
vector and no read of it. Optionally: one JSONL trace record per step
(schema v2, the JAX engine's fields), a per-request Perfetto timeline, a
page-lineage ledger over the first layer (one snapshot read per step) and
eviction-regret shadow probes (``forward_step(want_taps=True)``). PyTorch
runs eagerly and compiles nothing: the program count of the trace records
is the number of distinct step shapes run (T == chunk, T == 1), the count
the JAX engine's compiled programs reach on the same schedule. Tensor
parallelism is not ported yet.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import CacheConfig, ModelConfig
from repro_torch.core import devstats
from repro_torch.core.paged_cache import lineage_snapshot_host
from repro_torch.core.policies import EvictionPolicy, get_policy
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    ModelCache,
    collect_step_stats,
    forward_step,
    init_decode_caches,
    intact_prefix_pages,
)
from repro_torch.obs import EngineObs, ObsConfig
from repro_torch.obs.lineage import StepPlanContext
from repro_torch.obs.regret import (REGRET_BOUNDS, ShadowState, probe_record,
                                    run_probe)
from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, annotation
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
                 plain_kernels: bool = False, obs: ObsConfig | None = None):
        """``params`` must lie on ``device``: default CUDA (raises without a
        card). ``fused_scores``: rank page evictions by the kernels' norm
        epilogue; defaults to True on CUDA, as the JAX engine turns it on
        with its kernels.
        ``plain_kernels``: run the kernels' plain versions on the card, to
        hold the kernels against them (a test switch, never a fallback).
        ``obs``: what to instrument (default ``ObsConfig()``: metrics
        only)."""
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

        self.obs = EngineObs(obs if obs is not None else ObsConfig())
        self._t_start = time.perf_counter()
        self._step_shapes: set[int] = set()   # token dims T run so far
        self._warned_compile = False
        self._want_taps = self.obs.cfg.regret_every > 0
        self._shadow: ShadowState | None = None
        self.last_hook_s = 0.0      # host seconds in the obs blocks, last step
        self.last_tap_bytes = 0     # regret taps read to the host, last step
        if self.obs.timeline is not None:
            self.scheduler.on_admit = self._on_admit

        self.cache: ModelCache = init_decode_caches(
            cfg, max_batch, self.total_len, self.policy, self.ccfg,
            chunk_tokens=self.chunk_size, track_stats=self.obs.cfg.metrics,
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
        if self.obs.timeline is not None:
            self.obs.timeline.request_submitted(req.request_id,
                                                time.perf_counter())
        return req

    def _on_admit(self, slot: int, req: Request) -> None:
        """Scheduler admission hook -> timeline (the queue span ends here)."""
        self.obs.timeline.request_admitted(
            req.request_id, req.admission_time, slot=slot,
            shared_tokens=req.shared_tokens,
            shared_pages=(req.shared_tokens // self.ccfg.page_size
                          if req.shared_tokens else 0),
            prompt_tokens=len(req.prompt))

    def _maybe_finish(self, req: Request) -> None:
        last = req.output_tokens[-1] if req.output_tokens else None
        if req.eos_token_id is not None and last == req.eos_token_id:
            req.status = RequestStatus.FINISHED_STOPPED
        elif req.num_generated >= req.max_new_tokens:
            req.status = RequestStatus.FINISHED_LENGTH
        if req.finished:
            if self.obs.timeline is not None:
                self.obs.timeline.request_finished(
                    req.request_id, time.perf_counter(),
                    tokens=req.num_generated, reason=req.status.value)
            self.scheduler.retire(req)
            if self.obs.cfg.metrics:
                reg = self.obs.registry
                reg.counter("engine.requests_finished").inc()
                if req.decode_times:
                    reg.histogram("engine.tpot_s").observe(
                        sum(req.decode_times) / len(req.decode_times))

    # ------------------------------------------------------------- telemetry
    def _check_recompile(self, T: int) -> bool:
        """Program sentinel: the JAX engine compiles one program per step
        shape; the port counts the distinct token dims T it has run. Returns
        True iff this step's shape is new and the count passed the ceiling
        (2: T == chunk and T == 1); the first such step warns once."""
        grew = T not in self._step_shapes
        self._step_shapes.add(T)
        n = len(self._step_shapes)
        unexpected = grew and n > self.obs.cfg.program_ceiling
        if self.obs.cfg.metrics:
            self.obs.registry.gauge("engine.programs").set(n)
            if unexpected:
                self.obs.registry.counter("engine.unexpected_compiles").inc()
        if unexpected and not self._warned_compile:
            self._warned_compile = True
            warnings.warn(
                f"engine step shape #{n} (ceiling "
                f"{self.obs.cfg.program_ceiling}): an operand shape is "
                f"varying across steps", stacklevel=3)
        return unexpected

    def _emit_trace(self, kind: str, plan, plan_dt: float, step_dt: float,
                    tokens: int, st, finished: int, unexpected: bool) -> None:
        ev = {
            "v": TRACE_SCHEMA_VERSION,
            "rec": "step",
            "step": self.stats.steps,
            "kind": kind,
            "t_ms": (time.perf_counter() - self._t_start) * 1e3,
            "plan_ms": plan_dt * 1e3,
            "step_ms": step_dt * 1e3,
            "decode_rows": len(plan.decode),
            "prefill_rows": len(plan.prefill),
            "reset_rows": len(plan.reset),
            "adopt_rows": len(plan.adopt),
            "tokens": tokens,
            "programs": len(self._step_shapes),
            "finished": finished,
        }
        if st is not None:
            for i, name in enumerate(devstats.STAT_NAMES):
                ev[name] = int(st[i])
            ev["pool_pages"] = self._pool_pages_total
            ev["free_pages"] = self._free_pages_est
        if unexpected:
            ev["unexpected_compile"] = True
        self.obs.writer.emit(ev)

    def step(self) -> bool:
        """One engine iteration: plan a unified step and run it. Returns
        whether work remains. ``last_hook_s`` is then the host time of this
        step's obs blocks: the plan histogram, the lineage snapshot and
        diff, the regret shadow, the timeline, the metrics and the trace
        record (the per-token histogram updates are left out)."""
        oc = self.obs.cfg
        self.last_hook_s = 0.0
        t_plan0 = time.perf_counter()
        with annotation("engine.plan", enabled=oc.profiler_annotations):
            plan = self.scheduler.plan()
        plan_dt = time.perf_counter() - t_plan0
        h0 = time.perf_counter()
        if oc.metrics:
            self.obs.registry.histogram("engine.plan_s").observe(plan_dt)
        if plan.empty:
            if self.obs.writer is not None:
                self._emit_trace("idle", plan, plan_dt, 0.0, 0, None, 0, False)
            self.last_hook_s += time.perf_counter() - h0
            return self.scheduler.has_work()
        self.last_hook_s += time.perf_counter() - h0
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
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        with annotation("engine.step", enabled=oc.profiler_annotations):
            out = forward_step(
                self.params, self.cfg, dev(tokens), dev(n_tok), self.cache,
                self.policy, self.ccfg, decode_mask=dev(decode_mask),
                prefill_mask=dev(prefill_mask), reset_mask=dev(reset_mask),
                share_src=dev(share_src), share_pages=dev(share_pages),
                decode_splits=self.decode_splits,
                fused_scores=self.fused_scores,
                plain_kernels=self.plain_kernels, want_taps=self._want_taps)
            logits, self.cache = out[0], out[1]
            taps = out[2] if self._want_taps else None
            s = self.sampling
            next_tok = sample_tokens(self._gen, logits,
                                     temperature=s.temperature, top_k=s.top_k,
                                     top_p=s.top_p, greedy=s.greedy)
            # one device -> host read per step: sampled tokens (+ devstats)
            st_dev = collect_step_stats(self.cache)
            host = (next_tok if st_dev is None else
                    torch.cat([next_tok, st_dev])).cpu().numpy()
        next_np = host[:B]
        st = host[B:] if st_dev is not None else None
        dt = time.perf_counter() - t0
        now = time.perf_counter()
        unexpected = self._check_recompile(T)
        self.stats.steps += 1
        if plan.prefill:
            self.stats.prefill_s += dt
        else:
            self.stats.decode_s += dt
            self.stats.decode_steps += 1

        if st is not None:
            self.last_stats = st
            self.stats.pages_evicted += int(st[devstats.PAGES_EVICTED])
            self.stats.tokens_evicted += int(st[devstats.TOKENS_EVICTED])
            self.stats.forced_evictions += int(st[devstats.FORCED_EVICTIONS])
            self._free_pages_est += int(st[devstats.PAGES_FREED]) - \
                int(st[devstats.PAGES_ALLOCATED])

        # forensics, before the finish loops below so that slot -> request
        # attribution still sees this step's owners
        h0 = time.perf_counter()
        step_no = self.stats.steps
        lin_events = []
        if self.obs.ledger is not None:
            snap = lineage_snapshot_host(self.cache.layers[0])
            ctx = StepPlanContext(
                reset_slots=frozenset(plan.reset),
                adopt={slot: (src, n_pages)
                       for slot, src, n_pages in plan.adopt})
            lin_events = self.obs.ledger.observe_step(step_no, snap, ctx)
            if self.obs.writer is not None:
                for evn in lin_events:
                    self.obs.writer.emit(evn.to_record())
        if taps is not None:
            self._observe_regret(plan, taps, n_tok, step_no)
        tl = self.obs.timeline
        if tl is not None:
            kind_tl = "mixed" if (plan.prefill and plan.decode) else (
                "prefill" if plan.prefill else "decode")
            tl.engine_step(step_no, kind_tl, t0, dt,
                           tokens=int(n_tok.sum()))
            for slot, req in plan.decode:
                tl.decode_step(req.request_id, t0)
            for slot, req, chunk, _ in plan.prefill:
                tl.prefill_chunk(req.request_id, t0, t0 + dt,
                                 tokens=len(chunk), step=step_no)
            if st is not None and int(st[devstats.PAGES_EVICTED]) > 0:
                tl.engine_instant(now, "pages_evicted",
                                  count=int(st[devstats.PAGES_EVICTED]))
            for evn in lin_events:
                if evn.etype == "evict":
                    owner = self.scheduler.slots[evn.slot]
                    if owner is not None:
                        tl.request_evicted_page(owner.request_id, now,
                                                page=evn.page, lpi=evn.lpi,
                                                score=evn.score)

        reg = self.obs.registry if oc.metrics else None
        if reg is not None:
            reg.histogram("engine.step_wall_s").observe(dt)
            reg.counter("engine.steps").inc()
            reg.counter("engine.tokens").inc(int(n_tok.sum()))
            if st is not None:
                for i, name in enumerate(devstats.STAT_NAMES):
                    reg.counter(f"pool.{name}").inc(int(st[i]))
                reg.gauge("pool.free_pages").set(self._free_pages_est)
                reg.gauge("pool.total_pages").set(self._pool_pages_total)
            for slot in plan.reset:
                r = self.scheduler.slots[slot]
                if r is not None:
                    reg.histogram("engine.queue_s").observe(r.queue_time)
        self.last_hook_s += time.perf_counter() - h0

        finished_before = len(self.scheduler.finished)
        for slot, req in plan.decode:
            req.output_tokens.append(int(next_np[slot]))
            req.decode_times.append(dt)
            self.cur_tokens[slot] = next_np[slot]
            self.stats.tokens_generated += 1
            if not plan.prefill:
                self.stats.decode_tokens += 1
            if reg is not None:
                reg.histogram("engine.itl_s").observe(dt)
            self._maybe_finish(req)
        for slot, req, chunk, completes in plan.prefill:
            req.prefill_time += dt
            if completes:
                # the first output token: TTFT is dated from arrival, so an
                # adopter's shorter prefill does not hide its queueing
                req.output_tokens.append(int(next_np[slot]))
                req.first_token_time = now
                self.cur_tokens[slot] = next_np[slot]
                req.status = RequestStatus.RUNNING
                self.stats.tokens_generated += 1
                if reg is not None:
                    reg.histogram("engine.ttft_s").observe(
                        now - req.arrival_time)
                self._maybe_finish(req)
        if self.obs.writer is not None:
            h0 = time.perf_counter()
            kind = "mixed" if (plan.prefill and plan.decode) else \
                ("prefill" if plan.prefill else "decode")
            self._emit_trace(kind, plan, plan_dt, dt, int(n_tok.sum()), st,
                             len(self.scheduler.finished) - finished_before,
                             unexpected)
            self.last_hook_s += time.perf_counter() - h0
        return self.scheduler.has_work()

    def _observe_regret(self, plan, taps, n_tok, step_no: int) -> None:
        """Shadow-probe bookkeeping (obs/regret.py): the step's taps read to
        the host (f32) into the shadow history that mirrors the pool's
        lifecycle, then a full-cache recompute on this step's sampled
        decode rows."""
        layers = [{name: (t.cpu().numpy() if name == "live_pos"
                          else t.float().cpu().numpy())
                   for name, t in tap.items()} for tap in taps["layers"]]
        positions = taps["positions"].cpu().numpy()
        self.last_tap_bytes = positions.nbytes + sum(
            a.nbytes for tap in layers for a in tap.values())
        if self._shadow is None:
            KV, hd = layers[0]["k"].shape[-2:]
            self._shadow = ShadowState(len(layers), self.max_batch,
                                       self.total_len, KV, hd)
        sh = self._shadow
        for slot in plan.reset:
            sh.reset_row(slot)
        for slot, src, n_pages in plan.adopt:
            sh.adopt(slot, src, n_pages * self.ccfg.page_size)
        sh.record_step(layers, positions, n_tok)
        every = self.obs.cfg.regret_every
        rows, by_slot = [], {}
        for slot, req in plan.decode:
            if req.probe and len(req.decode_times) % every == 0:
                rows.append(slot)
                by_slot[slot] = req
        if not rows:
            return
        reg = self.obs.registry if self.obs.cfg.metrics else None
        for s in run_probe(sh, layers, positions, n_tok, rows):
            req = by_slot[s["slot"]]
            req.regret_samples.append(s)
            if self.obs.writer is not None:
                self.obs.writer.emit(probe_record(
                    s, step=step_no, request_id=req.request_id))
            if reg is not None:
                reg.histogram("engine.eviction_regret",
                              bounds=REGRET_BOUNDS).observe(
                                  float(np.mean(s["divergence"])))
                reg.histogram("engine.evicted_attention_mass",
                              bounds=REGRET_BOUNDS).observe(
                                  float(np.mean(s["evicted_mass"])))

    def shadow_nbytes(self) -> int:
        """Host bytes held by the regret shadow cache (0 when probes off)."""
        return self._shadow.nbytes() if self._shadow is not None else 0

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive :meth:`step` to completion. An exception anywhere in the
        loop flushes the buffered trace tail before it propagates, so the
        trace ends at the failing step."""
        steps = 0
        try:
            while self.step() and steps < max_steps:
                steps += 1
        except BaseException:
            if self.obs.writer is not None:
                self.obs.writer.flush()
            raise
        return self.scheduler.finished

    def num_compiled_programs(self) -> int:
        """Distinct step shapes run so far (T == chunk and T == 1: expect
        2), the count the JAX engine's compiled programs reach on the same
        schedule; the ``engine.programs`` gauge mirrors it."""
        return len(self._step_shapes)

    def metrics_snapshot(self) -> dict:
        """JSON-safe snapshot of every metric (see MetricsRegistry)."""
        return self.obs.registry.snapshot()

    def close(self) -> None:
        """Flush and close the trace writer (idempotent)."""
        self.obs.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def export_timeline(self, path: str) -> int:
        """Write the per-request Perfetto/Chrome-trace timeline; returns the
        event count. Requires ``ObsConfig(timeline=True)``."""
        if self.obs.timeline is None:
            raise ValueError("engine was not run with ObsConfig(timeline=True)")
        return self.obs.timeline.export(path)

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
