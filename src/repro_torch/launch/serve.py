"""Serving driver of the torch port: continuous batching under an eviction
policy, on the GPU by default.

    python -m repro_torch.launch.serve --arch llama-3.2-1b --policy \
        paged_eviction --budget 512 --page 16 --requests 16 --max-batch 8 \
        --prompt-len 2048 --new-tokens 32 --chunk 256 --decode-splits 4

``--policy`` takes any registered policy (paged_eviction, full, and the
paper's baselines streaming_llm, inverse_key_l2 and keydiff) and refuses
other names. ``--reduced`` serves the family's tiny CPU-sized variant;
``--device cpu`` runs the kernels' plain torch versions on the CPU. ``--profile START:COUNT``
(repeatable) traces steps START .. START+COUNT-1 with ``torch.profiler`` and
prints each window's device time by kernel and the device's busy share."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.core.policies import POLICIES
from repro_torch.models.transformer import init_model
from repro_torch.serving import Engine, SamplingParams
from repro_torch.device import resolve_device


def device_busy_us(events) -> tuple[float, float]:
    """(union, sum) in microseconds of the device's own activity intervals
    (kernels, copies, sets) among profiler ``events``. The union is the
    time the device was busy; the sum exceeds it only where work overlaps.
    CPU-side ops are left out: they carry their kernels' time again."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, sum(e - s for s, e in spans)


def profile_steps(eng: Engine, start: int, count: int) -> bool:
    """Run ``count`` engine steps under ``torch.profiler``; print the
    device time by kernel and the share of the window the device was busy.
    Returns whether work remains."""
    from torch.profiler import ProfilerActivity, profile
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kinds = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            prefill_s = eng.stats.prefill_s
            more = eng.step()
            kinds.append("mixed" if eng.stats.prefill_s > prefill_s
                         else "decode")
            if not more:
                break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernel_us = device_busy_us(prof.events())
    events = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(f"profile: steps {start}..{start + len(kinds) - 1} ({kinds}), "
          f"wall {wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e6 / wall:.1f}%; device activities sum "
          f"{kernel_us / 1e3:.1f} ms), "
          f"{sum(e.count for e in events if e.key.startswith('aten::'))} "
          f"aten ops")
    print(events.table(sort_by=key, row_limit=15))
    return more


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="paged_eviction",
                    choices=sorted(POLICIES))
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--page", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=64,
                    help="prefill chunk size (tokens/step/request)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max tokens per unified step (default "
                         "max_batch + chunk)")
    ap.add_argument("--decode-splits", type=int, default=1,
                    help="split-K factor of the decode kernel's page walk")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prefix sharing across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request this many common leading "
                         "prompt tokens (exercises prefix sharing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="append", default=[],
                    metavar="START:COUNT",
                    help="trace steps START..START+COUNT-1 (repeatable)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_model(cfg, seed=args.seed, device=device)
    ccfg = CacheConfig(page_size=args.page, cache_budget=args.budget,
                       policy=args.policy,
                       dtype="float32" if args.reduced else "bfloat16")
    eng = Engine(cfg, params, cache_cfg=ccfg, max_batch=args.max_batch,
                 max_prompt_len=args.prompt_len,
                 max_new_tokens=args.new_tokens,
                 sampling=SamplingParams(greedy=True),
                 chunk_size=args.chunk, token_budget=args.token_budget,
                 prefix_sharing=not args.no_prefix_sharing,
                 decode_splits=args.decode_splits, device=device)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size,
                          size=min(args.shared_prefix, args.prompt_len - 1))
    for _ in range(args.requests):
        n = int(rng.integers(args.prompt_len // 2, args.prompt_len))
        tail = rng.integers(0, cfg.vocab_size, size=max(n - len(shared), 1))
        eng.submit(np.concatenate([shared, tail]).astype(np.int32))
    windows = {}
    for w in args.profile:
        start, count = (int(x) for x in w.split(":"))
        windows[start] = count
    t0 = time.perf_counter()
    step = 0
    while True:
        if step in windows:
            more = profile_steps(eng, step, windows[step])
            step += windows[step]
        else:
            more = eng.step()
            step += 1
        if not more:
            break
    done = eng.scheduler.finished
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"device={device} policy={args.policy} budget={args.budget} "
          f"page={args.page}")
    print(f"finished {len(done)} requests, {s.tokens_generated} tokens "
          f"in {dt:.2f}s ({s.tokens_generated / dt:.1f} tok/s)")
    print(f"decode-only throughput: {s.decode_tok_per_s:.1f} tok/s; "
          f"steps={s.steps}")
    print(f"evicted pages={s.pages_evicted} tokens={s.tokens_evicted} "
          f"forced={s.forced_evictions}")
    if s.shared_prefix_hits:
        print(f"prefix sharing: {s.shared_prefix_hits} adoptions, "
              f"{s.shared_prefix_tokens} prompt tokens skipped; "
              f"pool={eng.pool_stats()}")
    ttfts = [r.ttft for r in done if r.ttft > 0]
    if ttfts:
        print(f"ttft: mean={1e3 * np.mean(ttfts):.1f}ms "
              f"max={1e3 * np.max(ttfts):.1f}ms (chunk={args.chunk})")


if __name__ == "__main__":
    main()
