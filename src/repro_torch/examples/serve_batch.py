"""End-to-end serving driver: continuous batching with PagedEviction.

Submits a stream of variable-length requests to the engine, runs them to
completion with a tight cache budget, and reports throughput / TPOT: the
small-scale version of the paper's vLLM serving experiment (Fig. 3).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
        [--policy streaming_llm] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model, paged_layers
from repro_torch.serving import Engine, SamplingParams


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="paged_eviction")
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("llama-3.2-1b").reduced()
    if params is None:
        params = init_model(cfg, seed=0, device=dev)
    ccfg = CacheConfig(page_size=8, cache_budget=args.budget,
                       policy=args.policy, dtype="float32")
    engine = Engine(cfg, params, cache_cfg=ccfg, max_batch=4,
                    max_prompt_len=96, max_new_tokens=args.new_tokens,
                    sampling=SamplingParams(greedy=True), device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        n = int(rng.integers(16, 96))
        engine.submit(rng.integers(0, cfg.vocab_size, size=n)
                      .astype(np.int32))
    # the live tokens of every row after each step: the budget's bound
    max_live = 0
    while engine.step():
        max_live = max([max_live] + [int(c.total_valid().max())
                                     for c in paged_layers(
                                         engine.cache.layers)])
    finished = engine.scheduler.finished
    dt = time.perf_counter() - t0
    s = engine.stats
    print(f"policy={args.policy} budget={args.budget}")
    print(f"{len(finished)} requests, {s.tokens_generated} tokens in "
          f"{dt:.1f}s")
    print(f"decode throughput: {s.decode_tok_per_s:.1f} tok/s, "
          f"TPOT {s.decode_s / max(s.steps, 1) * 1e3:.1f} ms "
          f"({s.steps} engine steps, continuous batching)")
    for r in finished[:3]:
        print(f"  req {r.request_id}: prompt {len(r.prompt)} tok -> "
              f"{r.num_generated} generated, prefill "
              f"{r.prefill_time * 1e3:.0f} ms")
    return {"requests": len(finished),
            "generated": [r.num_generated for r in finished],
            "tokens": s.tokens_generated, "steps": s.steps,
            "max_live": max_live, "budget": args.budget,
            "page": ccfg.page_size, "chunk": engine.chunk_size,
            "seconds": dt}


if __name__ == "__main__":
    main()
