#!/usr/bin/env python3
"""Serve chip_smoke.py's phase-6 workload on an int8 pool with one
checkout's port and time its steps. To compare two versions on one card,
run it on both checkouts in turns on one machine (a, b, b, a):

    python3 scripts/time_int8_serving.py                  # this checkout
    python3 scripts/time_int8_serving.py --src OTHER/src  # another one's

The workload: llama-3.2-1b at full width (random bf16 weights from seed 0,
``--layers`` of its 16 layers), phase 4's first 4 prompts (1024-2048
tokens, every other one opening with a shared 256-token prefix), 32 greedy
tokens each, on an int8 pool (page 16, budget 512, paged_eviction, max
batch 8, chunk 256, decode splits 4). Prints, per step kind (mixed,
decode-only), the median and mean wall ms of ``Engine.step`` (the first
step of each kind left out: it loads the kernels) and the largest peak of
device memory above what was allocated when the step began; tok/s; the
prefill kernel's launches per route; the card's name and power limit; and
one JSON line. Needs a CUDA device; the kernels are built first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run")
    ap.add_argument("--layers", type=int, default=1,
                    help="layers of llama-3.2-1b's 16 (chip_smoke phase 6: "
                         "1)")
    args = ap.parse_args()
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import paged_prefill_cuda
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    build.build_all()
    cfg = dataclasses.replace(get_arch("llama-3.2-1b"),
                              num_layers=args.layers)
    eng = Engine(cfg, init_model(cfg, seed=0, device="cuda"),
                 cache_cfg=CacheConfig(page_size=16, cache_budget=512,
                                       policy="paged_eviction",
                                       dtype="int8"),
                 max_batch=8, max_prompt_len=2048, max_new_tokens=32,
                 chunk_size=256, decode_splits=4, device="cuda")
    for p in cs.serving_prompts(np, cfg.vocab_size, 4, 2048):
        eng.submit(p, max_new_tokens=32)
    routes = [r for r in ("tensor_core", "cuda_core", "int8_tensor_core",
                          "int8_cuda_core")
              if hasattr(paged_prefill_cuda, f"{r}_launches")]
    for r in routes:
        setattr(paged_prefill_cuda, f"{r}_launches", 0)
    steps = {"mixed": [], "decode": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = True
    while more:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        d0 = eng.stats.decode_steps
        s0 = time.perf_counter()
        more = eng.step()
        wall = time.perf_counter() - s0
        kind = "decode" if eng.stats.decode_steps > d0 else "mixed"
        steps[kind].append((1e3 * wall,
                            torch.cuda.max_memory_allocated() - base))
    total = time.perf_counter() - t0
    out = {"src": args.src, "layers": args.layers,
           "tok_per_s": eng.stats.tokens_generated / total,
           "launches": {r: getattr(paged_prefill_cuda, f"{r}_launches")
                        for r in routes}, "card": cs.card_line()}
    for kind, rows in steps.items():
        ms = [w for w, _ in rows[1:]]
        out[kind] = {"steps": len(rows), "median_ms": statistics.median(ms),
                     "mean_ms": statistics.fmean(ms),
                     "peak_bytes": max(b for _, b in rows)}
        print(f"{kind}: {len(rows)} steps, median {out[kind]['median_ms']:.2f}"
              f" ms, mean {out[kind]['mean_ms']:.2f} ms (first left out); "
              f"peak above the step's start {out[kind]['peak_bytes']} bytes",
              flush=True)
    print(f"{out['tok_per_s']:.1f} tok/s; prefill launches by route "
          f"{out['launches']}; {args.src}", flush=True)
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
