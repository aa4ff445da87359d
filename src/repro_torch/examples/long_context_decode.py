"""Long-context decode with a budget-capped cache: the long_500k story at
CPU scale.

Decodes far past the cache budget: the paged cache stays at a constant
~budget tokens while the position stream keeps growing (RoPE at true
positions, masks against true positions), as the long_500k dry-run shape
decodes at position 524288 with a 4096-token cache; here a reduced model
decodes 600 tokens on a 64-token cache.

    PYTHONPATH=src python -m repro_torch.examples.long_context_decode \\
        [--policy ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.core.policies import get_policy
from repro_torch.device import resolve_device
from repro_torch.models.multimodal import make_inputs
from repro_torch.models.transformer import (decode_step, forward_prefill,
                                            init_model)


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="paged_eviction")
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    if params is None:
        params = init_model(cfg, seed=0, device=dev)
    ccfg = CacheConfig(page_size=8, cache_budget=args.budget,
                       policy=args.policy, dtype="float32")
    policy = get_policy(ccfg.policy)

    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = make_inputs(gen, cfg, 1, 96, device=dev)["tokens"]
    # total_seq_hint bounds the slab: with an eviction policy it is
    # budget-capped however far the decode goes
    logits, cache = forward_prefill(params, cfg, prompt, policy, ccfg,
                                    total_seq_hint=96 + args.steps)
    kv = cache.layers[0]
    slab = kv.num_pages * kv.page_size
    print(f"slab: {kv.num_pages} pages = {slab} token slots (decoding "
          f"{args.steps} tokens => context grows to {96 + args.steps})")
    out = {"budget": args.budget, "page": ccfg.page_size, "slab": slab,
           "checkpoints": []}
    every = max(1, min(150, args.steps))
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(args.steps):
        logits, cache = decode_step(params, cfg, tok, cache, policy, ccfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        if (i + 1) % every == 0:
            kv = cache.layers[0]
            live = int(kv.total_valid()[0])
            pv = kv.pos_view()
            oldest = int(torch.where(pv >= 0, pv, 10 ** 9).min())
            pos = int(cache.cur_pos[0])
            out["checkpoints"].append({"step": i + 1, "position": pos,
                                       "live": live, "oldest": oldest})
            print(f"step {i + 1:4d}: position {pos:4d}, live tokens "
                  f"{live:3d} (budget {args.budget}), oldest retained "
                  f"position {oldest}")
    dt = time.perf_counter() - t0
    out["finite"] = bool(torch.isfinite(logits).all())
    out["seconds"] = dt
    print(f"decoded {args.steps} tokens in {dt:.1f}s "
          f"({args.steps / dt:.1f} tok/s): the cache stayed O(budget) while "
          f"the context grew {(96 + args.steps) / slab:.1f}x past the slab.")
    return out


if __name__ == "__main__":
    main()
