"""Quickstart: the paper's technique in ~40 lines.

Builds a reduced qwen2.5 model, prefills a prompt under a tight cache
budget with PagedEviction (Alg. 2), decodes a few tokens with block-wise
eviction (Alg. 3), and prints what happened to the cache.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.core.policies import get_policy
from repro_torch.device import resolve_device
from repro_torch.models.multimodal import make_inputs
from repro_torch.models.transformer import (decode_step, forward_prefill,
                                            init_model)


def main(argv=None, params=None, prompt=None) -> dict:
    """``params`` / ``prompt`` (1, 96) int32: hand over weights and a
    prompt (default: drawn from seeds 0 and 1 on the device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("qwen2.5-3b").reduced()
    if params is None:
        params = init_model(cfg, seed=0, device=dev)

    # the paper's knobs: page size B and cache budget C
    ccfg = CacheConfig(page_size=8, cache_budget=64, policy="paged_eviction",
                       dtype="float32")
    policy = get_policy(ccfg.policy)

    # a 96-token prompt: prefill compresses it to the 64-token budget
    # BEFORE paging (token-level, Alg. 2)
    if prompt is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt = make_inputs(gen, cfg, 1, 96, device=dev)["tokens"]
    logits, cache = forward_prefill(params, cfg, prompt, policy, ccfg,
                                    total_seq_hint=128)
    kv = cache.layers[0]
    live0 = int(kv.total_valid()[0])
    print(f"prompt tokens : {prompt.shape[1]}")
    print(f"cache budget  : {ccfg.cache_budget} tokens "
          f"({ccfg.budget_pages} pages of {ccfg.page_size})")
    print(f"after prefill : {live0} tokens live (evicted "
          f"{prompt.shape[1] - live0})")

    # decode: a whole page is evicted only when the newest page fills
    out = {"prompt_len": prompt.shape[1], "budget": ccfg.cache_budget,
           "page": ccfg.page_size, "live_after_prefill": live0, "steps": [],
           "tokens": []}
    tok = torch.argmax(logits, -1).to(torch.int32)
    for step in range(args.steps):
        logits, cache = decode_step(params, cfg, tok, cache, policy, ccfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out["tokens"].append(int(tok[0]))
        kv = cache.layers[0]
        tpp = kv.tokens_per_page()[0].cpu().numpy()
        out["steps"].append({"live": int(kv.total_valid()[0]),
                             "tokens_per_page": tpp.tolist()})
        if (step + 1) % 8 == 0:
            print(f"decode step {step + 1:2d}: "
                  f"live={out['steps'][-1]['live']:3d} "
                  f"pages={int((tpp > 0).sum()):2d} "
                  f"occupancy={sorted(tpp[tpp > 0].tolist(), reverse=True)}")
    out["block_table"] = kv.block_table.cpu().numpy()
    out["pos"] = kv.pos.cpu().numpy()
    out["finite"] = bool(torch.isfinite(logits).all())
    print("note: every non-working page is exactly full: the paper's "
          "block-structure invariant.")
    return out


if __name__ == "__main__":
    main()
