#!/usr/bin/env python3
"""Time the port's decode kernels (K1 bf16 pool, K2 int8 pool) of one
checkout at chip_smoke.py's phase-2 timing shape, beside SDPA on the same
clocks. To compare two versions of the kernel on one card, run it on both
checkouts in turns on one machine (a, b, b, a):

    python3 scripts/time_decode.py                    # this checkout
    python3 scripts/time_decode.py --src OTHER/src    # another one's package
    python3 scripts/time_decode.py --sweep            # device ms of K1 and
                                                      # K2 by splits, scores

The shape: llama-3.2-1b heads (KV 8, G 4, hd 64), bf16 query, batch 8, 49
slots of page 16 on a churned pool, decode splits 4, scores on. Two clocks,
both with the L2 flushed before each call (chip_smoke's ``timed`` and
``device_timed``): ``ms`` (events around the call, the wrapper's host work
included) and ``device_ms`` (the device's work alone). Prints the card's
name and power limit and one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="device ms of K1 and K2 at splits 1, 2, 4, 8, 16 "
                         "and 49, scores on and off, instead")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.paged_attention import (
        dequantize, paged_attention_cuda, paged_attention_int8_cuda)
    from repro_torch.kernels.ref import churned_pool, gather_block_table
    KV, G, hd, page = cs.SHAPES["llama-3.2-1b"]
    B, P, dt = cs.B, cs.P, torch.bfloat16
    k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, 100)
    k8, v8, ks, vs, _, _, _ = churned_pool(B, P, page, KV, hd, torch.int8,
                                           100)
    g = torch.Generator().manual_seed(100)
    q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
    dec = dict(num_splits=4, return_scores=True)
    kg, vg, pg = gather_block_table(k, v, pos, bt)
    S = P * page
    mask = ((pg >= 0) & (pg <= cur[:, None, None])).reshape(B, 1, 1, S)
    qd = q.reshape(B, KV * G, 1, hd)
    kd, vd = kg.reshape(B, KV, S, hd), vg.reshape(B, KV, S, hd)
    kd8, vd8 = (dequantize(x, s)[bt.clamp_min(0).long()]
                .permute(0, 3, 1, 2, 4).reshape(B, KV, S, hd).to(dt)
                for x, s in ((k8, ks), (v8, vs)))
    calls = {
        "paged_decode": lambda: paged_attention_cuda(q, k, v, pos, bt, cur,
                                                     **dec),
        "paged_decode_int8": lambda: paged_attention_int8_cuda(
            q, k8, v8, ks, vs, pos, bt, cur, **dec),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True),
        "sdpa_int8_view": lambda: F.scaled_dot_product_attention(
            qd, kd8, vd8, attn_mask=mask, enable_gqa=True),
    }
    if args.sweep:
        out = {f"{name} splits {n} scores {int(sc)}": cs.device_timed(
            torch, lambda: fn(q, *pool, pos, bt, cur, num_splits=n,
                              return_scores=sc), iters=50)
               for name, fn, pool in (
                   ("paged_decode", paged_attention_cuda, (k, v)),
                   ("paged_decode_int8", paged_attention_int8_cuda,
                    (k8, v8, ks, vs)))
               for sc in (True, False) for n in (1, 2, 4, 8, 16, P)}
    else:
        out = {name: {"ms": cs.timed(torch, fn, iters=50),
                      "device_ms": cs.device_timed(torch, fn,
                                                   iters=50)}
               for name, fn in calls.items()}
    print(cs.card_line(), flush=True)
    print(json.dumps({"src": args.src, "times": out}), flush=True)


if __name__ == "__main__":
    main()
