#!/usr/bin/env python3
"""Time the port's flash attention kernel (K5) of one checkout at
chip_smoke.py's phase-2 one-shot shape (4 prompts of 4096 tokens, causal),
beside SDPA on the same clocks. To compare two versions of the kernel on
one card, run it on both checkouts in turns on one machine (a, b, b, a):

    python3 scripts/time_flash.py                      # this checkout
    python3 scripts/time_flash.py --src OTHER/src      # another one's
    python3 scripts/time_flash.py --dtype float32      # the f32 routes

The heads: in bf16 llama-3.2-1b's (32 / 8, hd 64); in float32 TINY's (4 / 4,
hd 32) and llama-3.2-1b's. chip_smoke's two clocks: ``ms`` (host work
included) and ``device_ms`` (the device's work alone), the L2 flushed
before each call, 5 calls each. Prints each call's route (the checkout's
``flash_route``), its TFLOP/s (4 hd operations per causal pair), the
card's name and power limit and one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"bfloat16": ("llama-3.2-1b",),
          "float32": ("TINY (hd 32)", "llama-3.2-1b")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from time_prefill import shape_of
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   flash_route)
    dt = getattr(torch, args.dtype)
    out = {"src": args.src, "dtype": args.dtype, "card": cs.card_line()}
    for shape in SHAPES[args.dtype]:
        KV, G, hd, _ = shape_of(cs, shape)
        H = KV * G
        g = torch.Generator().manual_seed(100)
        x = [torch.randn((cs.B1, cs.S1, n, hd), generator=g).to(dt).cuda()
             for n in (H, KV, KV)]
        flops = 4 * hd * H * cs.B1 * cs.S1 * (cs.S1 + 1) // 2
        calls = {"flash_attention": (flash_route(dt, hd),
                                     lambda: flash_attention_cuda(*x)),
                 "sdpa": ("library", lambda: F.scaled_dot_product_attention(
                     *(t.transpose(1, 2) for t in x), is_causal=True,
                     enable_gqa=True))}
        rows = out[shape] = {}
        for name, (route, fn) in calls.items():
            r = rows[name] = {"route": route,
                              "ms": cs.timed(torch, fn, iters=5),
                              "device_ms": cs.device_timed(torch, fn,
                                                           iters=5)}
            print(f"{shape} {args.dtype} {name} ({route}): {r['ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f}, "
                  f"{flops / r['device_ms'] / 1e9:.1f} TFLOP/s)", flush=True)
        del x
        torch.cuda.empty_cache()
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
