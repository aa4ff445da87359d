#!/usr/bin/env python3
"""Time the port's paged prefill kernel (K3, and K4 its per-Q-head grid) of
one checkout at chip_smoke.py's phase-2 timing shapes, beside SDPA on the
same clocks. To compare two versions of the kernel on one card, run it on
both checkouts in turns on one machine (a, b, b, a):

    python3 scripts/time_prefill.py                    # this checkout
    python3 scripts/time_prefill.py --src OTHER/src    # another one's
    python3 scripts/time_prefill.py --dtype float32    # the f32 routes

The shapes: batch 8, chunk 256, 49 slots of page 16 on a churned pool, a
mixed step's query positions, scores on (K3) and off (K4); in bf16
llama-3.2-1b's heads (KV 8, G 4, hd 64) over a bf16 pool, in float32 TINY's
(KV 4, G 1, hd 32) and llama-3.2-1b's over an f32 pool; and, where the
checkout has the int8 routes, K3 and K4 over an int8 pool with a query of
the same dtype. chip_smoke's two clocks: ``ms`` (the wrapper's host work
included) and ``device_ms`` (the device's work alone), the L2 flushed
before each call; SDPA over the gathered view with the query's dtype.
Prints each call's route (the checkout's ``prefill_route``), the card's
name and power limit and one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"bfloat16": ("llama-3.2-1b",),
          "float32": ("TINY (hd 32)", "llama-3.2-1b")}


def shape_of(cs, name):
    if name in cs.SHAPES:
        return cs.SHAPES[name]
    return cs.NEW_HD_SHAPES[name][0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the query's and the float pool's dtype")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_prefill import (paged_prefill_cuda,
                                                   prefill_route)
    from repro_torch.kernels.ref import (churned_pool, gather_block_table,
                                         prefill_positions)
    dt = getattr(torch, args.dtype)
    out = {"src": args.src, "dtype": args.dtype, "card": cs.card_line()}
    for shape in SHAPES[args.dtype]:
        KV, G, hd, page = shape_of(cs, shape)
        B, P, T = cs.B, cs.P, cs.T
        k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, 100)
        g = torch.Generator().manual_seed(100)
        torch.randn((B, KV, G, hd), generator=g)  # phase 2's decode query
        qf = torch.randn((B, T, KV * G, hd), generator=g).to(dt).cuda()
        qp = prefill_positions(cur.cpu(), T).cuda()
        kg, vg, pg = gather_block_table(k, v, pos, bt)
        S = P * page
        kpos, qpe = pg.reshape(B, 1, S), qp[:, :, None]
        mask = ((kpos >= 0) & (qpe >= 0) & (kpos <= qpe))[:, None]
        kd, vd = kg.reshape(B, KV, S, hd), vg.reshape(B, KV, S, hd)
        calls = {
            "paged_prefill": (dt, lambda: paged_prefill_cuda(
                qf, k, v, pos, bt, qp, return_scores=True)),
            "paged_prefill_per_qhead": (dt, lambda: paged_prefill_cuda(
                qf, k, v, pos, bt, qp, per_qhead=True)),
            "sdpa": (None, lambda: F.scaled_dot_product_attention(
                qf.transpose(1, 2), kd, vd, attn_mask=mask,
                enable_gqa=True))}
        int8 = "int8_tensor_core_launches" if dt == torch.bfloat16 else \
            "int8_cuda_core_launches"
        if hasattr(paged_prefill_cuda, int8):
            k8, v8, ks, vs, _, _, _ = churned_pool(B, P, page, KV, hd,
                                                   torch.int8, 100)
            sc = dict(k_scale=ks, v_scale=vs)
            calls["paged_prefill_int8"] = (torch.int8, lambda: (
                paged_prefill_cuda(qf, k8, v8, pos, bt, qp, **sc,
                                   return_scores=True)))
            calls["paged_prefill_int8_per_qhead"] = (torch.int8, lambda: (
                paged_prefill_cuda(qf, k8, v8, pos, bt, qp, **sc,
                                   per_qhead=True)))
        rows = out[shape] = {}
        for name, (pool, fn) in calls.items():
            route = prefill_route(dt, pool, hd) if pool else "library"
            rows[name] = {"route": route, "ms": cs.timed(torch, fn),
                          "device_ms": cs.device_timed(torch, fn)}
            print(f"{shape} {args.dtype} {name} ({route}): "
                  f"{rows[name]['ms']:.4f} ms (device "
                  f"{rows[name]['device_ms']:.4f})", flush=True)
        del k, v, kd, vd, qf
        torch.cuda.empty_cache()
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
