#!/usr/bin/env python3
"""Time the port's paged prefill kernel (K3, and K4 its per-Q-head grid) of
one checkout at chip_smoke.py's phase-2 timing shape, beside SDPA on the
same clocks. To compare two versions of the kernel on one card, run it on
both checkouts in turns on one machine (a, b, b, a):

    python3 scripts/time_prefill.py                    # this checkout
    python3 scripts/time_prefill.py --src OTHER/src    # another one's

The shape: llama-3.2-1b heads (KV 8, G 4, hd 64), bf16 query over a bf16
pool, batch 8, chunk 256, 49 slots of page 16 on a churned pool, a mixed
step's query positions, scores on (K3) and off (K4); and, where the
checkout has the int8 route, the same over an int8 pool. chip_smoke's two
clocks: ``ms`` (the wrapper's host work included) and ``device_ms`` (the
device's work alone), the L2 flushed before each call. Prints the card's
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
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_prefill import paged_prefill_cuda
    from repro_torch.kernels.ref import (churned_pool, gather_block_table,
                                         prefill_positions)
    KV, G, hd, page = cs.SHAPES["llama-3.2-1b"]
    B, P, T, dt = cs.B, cs.P, cs.T, torch.bfloat16
    k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, 100)
    g = torch.Generator().manual_seed(100)
    torch.randn((B, KV, G, hd), generator=g)     # phase 2's decode query
    qf = torch.randn((B, T, KV * G, hd), generator=g).to(dt).cuda()
    qp = prefill_positions(cur.cpu(), T).cuda()
    kg, vg, pg = gather_block_table(k, v, pos, bt)
    S = P * page
    kpos, qpe = pg.reshape(B, 1, S), qp[:, :, None]
    mask = ((kpos >= 0) & (qpe >= 0) & (kpos <= qpe))[:, None]
    kd, vd = kg.reshape(B, KV, S, hd), vg.reshape(B, KV, S, hd)
    calls = {
        "paged_prefill": lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                                    return_scores=True),
        "paged_prefill_per_qhead": lambda: paged_prefill_cuda(
            qf, k, v, pos, bt, qp, per_qhead=True),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qf.transpose(1, 2), kd, vd, attn_mask=mask, enable_gqa=True)}
    if hasattr(paged_prefill_cuda, "int8_tensor_core_launches"):
        k8, v8, ks, vs, _, _, _ = churned_pool(B, P, page, KV, hd,
                                               torch.int8, 100)
        calls["paged_prefill_int8"] = lambda: paged_prefill_cuda(
            qf, k8, v8, pos, bt, qp, k_scale=ks, v_scale=vs,
            return_scores=True)
    out = {"src": args.src, "card": cs.card_line()}
    for name, fn in calls.items():
        out[name] = {"ms": cs.timed(torch, fn),
                     "device_ms": cs.device_timed(torch, fn)}
        print(f"{name}: {out[name]['ms']:.4f} ms (device "
              f"{out[name]['device_ms']:.4f})", flush=True)
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
