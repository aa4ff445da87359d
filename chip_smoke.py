#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):
  1. build    the CUDA kernels under src/repro_torch/csrc, one nvcc each, in
              parallel, into src/repro_torch/_build
  2. kernels  each kernel against its plain torch version: the paged ones on
              churned pools (freed and reallocated pages, unmapped slots,
              shared prefix pages, padding rows, window 0 and > 0; float and
              int8 pools), the flash one on prompts of 128 and 4096 tokens
              with and without a window, the page-score one on float and
              dequantized int8 pools, at the shapes of llama-3.2-1b, -3b and
              3.1-8b; the per-Q-head prefill kernel also bit for bit against
              the G-fold one. f32 cases within 1e-4; the tensor-core routes
              (bf16 prefill over a bf16 pool, bf16 flash) within the derived
              bound 1e-5 + 2**-7 |plain| + 2**-8 (P |V|) / l; each case
              names its route. Then each one's time at the main path's
              shapes beside its bound, the plain version's time and one
              PyTorch call's (scaled_dot_product_attention, a yardstick
              only)
  3. parity   a reduced f32 config (KV 2, G 2) run twice on the card, through
              the kernels and through their plain versions: the engine on a
              float and on an int8 pool, and the one-shot path
              (forward_prefill + 8 decode_steps) on a float and an int8 pool,
              and on a float pool with a ragged prompt of 3000 tokens;
              greedy tokens, devstats and the integer pool state equal; on
              int8 pools, where a quantizer input rounds differently on the
              two runs, the first such value on both sides
  4. serve    llama-3.2-1b at full width (bf16, random weights from a seed):
              16 requests of 1024-2048 prompt tokens (half share a 256-token
              prefix), 32 greedy tokens each, under paged_eviction (page 16,
              budget 512, max batch 8, chunk 256, decode splits 4). Checks
              every request's token count, that both kernels ran (every
              prefill launch on the tensor-core route), that pages were
              evicted and prefixes shared, the pool invariants F1-F4 and the
              devstats conservation identities at every step.
  5. one-shot llama-3.2-1b at full width, the paper's own experiment: 4
              prompts of up to 4096 tokens prefilled through the flash
              kernel (all 16 launches on the tensor-core route), compressed
              to budget 512 by Alg. 2, then 32 greedy tokens under Alg. 3,
              once on a bf16 and once on an int8 pool
  6. int8     phase 4's workload (8 requests) served on an int8 pool (every
              prefill launch on the CUDA-core route: a bf16 query over the
              dequantized f32 pool)

Prints the card's name and power limit, one JSON line describing every
kernel (with the route each timing took, "timed_route"), and as the last
line {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device or without the repository's sources beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no tensor cores
              "bfloat16": 989e12}    # dense tensor-core rate
# |kernel - plain| <= atol + rtol * |plain|, elementwise, on the CUDA-core
# routes. Both compute in f32; a bf16 output differs from the plain one only
# where the two f32 values round to neighbouring bf16 numbers: one step, at
# most 2**-7 of the value. The tensor-core routes (bf16 q over bf16 K/V)
# round each probability to bf16 before P V and are held to
# ref.tc_bf16_bound: 1e-5 + 2**-7 |plain| + 2**-8 (P |V|) / l.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2 ** -7)}
NORM_RTOL = 1e-3
KERNELS = {
    "paged_decode": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:249"),
    "paged_decode_int8": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:309"),
    "paged_prefill": dict(
        source="src/repro_torch/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:240"),
    "paged_prefill_per_qhead": dict(
        source="src/repro_torch/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:322"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_prefill.py:115"),
    "block_score": dict(
        source="src/repro_torch/csrc/block_score.cu",
        replaces="src/repro/kernels/block_score.py:49"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def launch_counters():
    """name -> (object, attribute) of every kernel wrapper's launch count,
    and of the prefill and flash wrappers' counts per route
    ("paged_prefill/tensor_core", ...)."""
    from repro_torch.kernels.block_score import block_score_cuda
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   paged_prefill_cuda)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_int8_cuda)
    return {"paged_decode": (paged_attention_cuda, "launches"),
            "paged_decode_int8": (paged_attention_int8_cuda, "launches"),
            "paged_prefill": (paged_prefill_cuda, "launches"),
            "paged_prefill_per_qhead": (paged_prefill_cuda,
                                        "per_qhead_launches"),
            "flash_attention": (flash_attention_cuda, "launches"),
            "block_score": (block_score_cuda, "launches"),
            **{f"{name}/{route}": (fn, f"{route}_launches")
               for name, fn in (("paged_prefill", paged_prefill_cuda),
                                ("flash_attention", flash_attention_cuda))
               for route in ("tensor_core", "cuda_core")}}


def reset_launches() -> None:
    for obj, attr in launch_counters().values():
        setattr(obj, attr, 0)


def read_launches() -> dict:
    return {n: getattr(o, a) for n, (o, a) in launch_counters().items()}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def timed(torch, fn, iters=20, warmup=3):
    """Mean ms of ``fn`` on the card: CUDA events around each call, the L2
    flushed before each one (the serving path finds a layer's pages cold)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

SHAPES = {  # name: (KV, G, hd, page)
    "llama-3.2-1b": (8, 4, 64, 16),
    "llama-3.2-3b": (8, 3, 128, 16),
    "llama-3.1-8b": (8, 4, 128, 16),
}
B, P, T = 8, 49, 256     # the main path: max batch 8, 49 slots, chunk 256
B1, S1 = 4, 4096         # the one-shot path: 4 prompts of 4096 tokens


def _err(got, want, dname, weight=None):
    """(max abs error, its largest share of the elementwise tolerance): the
    tensor-core bound when ``weight`` ((P |V|) / l) is given."""
    from repro_torch.kernels.ref import tc_bf16_bound
    d = (got.float() - want.float()).abs()
    if weight is not None:
        tol = tc_bf16_bound(want, weight)
    else:
        atol, rtol = TOL[dname]
        tol = atol + rtol * want.float().abs()
    return float(d.max()), float((d / tol).max())


def _norm_err(got, want):
    return max(float(((g - w).abs() / w.abs().clamp_min(1e-6)).max())
               for g, w in zip(got, want))


def _check(worst, name, label, err, share, nerr=0.0, extra=""):
    print(f"  {name:23s} {label}: max abs err {err:.3g}, {share:.3g} of the "
          f"tolerance; norm rel err {nerr:.3g} (tol {NORM_RTOL}){extra}",
          flush=True)
    if not share <= 1 or not nerr <= NORM_RTOL:
        fail(f"{name} disagrees with its plain version on {label}")
    worst[name] = max(worst.get(name, 0.0), err)


def check_kernels(torch):
    from repro_torch.kernels.block_score import (block_score_cuda,
                                                 block_score_plain)
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   flash_attention_plain,
                                                   flash_route,
                                                   paged_prefill_cuda,
                                                   paged_prefill_plain,
                                                   prefill_route)
    from repro_torch.kernels.paged_attention import (
        combine_splits, dequantize, paged_attention_cuda,
        paged_attention_int8_cuda, paged_attention_int8_plain,
        paged_attention_plain)
    from repro_torch.kernels.ref import (abs_value_weight, churned_pool,
                                         prefill_positions)
    worst: dict = {}
    seed = 0
    for arch, (KV, G, hd, page) in SHAPES.items():
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            seed += 1
            k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, seed)
            k8, v8, ks, vs, pos8, bt8, cur8 = churned_pool(
                B, P, page, KV, hd, torch.int8, seed + 100)
            g = torch.Generator().manual_seed(seed)
            for window in (0, 8 * page):
                q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
                for splits in (1, 4):
                    kw = dict(window=window, num_splits=splits,
                              return_scores=True)
                    label = f"{arch} {dname} window {window} splits {splits}"
                    a, m, l, nk = paged_attention_cuda(q, k, v, pos, bt, cur,
                                                       **kw)
                    a2, m2, l2, nk2 = paged_attention_plain(q, k, v, pos, bt,
                                                            cur, **kw)
                    torch.cuda.synchronize()
                    _check(worst, "paged_decode", label,
                           *_err(combine_splits(a, m, l).to(dt),
                                 combine_splits(a2, m2, l2).to(dt), dname),
                           _norm_err(nk, nk2))
                    a, m, l, nk = paged_attention_int8_cuda(
                        q, k8, v8, ks, vs, pos8, bt8, cur8, **kw)
                    a2, m2, l2, nk2 = paged_attention_int8_plain(
                        q, k8, v8, ks, vs, pos8, bt8, cur8, **kw)
                    torch.cuda.synchronize()
                    _check(worst, "paged_decode_int8", label,
                           *_err(combine_splits(a, m, l).to(dt),
                                 combine_splits(a2, m2, l2).to(dt), dname),
                           _norm_err(nk, nk2))
                qp = prefill_positions(cur.cpu(), T).cuda()
                qf = torch.randn((B, T, KV * G, hd), generator=g).to(dt).cuda()
                kw = dict(window=window, return_scores=True)
                o, nk = paged_prefill_cuda(qf, k, v, pos, bt, qp, **kw)
                o2, nk2 = paged_prefill_plain(qf, k, v, pos, bt, qp, **kw)
                o3, _ = paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                           window=window, per_qhead=True)
                torch.cuda.synchronize()
                route = prefill_route(qf.dtype, k.dtype, hd)
                wt = abs_value_weight(qf, k, v, window=window, pos=pos,
                                      block_table=bt, q_pos=qp) \
                    if route == "tensor_core" else None
                label = f"{arch} {dname} window {window} ({route})"
                pad = float(o[B - 1].float().abs().max())
                if pad:
                    fail(f"paged_prefill: padding rows give {pad}, not 0")
                _check(worst, "paged_prefill", label,
                       *_err(o, o2, dname, wt), _norm_err(nk, nk2))
                fold = float((o3.float() - o.float()).abs().max())
                _check(worst, "paged_prefill_per_qhead", label,
                       *_err(o3, o2, dname, wt),
                       extra=f"; bit-equal to the G-fold kernel: "
                             f"{bool(torch.equal(o3, o))} (max diff {fold})")
                if not torch.equal(o3, o):
                    fail("the per-Q-head prefill kernel is not bit-equal to "
                         "the G-fold one")
            # flash attention: 128 tokens (B 2) and 4096 (B 1: the plain
            # version holds every head's (S, S) scores), window 0 and > 0
            S = 128 if dname == "float32" else S1
            nb = 2 if dname == "float32" else 1
            for window in (0, S // 4):
                x = [torch.randn((nb, S, n, hd), generator=g).to(dt).cuda()
                     for n in (KV * G, KV, KV)]
                o = flash_attention_cuda(*x, window=window)
                o2 = flash_attention_plain(*x, window=window)
                torch.cuda.synchronize()
                route = flash_route(dt, hd)
                wt = abs_value_weight(*x, window=window) \
                    if route == "tensor_core" else None
                _check(worst, "flash_attention",
                       f"{arch} {dname} S {S} window {window} ({route})",
                       *_err(o, o2, dname, wt))
                del x, o, o2, wt
            # page scores: the float pool and the dequantized int8 one
            for label, kp, vp, pp in (
                    (dname, k, v, pos),
                    ("int8", dequantize(k8, ks), dequantize(v8, vs), pos8)):
                got, want = block_score_cuda(kp, vp, pp), \
                    block_score_plain(kp, vp, pp)
                torch.cuda.synchronize()
                if not torch.equal(torch.isinf(got), torch.isinf(want)):
                    fail("block_score: empty pages differ")
                fin = torch.isfinite(want)
                err = float((got[fin] - want[fin]).abs().max())
                rel = float(((got[fin] - want[fin]).abs() /
                             want[fin].abs().clamp_min(1e-6)).max())
                _check(worst, "block_score", f"{arch} {label} pool",
                       err, 0.0, rel)
    return worst


def time_kernels(torch, F):
    """Times at the main paths' shapes (llama-3.2-1b, bf16): the serving
    path's decode (splits 4) and mixed steps (chunk 256) on churned pools,
    the one-shot prefill (B 4, 4096 tokens), the pool pass on the serving
    pool, each with its bound and yardsticks."""
    from repro_torch.kernels.block_score import (block_score_cuda,
                                                 block_score_plain)
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   flash_attention_plain,
                                                   flash_route,
                                                   paged_prefill_cuda,
                                                   paged_prefill_plain,
                                                   prefill_route)
    from repro_torch.kernels.paged_attention import (
        dequantize, paged_attention_cuda, paged_attention_int8_cuda,
        paged_attention_int8_plain, paged_attention_plain)
    from repro_torch.kernels.ref import (churned_pool, gather_block_table,
                                         prefill_positions)
    KV, G, hd, page = SHAPES["llama-3.2-1b"]
    H = KV * G
    dt, dname = torch.bfloat16, "bfloat16"
    k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, 100)
    k8, v8, ks, vs, _, _, _ = churned_pool(B, P, page, KV, hd, torch.int8,
                                           100)
    g = torch.Generator().manual_seed(100)
    q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
    qf = torch.randn((B, T, H, hd), generator=g).to(dt).cuda()
    qp = prefill_positions(cur.cpu(), T).cuda()
    dec = dict(num_splits=4, return_scores=True)
    pre = dict(return_scores=True)
    res = {}

    # bytes: the K/V of every distinct page the block tables reach (the
    # epilogue needs all of them), their positions, the tables, q, the
    # outputs; operations: 4 * hd per valid (query, key) pair
    kg, vg, pg = gather_block_table(k, v, pos, bt)
    phys = torch.unique(bt.clamp_min(0))
    n_el = phys.numel() * page * KV * hd
    meta = phys.numel() * page * 4 + nbytes(bt)
    kv_bytes = 2 * n_el * k.element_size() + meta
    kv8_bytes = 2 * n_el + 2 * phys.numel() * page * KV * 4 + meta
    norms_bytes = 2 * B * KV * P * page * 4
    S = P * page
    kpos = pg.reshape(B, 1, S)
    valid_dec = (kpos >= 0) & (kpos <= cur[:, None, None])
    flops = 4 * hd * H * int(valid_dec.sum())
    res["paged_decode"] = dict(
        ms=timed(torch, lambda: paged_attention_cuda(q, k, v, pos, bt, cur,
                                                     **dec)),
        plain_ms=timed(torch, lambda: paged_attention_plain(q, k, v, pos, bt,
                                                            cur, **dec)),
        bound=bound_ms(kv_bytes + nbytes(q, cur) + nbytes(q) + norms_bytes,
                       flops, dname))
    res["paged_decode_int8"] = dict(
        ms=timed(torch, lambda: paged_attention_int8_cuda(
            q, k8, v8, ks, vs, pos, bt, cur, **dec)),
        plain_ms=timed(torch, lambda: paged_attention_int8_plain(
            q, k8, v8, ks, vs, pos, bt, cur, **dec)),
        bound=bound_ms(kv8_bytes + nbytes(q, cur) + nbytes(q) + norms_bytes,
                       flops, dname))
    qpe = qp[:, :, None]
    valid_pre = (kpos >= 0) & (qpe >= 0) & (kpos <= qpe)       # (B, T, S)
    flops = 4 * hd * H * int(valid_pre.sum())
    res["paged_prefill"] = dict(
        ms=timed(torch, lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                                   **pre)),
        plain_ms=timed(torch, lambda: paged_prefill_plain(qf, k, v, pos, bt,
                                                          qp, **pre)),
        bound=bound_ms(kv_bytes + 2 * nbytes(qf) + nbytes(qp) + norms_bytes,
                       flops, dname))
    res["paged_prefill_per_qhead"] = dict(
        ms=timed(torch, lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                                   per_qhead=True)),
        plain_ms=timed(torch, lambda: paged_prefill_plain(qf, k, v, pos, bt,
                                                          qp,
                                                          per_qhead=True)),
        bound=bound_ms(kv_bytes + 2 * nbytes(qf) + nbytes(qp), flops, dname))
    # yardstick: one SDPA call on the gathered (B, KV, P * page, hd) view
    kd = kg.reshape(B, KV, S, hd)
    vd = vg.reshape(B, KV, S, hd)
    qd = q.reshape(B, H, 1, hd)
    md = valid_dec[:, :, None, :]
    sdpa_dec = timed(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=md, enable_gqa=True))
    res["paged_decode"]["library_ms"] = sdpa_dec
    kd8 = dequantize(k8, ks)[bt.clamp_min(0).long()].permute(0, 3, 1, 2, 4) \
        .reshape(B, KV, S, hd).to(dt)
    vd8 = dequantize(v8, vs)[bt.clamp_min(0).long()].permute(0, 3, 1, 2, 4) \
        .reshape(B, KV, S, hd).to(dt)
    res["paged_decode_int8"]["library_ms"] = timed(
        torch, lambda: F.scaled_dot_product_attention(
            qd, kd8, vd8, attn_mask=md, enable_gqa=True))
    qpf = qf.transpose(1, 2)
    mp = valid_pre[:, None]
    sdpa_pre = timed(torch, lambda: F.scaled_dot_product_attention(
        qpf, kd, vd, attn_mask=mp, enable_gqa=True))
    res["paged_prefill"]["library_ms"] = sdpa_pre
    res["paged_prefill_per_qhead"]["library_ms"] = sdpa_pre
    del kd8, vd8

    # the one-shot prefill: B 4 prompts of 4096 tokens; the plain version
    # at B 1 (it holds every head's (S, S) scores)
    x = [torch.randn((B1, S1, n, hd), generator=g).to(dt).cuda()
         for n in (H, KV, KV)]
    x1 = [t[:1] for t in x]
    flops = 4 * hd * H * B1 * S1 * (S1 + 1) // 2
    res["flash_attention"] = dict(
        ms=timed(torch, lambda: flash_attention_cuda(*x), iters=5),
        plain_ms=timed(torch, lambda: flash_attention_plain(*x1), iters=3,
                       warmup=1),
        plain_note=f"B 1 of {B1}",
        flops=flops,
        bound=bound_ms(2 * nbytes(x[0]) + nbytes(x[1], x[2]), flops, dname),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in x), is_causal=True,
            enable_gqa=True), iters=5))
    del x, x1
    # the pool pass over the serving pool (every page, one score each)
    res["block_score"] = dict(
        ms=timed(torch, lambda: block_score_cuda(k, v, pos)),
        plain_ms=timed(torch, lambda: block_score_plain(k, v, pos)),
        bound=bound_ms(nbytes(k, v, pos) + 4 * pos.shape[0],
                       4 * k.numel(), dname),
        library_ms=None)
    for name in ("paged_decode", "paged_decode_int8", "block_score"):
        res[name]["route"] = "cuda_core"
    for name in ("paged_prefill", "paged_prefill_per_qhead"):
        res[name]["route"] = prefill_route(qf.dtype, k.dtype, hd)
    res["flash_attention"]["route"] = flash_route(dt, hd)
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        note = f" ({r['plain_note']})" if "plain_note" in r else ""
        if "flops" in r:
            note += f" ({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s)"
        note += f", {r['route']} route"
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms{note}, library {lib}, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})", flush=True)
    return res


# ---------------------------------------------------------------------------
# phases 3-6: the engine and the one-shot path
# ---------------------------------------------------------------------------

def pool_totals(torch, eng):
    """[sum(ref_count), free pages, mapped entries] over every layer (one
    device read)."""
    return torch.stack([torch.stack([c.ref_count.sum(),
                                     (c.ref_count == 0).sum(),
                                     (c.block_table >= 0).sum()])
                        for c in eng.cache.layers]).sum(0).cpu().numpy()


def check_conservation(np, devstats, before, after, st):
    alloc, freed = st[devstats.PAGES_ALLOCATED], st[devstats.PAGES_FREED]
    rel, adopt = st[devstats.PAGES_RELEASED], st[devstats.PAGES_ADOPTED]
    want = np.array([alloc + adopt - rel, freed - alloc,
                     alloc + adopt - rel])
    if not np.array_equal(after - before, want):
        fail(f"devstats conservation: pool moved {after - before}, "
             f"devstats say {want}")


def check_invariants(np, layers):
    for i, c in enumerate(layers):
        ref = c.ref_count.cpu().numpy()
        bt = c.block_table.cpu().numpy()
        pos = c.pos.cpu().numpy()
        mapped = bt[bt >= 0]
        for b in range(bt.shape[0]):                              # F3
            row = bt[b][bt[b] >= 0]
            if len(row) != len(set(row.tolist())):
                fail(f"F3: layer {i} row {b} maps a page twice")
        if not np.array_equal(np.bincount(mapped, minlength=ref.size), ref):
            fail(f"F2: layer {i} ref counts disagree with block tables")
        if (ref < 0).any() or int((ref > 0).sum()) + int((ref == 0).sum()) \
                != ref.size:
            fail(f"F1: layer {i} free-list conservation")
        if not (pos[ref == 0] == -1).all():
            fail(f"F4: layer {i} a free page holds live tokens")


def run_engine(torch, np, devstats, eng, prompts, new_tokens):
    """Serve ``prompts`` to the end, checking the devstats conservation
    identities at every step. Returns ({request id: tokens}, per-step
    devstats, wall seconds without the checks)."""
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    per_step = []
    t0, t_check = time.perf_counter(), 0.0
    while True:
        c0 = time.perf_counter()
        before = pool_totals(torch, eng)
        t_check += time.perf_counter() - c0
        more = eng.step()
        c0 = time.perf_counter()
        check_conservation(np, devstats, before, pool_totals(torch, eng),
                           eng.last_stats)
        per_step.append(eng.last_stats.copy())
        t_check += time.perf_counter() - c0
        if not more:
            break
    wall = time.perf_counter() - t0 - t_check
    tokens = {r.request_id: list(r.output_tokens)
              for r in eng.scheduler.finished}
    return tokens, per_step, wall


def pool_state(np, layers):
    """Per layer: the integer pool state (one array) and, on int8 pools,
    (int8 K and V, their scales)."""
    ints, q8 = [], []
    for c in layers:
        ints.append(np.concatenate([
            t.cpu().numpy().ravel()
            for t in (c.block_table, c.ref_count, c.pos, c.cur_page,
                      c.cur_off)]))
        if c.quantized:
            q8.append(tuple(t.cpu().numpy()
                            for t in (c.k, c.v, c.k_scale, c.v_scale)))
    return ints, q8


def compare_int8(np, q8k, q8p, what):
    """int8 values and scales of two runs. Layer 0's inputs are the same
    bits on both (embedding and projections only), so its int8 values and
    scales must be equal; deeper layers see attention outputs that differ
    in the last f32 bits, and a value on a rounding boundary may then land
    one int8 step away: those are counted, and must stay one step and rare."""
    flips = total = 0
    for i, (a, b) in enumerate(zip(q8k, q8p)):
        for name, x, y in zip(("k", "v", "k_scale", "v_scale"), a, b):
            if i == 0 and not np.array_equal(x, y):
                fail(f"{what}: layer 0 {name} differs")
            if name.endswith("scale"):
                if not np.allclose(x, y, rtol=1e-5, atol=0):
                    fail(f"{what}: layer {i} {name} beyond 1e-5 relative")
                continue
            d = np.abs(x.astype(np.int32) - y.astype(np.int32))
            if d.max() > 1:
                fail(f"{what}: layer {i} {name} differs by {d.max()} steps")
            flips += int((d > 0).sum())
            total += d.size
    if flips > 1e-4 * total:
        fail(f"{what}: {flips} of {total} int8 values differ")
    return flips, total


def record_quantize():
    """Wrap the pools' quantizer so that every input it is given is kept, in
    call order. Returns (the list, a function that removes the wrap)."""
    from repro_torch.core import paged_cache
    orig = paged_cache.quantize_absmax
    seen = []

    def rec(x):
        seen.append(x.detach().float().clone())
        return orig(x)

    paged_cache.quantize_absmax = rec
    return seen, lambda: setattr(paged_cache, "quantize_absmax", orig)


def first_flip(torch, xk, xp):
    """Where two runs' quantizer inputs (same calls, same order) round to
    different int8 values: how many values in how many calls, and the first
    one with its input and its pre-rounding value x / absmax * 127 on both
    sides."""
    n_flip = n_calls = 0
    first = "none"
    for i, (a, b) in enumerate(zip(xk, xp)):
        if a.shape != b.shape:
            fail(f"quantizer call {i}: shapes {a.shape} and {b.shape}")
        sa, sb = a.abs().amax(-1), b.abs().amax(-1)
        ra = a / sa.clamp_min(1e-8)[..., None] * 127.0
        rb = b / sb.clamp_min(1e-8)[..., None] * 127.0
        d = torch.round(ra) != torch.round(rb)
        if not d.any():
            continue
        n_flip += int(d.sum())
        n_calls += 1
        if first == "none":
            j = tuple(int(t) for t in d.nonzero()[0])
            first = (f"call {i} of {len(xk)}, element {j}: input "
                     f"{float(a[j]):.9g} / {float(b[j]):.9g}, absmax "
                     f"{float(sa[j[:-1]]):.9g} / {float(sb[j[:-1]]):.9g}, "
                     f"x / absmax * 127 = {float(ra[j]):.9g} / "
                     f"{float(rb[j]):.9g} -> {int(torch.round(ra[j]))} / "
                     f"{int(torch.round(rb[j]))} (kernels / plain)")
    return f"{n_flip} values in {n_calls} calls differ; first: {first}"


def _reduced(get_arch):
    return dataclasses.replace(get_arch("llama-3.2-1b").reduced(),
                               num_heads=4, num_kv_heads=2)


def engine_parity(torch, np, kv_dtype):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = _reduced(get_arch)
    params = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([shared if i % 2 else
                               rng.integers(0, cfg.vocab_size, 32),
                               rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(8, 64)))])
               .astype(np.int32) for i in range(8)]
    out, inputs = [], []
    for plain in (False, True):
        eng = Engine(cfg, params, cache_cfg=CacheConfig(
            page_size=8, cache_budget=48, dtype=kv_dtype), max_batch=4,
            max_prompt_len=96, max_new_tokens=16, chunk_size=32,
            decode_splits=2, device="cuda", plain_kernels=plain)
        seen, undo = record_quantize()
        try:
            toks, steps, _ = run_engine(torch, np, devstats, eng, prompts, 16)
        finally:
            undo()
        inputs.append(seen)
        out.append((toks, steps, *pool_state(np, eng.cache.layers), eng.stats))
    (tk, sk, ik, qk, stk), (tp, sp, ip, qp, stp) = out
    what = f"engine parity ({kv_dtype})"
    if tk != tp:
        fail(f"{what}: greedy tokens differ between kernels and plain")
    if len(sk) != len(sp) or any(not np.array_equal(a, b)
                                 for a, b in zip(sk, sp)):
        fail(f"{what}: per-step devstats differ")
    if any(not np.array_equal(a, b) for a, b in zip(ik, ip)):
        fail(f"{what}: final integer pool state differs")
    flips = compare_int8(np, qk, qp, what) if qk else (0, 0)
    if qk:
        print(f"  engine int8 quantizer inputs: {first_flip(torch, *inputs)}",
              flush=True)
    if not stk.pages_evicted or not stk.shared_prefix_hits:
        fail(f"{what} exercised too little: {stk}")
    print(f"  engine {kv_dtype:8s}: {len(tk)} requests, {len(sk)} steps: "
          f"tokens, per-step devstats and pool state equal; int8 values "
          f"one step apart {flips[0]} of {flips[1]}; evicted "
          f"{stk.pages_evicted} pages, {stk.shared_prefix_hits} prefix "
          f"adoptions", flush=True)


def oneshot_run(torch, params, cfg, ccfg, tokens, valid, steps, plain,
                decode_splits=1):
    """forward_prefill, then ``steps`` greedy decode_steps (the kernels'
    eviction ranking, fused_scores, on both). The caches get devstats
    vectors after the prefill (a wholesale reset, it emits none), so every
    decode step's events are read. Returns (tokens (B, steps), layer
    caches, live tokens per row after prefill, per-step devstats (steps,
    NSTATS), prefill seconds, decode seconds)."""
    from repro_torch.core import devstats
    from repro_torch.core.policies import get_policy
    from repro_torch.models.transformer import (collect_step_stats,
                                                decode_step, forward_prefill)
    pol = get_policy(ccfg.policy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = forward_prefill(params, cfg, tokens, pol, ccfg,
                                    valid=valid,
                                    total_seq_hint=tokens.shape[1] + steps,
                                    plain_kernels=plain)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    live = torch.stack([c.total_valid() for c in cache.layers])
    for c in cache.layers:
        c.stats = devstats.zeros(c.device)
    out, stats = [], []
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, tok, cache, pol, ccfg,
                                    decode_splits=decode_splits,
                                    fused_scores=True, plain_kernels=plain)
        stats.append(collect_step_stats(cache))
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not bool(torch.isfinite(logits).all()):
        fail("one-shot: non-finite logits")
    return (torch.stack(out, 1).cpu().numpy(), cache.layers, live,
            torch.stack(stats).cpu().numpy(), t1 - t0, t2 - t1)


def oneshot_parity(torch, np, kv_dtype, S=128):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    cfg = _reduced(get_arch)
    params = init_model(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    Bp = 3
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bp, S))
                              .astype(np.int32)).cuda()
    valid = torch.arange(S, device="cuda")[None, :] < \
        torch.tensor([[S], [S - 5], [S - 19]], device="cuda")
    ccfg = CacheConfig(page_size=8, cache_budget=32, dtype=kv_dtype)
    reset_launches()
    runs, inputs = [], []
    for plain in (False, True):
        seen, undo = record_quantize()
        try:
            runs.append(oneshot_run(torch, params, cfg, ccfg, tokens, valid,
                                    8, plain, decode_splits=2))
        finally:
            undo()
        inputs.append(seen)
    launches = read_launches()
    (tk, lk, _, sk, _, _), (tp, lp, _, sp, _, _) = runs
    what = f"one-shot parity ({kv_dtype}, S {S})"
    dec = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    if not launches["flash_attention"] or not launches[dec]:
        fail(f"{what}: kernels not launched: {launches}")
    if not np.array_equal(tk, tp):
        fail(f"{what}: greedy tokens differ")
    if not np.array_equal(sk, sp):
        fail(f"{what}: per-step devstats differ")
    ik, qk = pool_state(np, lk)
    ip, qp = pool_state(np, lp)
    if any(not np.array_equal(a, b) for a, b in zip(ik, ip)):
        fail(f"{what}: integer cache state differs")
    flips = compare_int8(np, qk, qp, what) if qk else (0, 0)
    evicted = int(sk[:, devstats.PAGES_EVICTED].sum())
    if not evicted:
        fail(f"{what}: no page was evicted in decode")
    if qk:
        print(f"  one-shot int8 quantizer inputs: "
              f"{first_flip(torch, *inputs)}", flush=True)
    print(f"  one-shot {kv_dtype:8s} S {S}: {tk.shape[0]} prompts, 8 steps: "
          f"tokens, per-step devstats and integer cache state equal; int8 "
          f"values one step apart {flips[0]} of {flips[1]}; evicted "
          f"{evicted} pages; launches {launches}", flush=True)


def serve_full_width(torch, np, kv_dtype, n_requests):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = get_arch("llama-3.2-1b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    eng = Engine(cfg, params, cache_cfg=CacheConfig(
        page_size=16, cache_budget=512, policy="paged_eviction",
        dtype=kv_dtype), max_batch=8, max_prompt_len=2048,
        max_new_tokens=32, chunk_size=256, decode_splits=4, device="cuda")
    torch.cuda.synchronize()
    print(f"  model + caches ready in {time.perf_counter() - t0:.1f} s; "
          f"pool payload {eng.pool_bytes()['payload_total'] / 2 ** 20:.1f} "
          f"MiB over {cfg.num_layers} layers ({kv_dtype})", flush=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 256)
    prompts = []
    for i in range(n_requests):
        n = int(rng.integers(1024, 2049))
        head = shared if i % 2 == 0 else rng.integers(0, cfg.vocab_size, 256)
        prompts.append(np.concatenate(
            [head, rng.integers(0, cfg.vocab_size, n - 256)]).astype(np.int32))
    reset_launches()
    tokens, _, wall = run_engine(torch, np, devstats, eng, prompts, 32)
    launches = read_launches()
    s = eng.stats
    print(f"  {len(tokens)} requests, {s.tokens_generated} tokens, "
          f"{s.steps} steps ({s.steps - s.decode_steps} mixed, "
          f"{s.decode_steps} decode-only) in {wall:.2f} s: "
          f"{s.tokens_generated / wall:.1f} tok/s; mean step "
          f"{1e3 * s.prefill_s / max(s.steps - s.decode_steps, 1):.2f} ms "
          f"mixed, {1e3 * s.decode_s / max(s.decode_steps, 1):.2f} ms "
          f"decode-only; launches {launches}", flush=True)
    print(f"  pages evicted {s.pages_evicted}, forced {s.forced_evictions}, "
          f"prefix adoptions {s.shared_prefix_hits} "
          f"({s.shared_prefix_tokens} prompt tokens skipped); "
          f"pool {eng.pool_stats()}", flush=True)
    if len(tokens) != n_requests or any(len(t) != 32
                                        for t in tokens.values()):
        fail(f"not every request finished with 32 tokens: "
             f"{ {k: len(t) for k, t in tokens.items()} }")
    if any(not 0 <= x < cfg.vocab_size for t in tokens.values() for x in t):
        fail("a sampled token is outside the vocabulary")
    dec = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    others = {"paged_decode", "paged_decode_int8"} - {dec}
    if not launches[dec] or not launches["paged_prefill"] or \
            any(launches[n] for n in others):
        fail(f"the {kv_dtype} path's kernels did not run as expected: "
             f"{launches}")
    # bf16 pool: every prefill launch on the tensor cores; int8 pool (its
    # dequantized f32 view under a bf16 query): every one on the CUDA cores
    route = "cuda_core" if kv_dtype == "int8" else "tensor_core"
    if launches[f"paged_prefill/{route}"] != launches["paged_prefill"]:
        fail(f"{kv_dtype} serving: not every prefill launch took the "
             f"{route} route: {launches}")
    if not s.pages_evicted or not s.shared_prefix_hits:
        fail(f"no eviction or no prefix sharing at full width: {s}")
    check_invariants(np, eng.cache.layers)
    return launches


def oneshot_full_width(torch, np):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    cfg = get_arch("llama-3.2-1b")
    params = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B1, S1))
                              .astype(np.int32)).cuda()
    lens = torch.tensor([S1, S1 - 96, S1 - 1000, S1 - 2049], device="cuda")
    valid = torch.arange(S1, device="cuda")[None, :] < lens[:, None]
    budget, page, steps = 512, 16, 32
    out, launches_all = {}, {}
    for kv_dtype in ("bfloat16", "int8"):
        ccfg = CacheConfig(page_size=page, cache_budget=budget,
                           policy="paged_eviction", dtype=kv_dtype)
        reset_launches()
        toks, layers, live, stats, t_pre, t_dec = oneshot_run(
            torch, params, cfg, ccfg, tokens, valid, steps, plain=False,
            decode_splits=4)
        torch.cuda.synchronize()
        launches = read_launches()
        # the pool pass (block_score) is the oracle of the fused epilogue:
        # both score the pool after decode the same, bf16 or int8
        q = torch.randn((B1, cfg.num_heads, cfg.resolved_head_dim),
                        device="cuda").to(torch.bfloat16)
        worst = 0.0
        for c in layers:
            _, fused = ops.paged_attention(q, c, cur_pos=c.pos.max().expand(
                B1), return_scores=True)
            pool = ops.page_scores(c)
            fin = torch.isfinite(pool)
            if not torch.equal(fin, torch.isfinite(fused)):
                fail("one-shot: the pool pass and the epilogue disagree on "
                     "which pages are empty")
            worst = max(worst, float(((pool[fin] - fused[fin]).abs() /
                                      pool[fin].abs()).max()))
        if worst > NORM_RTOL:
            fail(f"one-shot: pool page scores vs the epilogue: {worst}")
        dec = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
        if not launches["flash_attention"] or not launches[dec]:
            fail(f"one-shot {kv_dtype}: kernels not launched: {launches}")
        if launches["flash_attention/tensor_core"] != cfg.num_layers or \
                launches["flash_attention"] != cfg.num_layers:
            fail(f"one-shot {kv_dtype}: the prefill did not run all "
                 f"{cfg.num_layers} flash launches on the tensor cores: "
                 f"{launches}")
        max_live = int(live.max())
        if max_live > budget + page:
            fail(f"one-shot {kv_dtype}: {max_live} live tokens after "
                 f"prefill, above budget + page")
        evicted = int(stats[:, devstats.PAGES_EVICTED].sum())
        if not evicted:
            fail(f"one-shot {kv_dtype}: no page evicted during decode")
        check_invariants(np, layers)
        pool_b = sum(nbytes(c.k_buf, c.v_buf, c.k_scale_buf, c.v_scale_buf)
                     for c in layers)
        print(f"  {kv_dtype:8s}: prefill {1e3 * t_pre:.1f} ms, mean decode "
              f"step {1e3 * t_dec / steps:.2f} ms, {B1 * steps / t_dec:.1f} "
              f"decode tok/s; live tokens after prefill <= {max_live}; "
              f"{evicted} pages evicted in decode; pool "
              f"payload {pool_b} bytes; pool pass vs epilogue page scores "
              f"rel err {worst:.3g}; launches {launches}", flush=True)
        out[kv_dtype] = toks
        launches_all[kv_dtype] = launches
        del layers
    agree = float((out["bfloat16"] == out["int8"]).mean())
    print(f"  greedy tokens equal on bf16 and int8 pools: {agree:.4f} of "
          f"{out['int8'].size}", flush=True)
    return launches_all


def main() -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[1/6] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry func")):
                print(f"  {name}: {line.strip()}", flush=True)

    def phase(title):
        print(f"{title} (at {time.perf_counter() - t_start:.0f} s)",
              flush=True)

    phase("[2/6] kernels against their plain versions")
    reset_launches()
    worst = check_kernels(torch)
    checked = read_launches()
    timing = time_kernels(torch, F)

    phase("[3/6] kernels vs plain versions: engine and one-shot, float and "
          "int8 pools")
    for kv_dtype in ("float32", "int8"):
        engine_parity(torch, np, kv_dtype)
    for kv_dtype in ("float32", "int8"):
        oneshot_parity(torch, np, kv_dtype)
    # a ragged prompt above 2048 tokens: the flash kernel on the card
    oneshot_parity(torch, np, "float32", S=3000)

    phase("[4/6] llama-3.2-1b at full width: serving, bf16 pool")
    serve = serve_full_width(torch, np, "bfloat16", 16)
    torch.cuda.empty_cache()

    phase("[5/6] llama-3.2-1b at full width: one-shot, bf16 and int8 pools")
    oneshot = oneshot_full_width(torch, np)
    torch.cuda.empty_cache()

    phase("[6/6] llama-3.2-1b at full width: serving, int8 pool")
    serve8 = serve_full_width(torch, np, "int8", 8)

    # launches on the main paths: decode and prefill from serving (phases 4
    # and 6), flash attention from the one-shot prefill (phase 5); the
    # per-Q-head kernel and the pool pass, oracles on no path, from phase 2
    launches = {"paged_decode": serve["paged_decode"],
                "paged_decode_int8": serve8["paged_decode_int8"],
                "paged_prefill": serve["paged_prefill"],
                "paged_prefill_per_qhead": checked["paged_prefill_per_qhead"],
                "flash_attention": oneshot["bfloat16"]["flash_attention"],
                "block_score": checked["block_score"]}
    rows = []
    for name, meta in KERNELS.items():
        r = timing[name]
        if not launches[name]:
            fail(f"{name} was never launched")
        rows.append({"name": name, "route": "cuda", **meta,
                     "launches": launches[name],
                     "max_abs_err": worst[name], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"],
                     "timed_route": r["route"]})
    print(f"done in {time.perf_counter() - t_start:.0f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
