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
              3.1-8b, and at page 32 and KV 2; the decode kernel also at
              qwen2.5-3b's heads, G 1 and 2 at page 8, splits 1, 2, 4 and one
              page per split, every q / pool dtype pair, with a row of no
              mapped slot and a row at cur_pos -1; the per-Q-head prefill
              kernel also bit for bit against the G-fold one. Every kernel
              also at the head dims beside 64 and 128: TINY's 32 (4 heads, 4
              KV heads), stablelm-3b's 80 (32 and 32) and 96 at G 4 (the
              decode kernel over a pool of the query's dtype or int8). f32
              cases within 1e-4; the tensor-core routes (bf16 prefill over a bf16
              pool, bf16 flash) within the derived bound 1e-5 + 2**-7 |plain|
              + 2**-8 (P |V|) / l; each case names its route. Then each one's
              time at the main path's shapes, as ms (events around the call,
              host work included) and device_ms (the device's work alone,
              after a flush that writes the L2, and after one that reads
              it), beside the launch floor (an empty kernel's device_ms), its
              bound, the plain version's time and one PyTorch call's
              (scaled_dot_product_attention, a yardstick only, also in both
              clocks); and each one's device_ms and bound at those three
              head dims, at their models' dtypes (TINY f32, the others bf16)
  3. parity   a reduced f32 config (KV 2, G 2) run twice on the card, through
              the kernels and through their plain versions, under
              paged_eviction and each of the paper's baselines: the engine on
              a float and on an int8 pool, and the one-shot path
              (forward_prefill + 8 decode_steps) on a float and an int8 pool;
              and paged_eviction on a float pool with a ragged prompt of 3000
              tokens; greedy tokens, devstats and the integer pool state
              equal; on int8 pools, where a quantizer input rounds
              differently on the two runs, the first such value on both
              sides. The engines run with a trace, the lineage ledger and a
              timeline: the two routes' step records (timing fields aside)
              and lineage events equal, the ledger reconciled after every
              step; and the float paged_eviction requests served once more
              with regret probes every 2 decode steps give the same tokens
              and the same kernel launches
  4. serve    llama-3.2-1b at full width (bf16, random weights from a seed):
              16 requests of 1024-2048 prompt tokens (half share a 256-token
              prefix), 32 greedy tokens each, under paged_eviction (page 16,
              budget 512, max batch 8, chunk 256, decode splits 4). Checks
              every request's token count, that both kernels ran (every
              prefill launch on the tensor-core route), that pages were
              evicted and prefixes shared, the pool invariants F1-F4 and the
              devstats conservation identities at every step. Runs with
              metrics, a trace, a timeline and the lineage ledger: the
              ledger reconciles after every step, the trace validates with
              one step record per step whose devstats sum to EngineStats',
              the lineage counts stay within devstats, the timeline has one
              track per request, TTFT and ITL histograms count every first
              and later token; prints the hooks' median host ms per step
              and its share of the step.
  5. one-shot llama-3.2-1b at full width, the paper's own experiment: 4
              prompts of up to 4096 tokens prefilled through the flash
              kernel (all 16 launches on the tensor-core route), compressed
              to budget 512 by Alg. 2, then 32 greedy tokens under Alg. 3,
              once on a bf16 and once on an int8 pool
  6. int8     phase 4's workload (4 requests) served on an int8 pool (every
              prefill launch on the CUDA-core route: a bf16 query over the
              dequantized f32 pool)
  7. baselines the paper's comparison: streaming_llm, inverse_key_l2 and
              keydiff each serve 4 of phase 4's requests (16 greedy tokens)
              and run phase 5's prompts one-shot (bf16, 16 decode steps),
              at 8 of the model's 16 layers (full width; depth cut for the
              run time).
              Checks after every step the budget (budget + page, plus the
              shared prefix for rows that share one: copy-on-write sheds it
              one page per call), StreamingLLM's sinks (unless the layer
              forced a rollover), that tokens were evicted, F1-F4 and the
              kernels' routes; prints tok/s, step times, live tokens per
              mapped page, forced evictions and prefix adoptions.
  8. regret   eviction-regret shadow probes at full width: 2 of phase 4's
              requests, 16 greedy tokens, probes every 4 decode steps, under
              paged_eviction at budget 512; every probe's divergence finite,
              its evicted attention mass in [0, 1] and above 0 in one probe
              at least; prints the shadow cache's bytes and the taps read
              per step.

Prints the card's name and power limit, one JSON line describing every
kernel (with the route each timing took, "timed_route", the device-only
times "device_ms", "device_clean_ms" and "library_device_ms", the launch
floor "floor_device_ms", the head dims it was checked at, "head_dims", and
its device_ms and bound at hd 32, 80 and 96, "other_head_dims"), and as the
last line {"ok": true, "device":
{...}}. Exits non-zero without a CUDA device or without the repository's
sources beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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


_CYCLES_PER_MS: list = []


def device_timed(torch, fn, iters=20, warmup=3, clean=False):
    """Mean device ms of ``fn``, without the host's work: as :func:`timed`
    (L2 flushed, CUDA events), but the card first spins
    (``torch.cuda._sleep``) for ten times as long as the host takes to
    enqueue ``fn``, so the start event runs only after the whole call is
    queued and the events bracket the device's work alone. A call whose
    enqueue still outlasted the spin is not counted; fails if half are
    not. The flush writes 64 MiB, so the L2 may hold dirty lines that
    ``fn``'s reads first write back; ``clean`` flushes by reading instead
    (the L2 then holds clean lines), which takes any such write-back out."""
    buf = torch.zeros(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sink = torch.empty((), dtype=torch.int64, device="cuda")
    flush = (lambda: torch.sum(buf, 0, dtype=torch.int64, out=sink)) if clean \
        else buf.zero_
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    if not _CYCLES_PER_MS:
        e0, e1 = ev(), ev()
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        e1.synchronize()
        _CYCLES_PER_MS.append(1e7 / e0.elapsed_time(e1))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin_ms = max(0.5, 10e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(int(spin_ms * _CYCLES_PER_MS[0]))
        e0, e1 = ev(), ev()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        lag_ms = 1e3 * (time.perf_counter() - t0)
        e1.synchronize()
        if lag_ms < spin_ms:
            times.append(e0.elapsed_time(e1))
    if 2 * len(times) < iters:
        fail(f"device_timed: the host outlasted a {spin_ms:.2f} ms spin in "
             f"{iters - len(times)} of {iters} calls")
    return sum(times) / len(times)


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


# kernel name -> the head dims phase 2 held it at
HEAD_DIMS_CHECKED: dict = {}


def _check(worst, name, label, err, share, nerr=0.0, extra="", hd=None):
    print(f"  {name:23s} {label}: max abs err {err:.3g}, {share:.3g} of the "
          f"tolerance; norm rel err {nerr:.3g} (tol {NORM_RTOL}){extra}",
          flush=True)
    if not share <= 1 or not nerr <= NORM_RTOL:
        fail(f"{name} disagrees with its plain version on {label}")
    worst[name] = max(worst.get(name, 0.0), err)
    HEAD_DIMS_CHECKED.setdefault(name, set()).add(hd)


DECODE_SHAPES = {  # name: (KV, G, hd, page)
    **SHAPES,
    "qwen2.5-3b": (2, 8, 128, 16),
    "reduced, G 2": (2, 2, 64, 8),        # phase 3's config
    "G 1": (4, 1, 64, 8),
}
# the head dims beside 64 and 128, each at the heads of a model that has it
# (KV, G, hd, page) and that model's dtype: TINY (benchmarks/accuracy.py),
# stablelm-3b, and hd 96 (the reduced configs' override) at G 4
NEW_HD_SHAPES = {
    "TINY (hd 32)": ((4, 1, 32, 16), "float32"),
    "stablelm-3b (hd 80)": ((32, 1, 80, 16), "bfloat16"),
    "G 4 at hd 96": ((8, 4, 96, 16), "bfloat16"),
}


def check_decode(torch, worst):
    """The decode kernel (float and int8 pools) against its plain version:
    every shape of DECODE_SHAPES, every q / pool dtype pair the wrapper
    takes, window 0 and 8 pages, splits 1, 2, 4 and P (one page per split),
    on churned pools whose row 1 has no mapped slot and row 2 sits at
    cur_pos -1 (both must give exact zeros). One line per (shape, pair)
    with the worst case over windows and splits."""
    from repro_torch.kernels.paged_attention import (
        combine_splits, paged_attention_cuda, paged_attention_int8_cuda,
        paged_attention_int8_plain, paged_attention_plain)
    from repro_torch.kernels.ref import churned_pool
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    pairs = [(f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16), (f32, i8),
             (bf16, i8)]
    shapes = {**DECODE_SHAPES,
              **{k: shape for k, (shape, _) in NEW_HD_SHAPES.items()}}
    for n, (arch, (KV, G, hd, page)) in enumerate(shapes.items()):
        for qt, pt in pairs:
            if hd not in (64, 128) and pt not in (qt, i8):
                continue        # a pool of the query's dtype or int8 there
            seed = 1000 + 10 * n + pairs.index((qt, pt))
            pool = churned_pool(B, P, page, KV, hd, pt, seed)
            *pool, bt, cur = pool
            bt[1] = -1
            cur[2] = -1
            g = torch.Generator().manual_seed(seed)
            q = torch.randn((B, KV, G, hd), generator=g).to(qt).cuda()
            name, kernel, plain = ("paged_decode_int8",
                                   paged_attention_int8_cuda,
                                   paged_attention_int8_plain) \
                if pt == i8 else ("paged_decode", paged_attention_cuda,
                                  paged_attention_plain)
            dname = str(qt).removeprefix("torch.")
            err = share = nerr = 0.0
            for window in (0, 8 * page):
                for splits in (1, 2, 4, P):
                    kw = dict(window=window, num_splits=splits,
                              return_scores=True)
                    a, m, l, nk = kernel(q, *pool, bt, cur, **kw)
                    a2, m2, l2, nk2 = plain(q, *pool, bt, cur, **kw)
                    o = combine_splits(a, m, l).to(qt)
                    torch.cuda.synchronize()
                    if o[1:3].any():
                        fail(f"{name}: the unmapped row or the row at "
                             f"cur_pos -1 is not zero ({arch}, window "
                             f"{window}, splits {splits})")
                    e, sh = _err(o, combine_splits(a2, m2, l2).to(qt), dname)
                    err, share = max(err, e), max(share, sh)
                    nerr = max(nerr, _norm_err(nk, nk2))
            _check(worst, name, f"{arch} (KV {KV}, G {G}, hd {hd}, page "
                   f"{page}) q {dname} pool {str(pt).removeprefix('torch.')}"
                   f", 2 windows x splits 1/2/4/{P}", err, share, nerr, hd=hd)


def check_kernels(torch):
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   flash_attention_plain,
                                                   flash_route,
                                                   paged_prefill_cuda,
                                                   paged_prefill_plain,
                                                   prefill_route)
    from repro_torch.kernels.paged_attention import dequantize
    from repro_torch.kernels.ref import (abs_value_weight, churned_pool,
                                         prefill_positions)
    worst: dict = {}
    check_decode(torch, worst)
    seed = 0
    shapes = {**SHAPES,
              **{k: shape for k, (shape, _) in NEW_HD_SHAPES.items()}}
    for arch, (KV, G, hd, page) in shapes.items():
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            seed += 1
            k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, seed)
            k8, v8, ks, vs, pos8, _, _ = churned_pool(
                B, P, page, KV, hd, torch.int8, seed + 100)
            g = torch.Generator().manual_seed(seed)
            for window in (0, 8 * page):
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
                       *_err(o, o2, dname, wt), _norm_err(nk, nk2), hd=hd)
                fold = float((o3.float() - o.float()).abs().max())
                _check(worst, "paged_prefill_per_qhead", label,
                       *_err(o3, o2, dname, wt),
                       extra=f"; bit-equal to the G-fold kernel: "
                             f"{bool(torch.equal(o3, o))} (max diff {fold})",
                       hd=hd)
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
                       *_err(o, o2, dname, wt), hd=hd)
                del x, o, o2, wt
            # page scores: the float pool and the dequantized int8 one
            check_block_score(torch, worst, f"{arch} {dname} pool", k, v, pos)
            check_block_score(torch, worst, f"{arch} int8 pool",
                              dequantize(k8, ks), dequantize(v8, vs), pos8)
            del k, v, pos, k8, v8, ks, vs, pos8
    # the page-score kernel's other block shapes: page 32, and KV 2 (two
    # pages per block), each with an empty page
    for page, KV, hd in ((32, 8, 64), (16, 2, 64)):
        for dt in (torch.float32, torch.bfloat16):
            k, v, pos, bt, _ = churned_pool(B, P, page, KV, hd, dt,
                                            page + KV)
            pos[bt[0, 0]] = -1
            check_block_score(torch, worst, f"page {page}, KV {KV}, hd {hd} "
                              f"{str(dt).removeprefix('torch.')} pool",
                              k, v, pos)
    return worst


def check_block_score(torch, worst, label, k, v, pos):
    """The page-score kernel against its plain version on one pool: the same
    empty pages, scores within NORM_RTOL."""
    from repro_torch.kernels.block_score import (block_score_cuda,
                                                 block_score_plain)
    got, want = block_score_cuda(k, v, pos), block_score_plain(k, v, pos)
    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        fail("block_score: empty pages differ")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    rel = float(((got[fin] - want[fin]).abs() /
                 want[fin].abs().clamp_min(1e-6)).max())
    _check(worst, "block_score", label, err, 0.0, rel, hd=k.shape[-1])


def time_kernels(torch, F, shape=None, dname="bfloat16", full=True):
    """Times at the main paths' shapes (llama-3.2-1b's heads ``shape``,
    (KV, G, hd, page), in bf16 unless given): the serving path's decode
    (splits 4) and mixed steps (chunk 256) on churned pools, the one-shot
    prefill (B 4, 4096 tokens), the pool pass on the serving pool, each with
    its bound and yardsticks; ``full=False``: device_ms and the bound
    only."""
    from repro_torch.kernels.block_score import (block_score_cuda,
                                                 block_score_plain,
                                                 launch_floor_cuda)
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
    KV, G, hd, page = shape or SHAPES["llama-3.2-1b"]
    H = KV * G
    dt = getattr(torch, dname)
    k, v, pos, bt, cur = churned_pool(B, P, page, KV, hd, dt, 100)
    k8, v8, ks, vs, _, _, _ = churned_pool(B, P, page, KV, hd, torch.int8,
                                           100)
    g = torch.Generator().manual_seed(100)
    q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
    qf = torch.randn((B, T, H, hd), generator=g).to(dt).cuda()
    qp = prefill_positions(cur.cpu(), T).cuda()
    dec = dict(num_splits=4, return_scores=True)
    pre = dict(return_scores=True)

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
    flops_dec = 4 * hd * H * int(valid_dec.sum())
    qpe = qp[:, :, None]
    valid_pre = (kpos >= 0) & (qpe >= 0) & (kpos <= qpe)       # (B, T, S)
    flops_pre = 4 * hd * H * int(valid_pre.sum())
    # the one-shot prefill: B 4 prompts of 4096 tokens; the plain version
    # at B 1 (it holds every head's (S, S) scores)
    x = [torch.randn((B1, S1, n, hd), generator=g).to(dt).cuda()
         for n in (H, KV, KV)]
    x1 = [t[:1] for t in x]
    flops_flash = 4 * hd * H * B1 * S1 * (S1 + 1) // 2
    # yardsticks: one SDPA call on the gathered (B, KV, P * page, hd) view
    # (dequantized for int8), and causal GQA SDPA for the flash kernel
    kd = kg.reshape(B, KV, S, hd)
    vd = vg.reshape(B, KV, S, hd)
    qd = q.reshape(B, H, 1, hd)
    kd8, vd8 = (dequantize(x8, s8)[bt.clamp_min(0).long()]
                .permute(0, 3, 1, 2, 4).reshape(B, KV, S, hd).to(dt)
                for x8, s8 in ((k8, ks), (v8, vs)))
    sdpa = F.scaled_dot_product_attention
    sdpa_pre = lambda: sdpa(qf.transpose(1, 2), kd, vd,  # noqa: E731
                            attn_mask=valid_pre[:, None], enable_gqa=True)
    # name: (kernel, plain version, library call or None, bound)
    calls = {
        "paged_decode": (
            lambda: paged_attention_cuda(q, k, v, pos, bt, cur, **dec),
            lambda: paged_attention_plain(q, k, v, pos, bt, cur, **dec),
            lambda: sdpa(qd, kd, vd, attn_mask=valid_dec[:, :, None],
                         enable_gqa=True),
            bound_ms(kv_bytes + nbytes(q, cur) + nbytes(q) + norms_bytes,
                     flops_dec, dname)),
        "paged_decode_int8": (
            lambda: paged_attention_int8_cuda(q, k8, v8, ks, vs, pos, bt,
                                              cur, **dec),
            lambda: paged_attention_int8_plain(q, k8, v8, ks, vs, pos, bt,
                                               cur, **dec),
            lambda: sdpa(qd, kd8, vd8, attn_mask=valid_dec[:, :, None],
                         enable_gqa=True),
            bound_ms(kv8_bytes + nbytes(q, cur) + nbytes(q) + norms_bytes,
                     flops_dec, dname)),
        "paged_prefill": (
            lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp, **pre),
            lambda: paged_prefill_plain(qf, k, v, pos, bt, qp, **pre),
            sdpa_pre,
            bound_ms(kv_bytes + 2 * nbytes(qf) + nbytes(qp) + norms_bytes,
                     flops_pre, dname)),
        "paged_prefill_per_qhead": (
            lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                       per_qhead=True),
            lambda: paged_prefill_plain(qf, k, v, pos, bt, qp,
                                        per_qhead=True),
            sdpa_pre,
            bound_ms(kv_bytes + 2 * nbytes(qf) + nbytes(qp), flops_pre,
                     dname)),
        "flash_attention": (
            lambda: flash_attention_cuda(*x),
            lambda: flash_attention_plain(*x1),
            lambda: sdpa(*(t.transpose(1, 2) for t in x), is_causal=True,
                         enable_gqa=True),
            bound_ms(2 * nbytes(x[0]) + nbytes(x[1], x[2]), flops_flash,
                     dname)),
        # the pool pass over the serving pool (every page, one score each;
        # bytes: K, V and positions read once, one f32 out per page)
        "block_score": (
            lambda: block_score_cuda(k, v, pos),
            lambda: block_score_plain(k, v, pos),
            None,
            bound_ms(nbytes(k, v, pos) + 4 * pos.shape[0], 4 * k.numel(),
                     dname)),
    }
    if not full:
        res = {name: dict(device_ms=device_timed(
                   torch, kernel, **(dict(iters=5) if name ==
                                     "flash_attention" else {})),
                   bound=bound)
               for name, (kernel, _, _, bound) in calls.items()}
        print(f"  hd {hd} (KV {KV}, G {G}, {dname}): " + "; ".join(
            f"{name} device {r['device_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ({r['bound'][1]})"
            for name, r in res.items()), flush=True)
        return res
    # the launch floor: an empty kernel of block_score's library (one
    # block, one write), timed as the kernels are
    floor_out = torch.empty(1, dtype=torch.float32, device="cuda")
    floor = device_timed(torch, lambda: launch_floor_cuda(floor_out))
    floor_clean = device_timed(torch, lambda: launch_floor_cuda(floor_out),
                               clean=True)
    print(f"  launch floor (empty kernel, one write): device {floor:.4f} ms "
          f"(after a read flush {floor_clean:.4f})", flush=True)
    res, lib_times = {}, {}
    for name, (kernel, plain, library, bound) in calls.items():
        few = dict(iters=5) if name == "flash_attention" else {}
        r = res[name] = dict(
            ms=timed(torch, kernel, **few),
            device_ms=device_timed(torch, kernel, **few),
            device_clean_ms=device_timed(torch, kernel, clean=True, **few),
            plain_ms=timed(torch, plain, **(dict(iters=3, warmup=1)
                                            if few else {})),
            bound=bound, library_ms=None, library_device_ms=None,
            floor_device_ms=floor)
        if library is not None:
            if library not in lib_times:    # K3 and K4 share theirs
                lib_times[library] = (timed(torch, library, **few),
                                      device_timed(torch, library, **few))
            r["library_ms"], r["library_device_ms"] = lib_times[library]
    res["flash_attention"].update(plain_note=f"B 1 of {B1}",
                                  flops=flops_flash)
    del x, x1, kd8, vd8
    for name in ("paged_decode", "paged_decode_int8", "block_score"):
        res[name]["route"] = "cuda_core"
    for name in ("paged_prefill", "paged_prefill_per_qhead"):
        res[name]["route"] = prefill_route(qf.dtype, k.dtype, hd)
    res["flash_attention"]["route"] = flash_route(dt, hd)
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})"
        note = f" ({r['plain_note']})" if "plain_note" in r else ""
        if "flops" in r:
            note += f" ({r['flops'] / r['device_ms'] / 1e9:.1f} TFLOP/s)"
        note += f", {r['route']} route"
        print(f"  {name}: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, after a read flush "
              f"{r['device_clean_ms']:.4f}; launch floor {floor:.4f}), plain "
              f"{r['plain_ms']:.4f} ms{note}, library {lib}, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)
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


def run_engine(torch, np, devstats, eng, prompts, new_tokens, on_step=None):
    """Serve ``prompts`` to the end, checking the devstats conservation
    identities (and ``on_step(eng)``, when given) at every step. Returns
    ({request id: tokens}, per-step devstats, wall seconds without the
    checks, per-step wall seconds of ``eng.step()``); with the lineage
    ledger on, it is reconciled after every step."""
    from repro_torch.core.paged_cache import lineage_snapshot_host
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    per_step, step_walls = [], []
    t0, t_check = time.perf_counter(), 0.0
    while True:
        c0 = time.perf_counter()
        before = pool_totals(torch, eng)
        t_check += time.perf_counter() - c0
        s0 = time.perf_counter()
        more = eng.step()
        step_walls.append(time.perf_counter() - s0)
        c0 = time.perf_counter()
        led = eng.obs.ledger
        if led is not None:
            errs = led.reconcile(lineage_snapshot_host(eng.cache.layers[0]))
            if errs:
                fail(f"lineage ledger after step {eng.stats.steps}: {errs}")
        check_conservation(np, devstats, before, pool_totals(torch, eng),
                           eng.last_stats)
        if on_step is not None:
            on_step(eng)
        per_step.append(eng.last_stats.copy())
        t_check += time.perf_counter() - c0
        if not more:
            break
    wall = time.perf_counter() - t0 - t_check
    tokens = {r.request_id: list(r.output_tokens)
              for r in eng.scheduler.finished}
    return tokens, per_step, wall, step_walls


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


def evicted_stat(policy) -> str:
    """The devstats / EngineStats name of what a policy evicts: pages under
    paged_eviction, tokens under the baselines."""
    return "pages_evicted" if policy == "paged_eviction" else "tokens_evicted"


def read_trace(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


TIMING_FIELDS = ("t_ms", "plan_ms", "step_ms")


def untimed(recs, rec):
    """The ``rec`` records of a trace without their host timing fields."""
    return [{k: v for k, v in r.items() if k not in TIMING_FIELDS}
            for r in recs if r.get("rec") == rec]


def timeline_spans(eng):
    """Per track (pid, tid) of the engine's timeline: (phase, name) in
    order."""
    out: dict = {}
    for e in eng.obs.timeline.to_chrome_trace()["traceEvents"]:
        out.setdefault((e["pid"], e.get("tid")), []).append(
            (e["ph"], e["name"]))
    return out


def engine_parity(torch, np, kv_dtype, policy="paged_eviction"):
    """The reduced config served through the kernels and through their plain
    versions (with a trace, the lineage ledger and a timeline), and, for
    paged_eviction on a float pool, through the kernels once more with
    regret probes every 2 decode steps."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.trace import validate_file
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
    probe = policy == "paged_eviction" and kv_dtype == "float32"
    out, inputs, obs_out = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for plain, every in ((False, 0), (True, 0)) + \
                (((False, 2),) if probe else ()):
            trace = os.path.join(tmp, f"{plain}-{every}.jsonl")
            eng = Engine(cfg, params, cache_cfg=CacheConfig(
                page_size=8, cache_budget=48, policy=policy, dtype=kv_dtype),
                max_batch=4,
                max_prompt_len=96, max_new_tokens=16, chunk_size=32,
                decode_splits=2, device="cuda", plain_kernels=plain,
                obs=ObsConfig(trace_path=trace, lineage=True, timeline=True,
                              regret_every=every))
            seen, undo = record_quantize()
            reset_launches()
            try:
                toks, steps, _, _ = run_engine(torch, np, devstats, eng,
                                               prompts, 16)
            finally:
                undo()
            eng.close()
            if validate_file(trace):
                fail(f"engine parity: the trace is not valid: "
                     f"{validate_file(trace)}")
            obs_out.append((read_trace(trace), read_launches(),
                            timeline_spans(eng), eng))
            if every:
                probe_toks = toks
                break
            inputs.append(seen)
            out.append((toks, steps, *pool_state(np, eng.cache.layers),
                        eng.stats))
    (tk, sk, ik, qk, stk), (tp, sp, ip, qp, stp) = out
    what = f"engine parity ({policy}, {kv_dtype})"
    (rk, lk, tlk, _), (rp, _, tlp, _) = obs_out[:2]
    for rec in ("step", "event"):
        if untimed(rk, rec) != untimed(rp, rec):
            fail(f"{what}: the two routes' trace {rec} records differ")
    if tlk != tlp:
        fail(f"{what}: the two routes' timelines differ")
    n_events = len(untimed(rk, "event"))
    if probe:
        rr, lr, _, er = obs_out[2]
        samples = [x for r in er.scheduler.finished
                   for x in r.regret_samples]
        if probe_toks != tk:
            fail(f"{what}: greedy tokens differ with regret probes on")
        if lr != lk:
            fail(f"{what}: kernel launches differ with regret probes on: "
                 f"{lr} against {lk}")
        if not samples or not all(np.isfinite(x["divergence"]).all()
                                  for x in samples):
            fail(f"{what}: regret probes missing or not finite")
        print(f"  engine {policy} {kv_dtype}: with probes every 2 decode "
              f"steps: {len(samples)} probes, tokens and launches equal "
              f"({lr})", flush=True)
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
    # the baselines' token holes may leave no intact prefix to adopt
    if not getattr(stk, evicted_stat(policy)) or \
            (policy == "paged_eviction" and not stk.shared_prefix_hits):
        fail(f"{what} exercised too little: {stk}")
    print(f"  engine {policy} {kv_dtype:8s}: {len(tk)} requests, {len(sk)} "
          f"steps: tokens, per-step devstats, pool state, trace step "
          f"records, {n_events} lineage events and timelines equal; int8 "
          f"values one step apart {flips[0]} of {flips[1]}; evicted "
          f"{stk.pages_evicted} pages, {stk.tokens_evicted} tokens, forced "
          f"{stk.forced_evictions}, {stk.shared_prefix_hits} prefix "
          f"adoptions", flush=True)


def oneshot_run(torch, params, cfg, ccfg, tokens, valid, steps, plain,
                decode_splits=1, on_step=None):
    """forward_prefill, then ``steps`` greedy decode_steps (the kernels'
    eviction ranking, fused_scores, on both). The caches get devstats
    vectors after the prefill (a wholesale reset, it emits none), so every
    decode step's events are read; ``on_step(layers)``, when given, after
    each step (its time counts). Returns (tokens (B, steps), layer caches,
    live tokens per row after prefill, per-step devstats (steps, NSTATS),
    prefill seconds, decode seconds)."""
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
        if on_step is not None:
            on_step(cache.layers)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not bool(torch.isfinite(logits).all()):
        fail("one-shot: non-finite logits")
    return (torch.stack(out, 1).cpu().numpy(), cache.layers, live,
            torch.stack(stats).cpu().numpy(), t1 - t0, t2 - t1)


def oneshot_parity(torch, np, kv_dtype, S=128, policy="paged_eviction"):
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
    ccfg = CacheConfig(page_size=8, cache_budget=32, policy=policy,
                       dtype=kv_dtype)
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
    what = f"one-shot parity ({policy}, {kv_dtype}, S {S})"
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
    name = evicted_stat(policy)
    evicted = int(sk[:, devstats.STAT_NAMES.index(name)].sum())
    unit = name.removesuffix("_evicted")
    if not evicted:
        fail(f"{what}: no {unit} evicted in decode")
    if qk:
        print(f"  one-shot int8 quantizer inputs: "
              f"{first_flip(torch, *inputs)}", flush=True)
    print(f"  one-shot {policy} {kv_dtype:8s} S {S}: {tk.shape[0]} prompts, "
          f"8 steps: tokens, per-step devstats and integer cache state "
          f"equal; int8 values one step apart {flips[0]} of {flips[1]}; "
          f"evicted {evicted} {unit}; launches {launches}", flush=True)


def serve_full_width(torch, np, kv_dtype, n_requests,
                     policy="paged_eviction", new_tokens=32, on_step=None,
                     obs=None, max_batch=8, num_layers=None):
    """Serve ``n_requests`` prompts of 1024-2048 tokens (every other one
    opening with a shared 256-token prefix) on llama-3.2-1b at full width,
    ``new_tokens`` greedy tokens each, with ``obs`` (an ObsConfig; default
    metrics only), at ``num_layers`` of its 16 layers when given. Checks that every request finished, the path's kernels
    and routes, that the policy evicted (and, under paged_eviction with
    more than 2 requests, shared prefixes) and F1-F4 at the end. Returns
    (launches, engine, wall seconds, per-step wall seconds of
    ``eng.step()``)."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = get_arch("llama-3.2-1b")
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    eng = Engine(cfg, params, cache_cfg=CacheConfig(
        page_size=16, cache_budget=512, policy=policy,
        dtype=kv_dtype), max_batch=max_batch, max_prompt_len=2048,
        max_new_tokens=new_tokens, chunk_size=256, decode_splits=4,
        device="cuda", obs=obs)
    torch.cuda.synchronize()
    print(f"  model + caches ready in {time.perf_counter() - t0:.1f} s; "
          f"pool payload {eng.pool_bytes()['payload_total'] / 2 ** 20:.1f} "
          f"MiB over {cfg.num_layers} layers ({kv_dtype}, {policy}, "
          f"{eng.cache.layers[0].num_pages} slots per row)", flush=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 256)
    prompts = []
    for i in range(n_requests):
        n = int(rng.integers(1024, 2049))
        head = shared if i % 2 == 0 else rng.integers(0, cfg.vocab_size, 256)
        prompts.append(np.concatenate(
            [head, rng.integers(0, cfg.vocab_size, n - 256)]).astype(np.int32))
    reset_launches()
    tokens, _, wall, step_walls = run_engine(torch, np, devstats, eng,
                                             prompts, new_tokens, on_step)
    launches = read_launches()
    s = eng.stats
    print(f"  {len(tokens)} requests, {s.tokens_generated} tokens, "
          f"{s.steps} steps ({s.steps - s.decode_steps} mixed, "
          f"{s.decode_steps} decode-only) in {wall:.2f} s: "
          f"{s.tokens_generated / wall:.1f} tok/s; mean step "
          f"{1e3 * s.prefill_s / max(s.steps - s.decode_steps, 1):.2f} ms "
          f"mixed, {1e3 * s.decode_s / max(s.decode_steps, 1):.2f} ms "
          f"decode-only; launches {launches}", flush=True)
    print(f"  pages evicted {s.pages_evicted}, tokens evicted "
          f"{s.tokens_evicted}, forced {s.forced_evictions}, prefix "
          f"adoptions {s.shared_prefix_hits} ({s.shared_prefix_tokens} "
          f"prompt tokens skipped); pool {eng.pool_stats()}", flush=True)
    if len(tokens) != n_requests or any(len(t) != new_tokens
                                        for t in tokens.values()):
        fail(f"not every request finished with {new_tokens} tokens: "
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
    sharing = policy == "paged_eviction" and n_requests > 2
    if not getattr(s, evicted_stat(policy)) or \
            (sharing and not s.shared_prefix_hits):
        fail(f"{policy}: no eviction or no prefix sharing at full width: "
             f"{s}")
    check_invariants(np, eng.cache.layers)
    return launches, eng, wall, step_walls


def oneshot_prompts(torch, np, vocab):
    """Phase 5's prompts: 4 right-padded prompts of 4096, 4000, 3096 and
    2047 tokens. Returns (tokens (B1, S1) int32, valid (B1, S1) bool)."""
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, vocab, (B1, S1))
                              .astype(np.int32)).cuda()
    lens = torch.tensor([S1, S1 - 96, S1 - 1000, S1 - 2049], device="cuda")
    return tokens, torch.arange(S1, device="cuda")[None, :] < lens[:, None]


def oneshot_full_width(torch, np):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    cfg = get_arch("llama-3.2-1b")
    params = init_model(cfg, seed=0, device="cuda")
    tokens, valid = oneshot_prompts(torch, np, cfg.vocab_size)
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


BASELINES = ("streaming_llm", "inverse_key_l2", "keydiff")


def fragmentation(torch, layers):
    """(mapped pages, live tokens) over every layer and row: live tokens per
    mapped page is the paper's fragmentation (its Limitation 1)."""
    t = torch.stack([torch.stack([(c.block_table >= 0).sum(),
                                  c.total_valid().sum()]) for c in layers])
    mapped, live = (int(x) for x in t.sum(0).cpu())
    return mapped, live


def baseline_checks(torch, devstats, policy, limit, n_sinks, seen,
                    prefix=0):
    """A per-step check of a layer list, to what the JAX package's policies
    guarantee. Live tokens per row <= ``limit`` (budget + page); a row that
    has held a page another row maps may hold up to ``prefix`` (the shared
    prefix's tokens) more: token eviction copies a shared page before it
    writes, one page per row per call, so the rows that share a prefix shed
    it over several calls. Under streaming_llm, positions 0 .. n_sinks - 1
    resident in every layer of every row whose newest position is past
    them, unless that layer has forced a rollover (its victim, the page
    with the fewest tokens, can be the sinks' page). ``seen`` collects the largest excess
    over ``limit``, forced evictions per layer and the (layer, row) pairs
    without their sinks."""
    want = torch.arange(n_sinks, device="cuda", dtype=torch.int32)

    def check(layers):
        live = torch.stack([c.total_valid() for c in layers])    # (L, B)
        shares = torch.stack([(c.mapped_mask() &
                               (c.ref_count[c._phys()] > 1)).any(-1)
                              for c in layers])
        seen["shared"] = shares | seen.get("shared", shares)
        over = int((live - limit - prefix * seen["shared"]).max())
        if over > 0:
            fail(f"{policy}: a row holds {over} live tokens beyond budget + "
                 f"page (+ {prefix} if it has shared a prefix)")
        seen["excess"] = max(seen.get("excess", 0), int((live - limit).max()))
        forced = seen.setdefault("forced", [0] * len(layers))
        for i, c in enumerate(layers):
            forced[i] += int(c.stats[devstats.FORCED_EVICTIONS])
        if policy != "streaming_llm":
            return
        lost = []
        for i, c in enumerate(layers):
            pv = c.pos_view().reshape(c.batch, -1)
            has = (pv[:, :, None] == want).any(1).all(1)
            due = pv.amax(1) >= n_sinks - 1          # past the sinks
            rows = (due & ~has).nonzero().flatten().tolist()
            if rows and not forced[i]:
                fail(f"streaming_llm: rows {rows} lost a sink in layer {i}, "
                     f"which forced no rollover")
            lost += [(i, b) for b in rows]
        seen["sinks_lost"] = max(seen.get("sinks_lost", 0), len(lost))
    return check


BASELINE_LAYERS = 8     # of llama-3.2-1b's 16: depth cut for run time


def baselines_full_width(torch, np):
    """The paper's baselines on llama-3.2-1b at full width, cut to
    BASELINE_LAYERS layers: for each, 4 requests served (bf16 pool, page
    16, budget 512, max batch 8, chunk 256, decode splits 4; half share a
    256-token prefix; 16 greedy tokens), then phase 5's prompts one-shot
    (compressed to 512 tokens, 16 greedy decode_steps), each checked by
    :func:`baseline_checks` at every step."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_arch("llama-3.2-1b"),
                              num_layers=BASELINE_LAYERS)
    budget, page, steps = 512, 16, 16
    params = init_model(cfg, seed=0, device="cuda")
    tokens, valid = oneshot_prompts(torch, np, cfg.vocab_size)
    for policy in BASELINES:
        t0 = time.perf_counter()
        ccfg = CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                           dtype="bfloat16")
        seen, seen1 = {}, {}
        check = baseline_checks(torch, devstats, policy, budget + page,
                                ccfg.num_sink_tokens, seen, prefix=256)
        check1 = baseline_checks(torch, devstats, policy, budget + page,
                                 ccfg.num_sink_tokens, seen1)
        print(f"  {policy}: serving", flush=True)
        _, eng, wall, _ = serve_full_width(
            torch, np, "bfloat16", 4, policy=policy, new_tokens=steps,
            on_step=lambda e: check(e.cache.layers),
            num_layers=BASELINE_LAYERS)
        s = eng.stats
        frag = fragmentation(torch, eng.cache.layers)
        del eng
        torch.cuda.empty_cache()
        reset_launches()
        _, layers, live, st, t_pre, t_dec = oneshot_run(
            torch, params, cfg, ccfg, tokens, valid, steps, plain=False,
            decode_splits=4, on_step=check1)
        torch.cuda.synchronize()
        one = read_launches()
        if bool(seen1["shared"].any()) or seen1["excess"] > 0 or \
                seen1.get("sinks_lost", 0):
            fail(f"{policy} one-shot: {seen1}: nothing is shared there, so "
                 f"no row may exceed budget + page or lose a sink")
        if int(live.max()) > budget + page:
            fail(f"{policy} one-shot: {int(live.max())} live tokens after "
                 f"prefill")
        if one["flash_attention/tensor_core"] != cfg.num_layers or \
                one["flash_attention"] != cfg.num_layers or \
                not one["paged_decode"]:
            fail(f"{policy} one-shot: the prefill did not run all "
                 f"{cfg.num_layers} flash launches on the tensor cores, or "
                 f"decode did not run its kernel: {one}")
        evicted = int(st[:, devstats.TOKENS_EVICTED].sum())
        if not evicted:
            fail(f"{policy} one-shot: no token evicted in decode")
        check_invariants(np, layers)
        frag1 = fragmentation(torch, layers)
        del layers
        torch.cuda.empty_cache()
        mixed = s.steps - s.decode_steps
        print(f"  {policy}: serving {s.tokens_generated / wall:.1f} tok/s, "
              f"mean step {1e3 * s.prefill_s / max(mixed, 1):.2f} ms mixed, "
              f"{1e3 * s.decode_s / max(s.decode_steps, 1):.2f} ms "
              f"decode-only; {frag[0]} mapped pages hold {frag[1]} live "
              f"tokens ({frag[1] / max(frag[0], 1):.2f} of {page} per page); "
              f"forced {s.forced_evictions}, prefix adoptions "
              f"{s.shared_prefix_hits}, tokens evicted {s.tokens_evicted}; "
              f"most live tokens beyond budget + page in a row "
              f"{seen['excess']} ({int(seen['shared'].any(0).sum())} rows "
              f"shared pages); (layer, row) pairs without their sinks "
              f"{seen.get('sinks_lost', 0)}", flush=True)
        print(f"  {policy}: one-shot prefill {1e3 * t_pre:.1f} ms, mean "
              f"decode step {1e3 * t_dec / steps:.2f} ms; {frag1[0]} mapped "
              f"pages hold {frag1[1]} live tokens "
              f"({frag1[1] / max(frag1[0], 1):.2f} per page); {evicted} "
              f"tokens evicted in decode; launches {one}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def serve_observed(torch, np, n_requests=16):
    """Phase 4: :func:`serve_full_width` (bf16 pool) with metrics, a trace,
    a timeline and the lineage ledger (reconciled after every step by
    :func:`run_engine`), then the observability checks. Returns the
    launches."""
    from repro_torch.core import devstats
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.timeline import validate_chrome_trace
    from repro_torch.obs.trace import validate_file
    hooks = []
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.jsonl")
        launches, eng, _, walls = serve_full_width(
            torch, np, "bfloat16", n_requests,
            obs=ObsConfig(trace_path=trace, timeline=True, lineage=True),
            on_step=lambda e: hooks.append(e.last_hook_s))
        eng.close()
        errs = validate_file(trace)
        if errs:
            fail(f"phase 4 trace: {errs}")
        recs = read_trace(trace)
        tl = os.path.join(tmp, "timeline.json")
        n_tl = eng.export_timeline(tl)
        with open(tl) as f:
            doc = json.load(f)
    s = eng.stats
    steps = [r for r in recs if r["rec"] == "step" and r["kind"] != "idle"]
    if len(steps) != s.steps:
        fail(f"phase 4 trace: {len(steps)} step records for {s.steps} steps")
    sums = {n: sum(r[n] for r in steps) for n in devstats.STAT_NAMES}
    for n in ("pages_evicted", "tokens_evicted", "forced_evictions"):
        if sums[n] != getattr(s, n):
            fail(f"phase 4 trace: {n} sums to {sums[n]}, EngineStats says "
                 f"{getattr(s, n)}")
    counts = eng.obs.ledger.counts()
    for etype, stat in (("evict", "pages_evicted"), ("adopt", "pages_adopted"),
                        ("fork", "pages_forked")):
        if counts.get(etype, 0) > sums[stat]:
            fail(f"phase 4 lineage: {counts.get(etype, 0)} {etype} events "
                 f"above devstats' {sums[stat]} {stat}")
    if validate_chrome_trace(doc):
        fail(f"phase 4 timeline: {validate_chrome_trace(doc)}")
    tracks = {e["tid"] for e in doc["traceEvents"]
              if e["pid"] == 2 and e["ph"] == "X"}
    if len(tracks) != n_requests:
        fail(f"phase 4 timeline: {len(tracks)} request tracks for "
             f"{n_requests} requests")
    snap = eng.metrics_snapshot()
    later = s.tokens_generated - n_requests
    if snap["engine.ttft_s"]["count"] != n_requests or \
            snap["engine.itl_s"]["count"] != later:
        fail(f"phase 4 metrics: ttft {snap['engine.ttft_s']['count']} "
             f"(want {n_requests}), itl {snap['engine.itl_s']['count']} "
             f"(want {later})")
    hook_ms = 1e3 * float(np.median(hooks))
    share = float(np.median(np.array(hooks) / np.array(walls)))
    print(f"  obs: trace {len(recs)} records ({len(steps)} steps, "
          f"{sum(r['rec'] == 'event' for r in recs)} lineage events "
          f"{counts}), ledger reconciled after every step, timeline "
          f"{n_tl} events over {len(tracks)} request tracks; ttft count "
          f"{n_requests}, itl count {later}; obs hooks' host time per step: "
          f"median {hook_ms:.3f} ms, {100 * share:.2f}% of the step "
          f"(max {1e3 * max(hooks):.3f} ms); ttft p50 "
          f"{snap['engine.ttft_s']['p50']:.3f} s, itl p50 "
          f"{snap['engine.itl_s']['p50']:.4f} s, step p50 "
          f"{snap['engine.step_wall_s']['p50']:.4f} s", flush=True)
    return launches


def regret_full_width(torch, np):
    """Phase 8: eviction-regret shadow probes at full width: 2 of phase 4's
    requests (max batch 2), 16 greedy tokens, probes every 4 decode
    steps, paged_eviction at budget 512."""
    from repro_torch.obs import ObsConfig
    taps = []
    _, eng, wall, _ = serve_full_width(
        torch, np, "bfloat16", 2, new_tokens=16, max_batch=2,
        obs=ObsConfig(regret_every=4),
        on_step=lambda e: taps.append((e.stats.decode_steps,
                                       e.last_tap_bytes)))
    samples = [x for r in eng.scheduler.finished for x in r.regret_samples]
    if not samples:
        fail("phase 8: no regret probe ran")
    div = np.array([d for x in samples for d in x["divergence"]])
    mass = np.array([m for x in samples for m in x["evicted_mass"]])
    if not np.isfinite(div).all():
        fail("phase 8: a probe's divergence is not finite")
    if not ((mass >= 0) & (mass <= 1)).all() or not (mass > 0).any():
        fail(f"phase 8: evicted attention mass {mass.min()}..{mass.max()}: "
             f"not in [0, 1] or never above 0")
    dec = [b for (n, b), (n0, _) in zip(taps[1:], taps) if n > n0]
    mixed = [b for (n, b), (n0, _) in zip(taps[1:], taps) if n == n0]
    summ = {r.request_id: r.regret_summary()
            for r in eng.scheduler.finished}
    print(f"  {len(samples)} probes over {eng.stats.steps} steps in "
          f"{wall:.1f} s: divergence {div.min():.4g}..{div.max():.4g} "
          f"(mean {div.mean():.4g}), evicted mass {mass.min():.4g}.."
          f"{mass.max():.4g} (mean {mass.mean():.4g}); shadow cache "
          f"{eng.shadow_nbytes()} bytes; taps read per step: mixed "
          f"{max(mixed, default=0)} bytes, decode-only "
          f"{max(dec, default=0)} bytes; per request {summ}", flush=True)


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
    print(f"[1/8] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry func")):
                print(f"  {name}: {line.strip()}", flush=True)

    def phase(title):
        print(f"{title} (at {time.perf_counter() - t_start:.0f} s)",
              flush=True)

    phase("[2/8] kernels against their plain versions")
    reset_launches()
    worst = check_kernels(torch)
    checked = read_launches()
    timing = time_kernels(torch, F)
    other_hd = {shape[2]: time_kernels(torch, F, shape, dname, full=False)
                for shape, dname in NEW_HD_SHAPES.values()}

    phase("[3/8] kernels vs plain versions: engine (with trace, lineage and "
          "timeline; probes on and off) and one-shot, float and int8 pools, "
          "every policy that evicts")
    for policy in ("paged_eviction",) + BASELINES:
        for kv_dtype in ("float32", "int8"):
            engine_parity(torch, np, kv_dtype, policy)
        for kv_dtype in ("float32", "int8"):
            oneshot_parity(torch, np, kv_dtype, policy=policy)
    # a ragged prompt above 2048 tokens: the flash kernel on the card
    oneshot_parity(torch, np, "float32", S=3000)

    phase("[4/8] llama-3.2-1b at full width: serving, bf16 pool, with "
          "metrics, trace, timeline and lineage ledger")
    serve = serve_observed(torch, np)
    torch.cuda.empty_cache()

    phase("[5/8] llama-3.2-1b at full width: one-shot, bf16 and int8 pools")
    oneshot = oneshot_full_width(torch, np)
    torch.cuda.empty_cache()

    phase("[6/8] llama-3.2-1b at full width: serving, int8 pool")
    serve8 = serve_full_width(torch, np, "int8", 4)[0]
    torch.cuda.empty_cache()

    phase("[7/8] llama-3.2-1b at full width: the paper's baselines")
    baselines_full_width(torch, np)
    torch.cuda.empty_cache()

    phase("[8/8] llama-3.2-1b at full width: eviction-regret probes")
    regret_full_width(torch, np)

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
                     "device_ms": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"],
                     "library_device_ms": r["library_device_ms"],
                     "device_clean_ms": r["device_clean_ms"],
                     "floor_device_ms": r["floor_device_ms"],
                     "timed_route": r["route"],
                     "head_dims": sorted(HEAD_DIMS_CHECKED[name]),
                     "other_head_dims": {
                         hd: {"device_ms": t[name]["device_ms"],
                              "bound_ms": t[name]["bound"][0],
                              "bound_by": t[name]["bound"][1]}
                         for hd, t in other_hd.items()}})
    print(f"done in {time.perf_counter() - t_start:.0f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
