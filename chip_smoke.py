#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):
  1. build    the CUDA kernels under src/repro_torch/csrc, one nvcc each, in
              parallel, into src/repro_torch/_build
  2. kernels  each kernel against its plain torch version on churned pools
              (freed and reallocated pages, unmapped slots, shared prefix
              pages, padding rows, window 0 and > 0) at the shapes of
              llama-3.2-1b, -3b and 3.1-8b in f32 and bf16; then its time at
              the main path's shapes beside its bound, the plain version's
              time and one PyTorch call's (scaled_dot_product_attention on
              the gathered view, a yardstick only)
  3. engine   a reduced f32 config (KV 2, G 2) served twice on the card,
              through the kernels and through their plain versions: greedy
              tokens, per-step devstats and final integer pool state equal
  4. serve    llama-3.2-1b at full width (bf16, random weights from a seed):
              16 requests of 1024-2048 prompt tokens (half share a 256-token
              prefix), 32 greedy tokens each, under paged_eviction (page 16,
              budget 512, max batch 8, chunk 256, decode splits 4). Checks
              every request's token count, that both kernels ran, that pages
              were evicted and prefixes shared, the pool invariants F1-F4 and
              the devstats conservation identities at every step.

Prints the card's name and power limit, one JSON line describing every
kernel, and as the last line {"ok": true, "device": {...}}. Exits non-zero
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
# |kernel - plain| <= atol + rtol * |plain|, elementwise. Both compute in
# f32; a bf16 output differs from the plain one only where the two f32
# values round to neighbouring bf16 numbers: one step, at most 2**-7 of
# the value.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2 ** -7)}
NORM_RTOL = 1e-3
KERNELS = {
    "paged_decode": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:249"),
    "paged_prefill": dict(
        source="src/repro_torch/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:240"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def _err(got, want, dname):
    """(max abs error, its largest share of the elementwise tolerance)."""
    atol, rtol = TOL[dname]
    d = (got.float() - want.float()).abs()
    share = d / (atol + rtol * want.float().abs())
    return float(d.max()), float(share.max())


def _norm_err(got, want):
    return max(float(((g - w).abs() / w.abs().clamp_min(1e-6)).max())
               for g, w in zip(got, want))


def check_kernels(torch):
    from repro_torch.kernels.flash_prefill import (paged_prefill_cuda,
                                                   paged_prefill_plain)
    from repro_torch.kernels.paged_attention import (combine_splits,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.kernels.ref import churned_pool, prefill_positions
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}
    seed = 0
    for arch, (KV, G, hd, page) in SHAPES.items():
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            seed += 1
            k, v, pos, bt, cur = (t.cuda() for t in churned_pool(
                B, P, page, KV, hd, dt, seed))
            g = torch.Generator().manual_seed(seed)
            for window in (0, 8 * page):
                q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
                for splits in (1, 4):
                    kw = dict(window=window, num_splits=splits,
                              return_scores=True)
                    a, m, l, nk = paged_attention_cuda(q, k, v, pos, bt, cur,
                                                       **kw)
                    a2, m2, l2, nk2 = paged_attention_plain(q, k, v, pos, bt,
                                                            cur, **kw)
                    torch.cuda.synchronize()
                    err, share = _err(combine_splits(a, m, l).to(dt),
                                      combine_splits(a2, m2, l2).to(dt),
                                      dname)
                    nerr = _norm_err(nk, nk2)
                    print(f"  paged_decode  {arch:13s} {dname:8s} window "
                          f"{window:3d} splits {splits}: max abs err "
                          f"{err:.3g}, {share:.3g} of the tolerance (atol, "
                          f"rtol) {TOL[dname]}; norm rel err {nerr:.3g} "
                          f"(tol {NORM_RTOL})", flush=True)
                    if not share <= 1 or not nerr <= NORM_RTOL:
                        fail(f"paged_decode disagrees on {arch} {dname}")
                    worst["paged_decode"] = max(worst["paged_decode"], err)
                qp = prefill_positions(cur.cpu(), T).cuda()
                qf = torch.randn((B, T, KV * G, hd), generator=g).to(dt).cuda()
                kw = dict(window=window, return_scores=True)
                o, nk = paged_prefill_cuda(qf, k, v, pos, bt, qp, **kw)
                o2, nk2 = paged_prefill_plain(qf, k, v, pos, bt, qp, **kw)
                torch.cuda.synchronize()
                (err, share), nerr = _err(o, o2, dname), _norm_err(nk, nk2)
                pad = float(o[B - 1].float().abs().max())
                print(f"  paged_prefill {arch:13s} {dname:8s} window "
                      f"{window:3d}: max abs err {err:.3g}, {share:.3g} of "
                      f"the tolerance (atol, rtol) {TOL[dname]}; norm rel "
                      f"err {nerr:.3g}, padding rows max |out| {pad}",
                      flush=True)
                if not share <= 1 or not nerr <= NORM_RTOL or pad:
                    fail(f"paged_prefill disagrees on {arch} {dname}")
                worst["paged_prefill"] = max(worst["paged_prefill"], err)
    return worst


def time_kernels(torch, F):
    """Times at the main path's shapes (llama-3.2-1b, bf16, decode splits
    4, chunk 256) with each kernel's bound and the yardsticks."""
    from repro_torch.kernels.flash_prefill import (paged_prefill_cuda,
                                                   paged_prefill_plain)
    from repro_torch.kernels.paged_attention import (combine_splits,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.kernels.ref import (churned_pool, gather_block_table,
                                         prefill_positions)
    KV, G, hd, page = SHAPES["llama-3.2-1b"]
    dt, dname = torch.bfloat16, "bfloat16"
    k, v, pos, bt, cur = (t.cuda() for t in churned_pool(
        B, P, page, KV, hd, dt, 100))
    g = torch.Generator().manual_seed(100)
    q = torch.randn((B, KV, G, hd), generator=g).to(dt).cuda()
    qf = torch.randn((B, T, KV * G, hd), generator=g).to(dt).cuda()
    qp = prefill_positions(cur.cpu(), T).cuda()
    dec = dict(num_splits=4, return_scores=True)
    pre = dict(return_scores=True)
    res = {}

    # bytes: the K/V of every distinct page the block tables reach (the
    # epilogue needs all of them), their positions, the tables, q, the
    # outputs; operations: 4 * hd per valid (query, key) pair
    kg, vg, pg = gather_block_table(k, v, pos, bt)
    phys = torch.unique(bt.clamp_min(0))
    kv_bytes = 2 * phys.numel() * page * KV * hd * k.element_size() + \
        phys.numel() * page * 4 + nbytes(bt)
    norms_bytes = 2 * B * KV * P * page * 4
    S = P * page
    kpos = pg.reshape(B, 1, S)
    valid_dec = (kpos >= 0) & (kpos <= cur[:, None, None])
    flops = 4 * hd * KV * G * int(valid_dec.sum())
    res["paged_decode"] = dict(
        ms=timed(torch, lambda: paged_attention_cuda(q, k, v, pos, bt, cur,
                                                     **dec)),
        plain_ms=timed(torch, lambda: paged_attention_plain(q, k, v, pos, bt,
                                                            cur, **dec)),
        bound=bound_ms(kv_bytes + nbytes(q, cur) + nbytes(q) + norms_bytes,
                       flops, dname))
    qpe = qp[:, :, None]
    valid_pre = (kpos >= 0) & (qpe >= 0) & (kpos <= qpe)       # (B, T, S)
    flops = 4 * hd * KV * G * int(valid_pre.sum())
    res["paged_prefill"] = dict(
        ms=timed(torch, lambda: paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                                   **pre)),
        plain_ms=timed(torch, lambda: paged_prefill_plain(qf, k, v, pos, bt,
                                                          qp, **pre)),
        bound=bound_ms(kv_bytes + 2 * nbytes(qf) + nbytes(qp) + norms_bytes,
                       flops, dname))
    # yardstick: one SDPA call on the gathered (B, KV, P * page, hd) view
    kd = kg.reshape(B, KV, S, hd)
    vd = vg.reshape(B, KV, S, hd)
    qd = q.reshape(B, KV * G, 1, hd)
    md = valid_dec[:, :, None, :]
    res["paged_decode"]["library_ms"] = timed(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=md, enable_gqa=True))
    qpf = qf.transpose(1, 2)
    mp = valid_pre[:, None]
    res["paged_prefill"]["library_ms"] = timed(torch, lambda: F.scaled_dot_product_attention(
        qpf, kd, vd, attn_mask=mp, enable_gqa=True))
    for name, r in res.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, sdpa {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} "
              f"ms ({r['bound'][1]})", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 3 / 4: the engine
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


def check_invariants(np, eng):
    for i, c in enumerate(eng.cache.layers):
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


def engine_parity(torch, np):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(get_arch("llama-3.2-1b").reduced(),
                              num_heads=4, num_kv_heads=2)
    params = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([shared if i % 2 else
                               rng.integers(0, cfg.vocab_size, 32),
                               rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(8, 64)))])
               .astype(np.int32) for i in range(8)]
    out = []
    for plain in (False, True):
        eng = Engine(cfg, params, cache_cfg=CacheConfig(
            page_size=8, cache_budget=48, dtype="float32"), max_batch=4,
            max_prompt_len=96, max_new_tokens=16, chunk_size=32,
            decode_splits=2, device="cuda", plain_kernels=plain)
        toks, steps, _ = run_engine(torch, np, devstats, eng, prompts, 16)
        ints = [np.concatenate([c.block_table.cpu().numpy().ravel(),
                                c.ref_count.cpu().numpy(),
                                c.pos.cpu().numpy().ravel(),
                                c.cur_page.cpu().numpy(),
                                c.cur_off.cpu().numpy()])
                for c in eng.cache.layers]
        out.append((toks, steps, ints, eng.stats))
    (tk, sk, ik, stk), (tp, sp, ip, stp) = out
    if tk != tp:
        fail("engine parity: greedy tokens differ between kernels and "
             "plain versions")
    if len(sk) != len(sp) or any(not np.array_equal(a, b)
                                 for a, b in zip(sk, sp)):
        fail("engine parity: per-step devstats differ")
    if any(not np.array_equal(a, b) for a, b in zip(ik, ip)):
        fail("engine parity: final integer pool state differs")
    if not stk.pages_evicted or not stk.shared_prefix_hits:
        fail(f"engine parity run exercised too little: {stk}")
    print(f"  {len(tk)} requests, {len(sk)} steps: tokens, per-step devstats "
          f"and pool state equal; evicted {stk.pages_evicted} pages, "
          f"{stk.shared_prefix_hits} prefix adoptions", flush=True)


def serve_full_width(torch, np):
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.kernels.flash_prefill import paged_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = get_arch("llama-3.2-1b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    eng = Engine(cfg, params, cache_cfg=CacheConfig(
        page_size=16, cache_budget=512, policy="paged_eviction",
        dtype="bfloat16"), max_batch=8, max_prompt_len=2048,
        max_new_tokens=32, chunk_size=256, decode_splits=4, device="cuda")
    torch.cuda.synchronize()
    print(f"  model + caches ready in {time.perf_counter() - t0:.1f} s; "
          f"pool payload {eng.pool_bytes()['payload_total'] / 2 ** 20:.1f} "
          f"MiB over {cfg.num_layers} layers", flush=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 256)
    prompts = []
    for i in range(16):
        n = int(rng.integers(1024, 2049))
        head = shared if i % 2 == 0 else rng.integers(0, cfg.vocab_size, 256)
        prompts.append(np.concatenate(
            [head, rng.integers(0, cfg.vocab_size, n - 256)]).astype(np.int32))
    paged_attention_cuda.launches = 0
    paged_prefill_cuda.launches = 0
    tokens, _, wall = run_engine(torch, np, devstats, eng, prompts, 32)
    launches = {"paged_decode": paged_attention_cuda.launches,
                "paged_prefill": paged_prefill_cuda.launches}
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
    if len(tokens) != 16 or any(len(t) != 32 for t in tokens.values()):
        fail(f"not every request finished with 32 tokens: "
             f"{ {k: len(t) for k, t in tokens.items()} }")
    if any(not 0 <= x < cfg.vocab_size for t in tokens.values() for x in t):
        fail("a sampled token is outside the vocabulary")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if not s.pages_evicted or not s.shared_prefix_hits:
        fail(f"no eviction or no prefix sharing at full width: {s}")
    check_invariants(np, eng)
    return launches, wall, s


def main() -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[1/4] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print("[2/4] kernels against their plain versions", flush=True)
    worst = check_kernels(torch)
    timing = time_kernels(torch, F)

    print("[3/4] engine through the kernels vs their plain versions",
          flush=True)
    engine_parity(torch, np)

    print("[4/4] llama-3.2-1b at full width", flush=True)
    launches, _, _ = serve_full_width(torch, np)

    rows = []
    for name, meta in KERNELS.items():
        r = timing[name]
        rows.append({"name": name, "route": "cuda", **meta,
                     "launches": launches[name],
                     "max_abs_err": worst[name], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
