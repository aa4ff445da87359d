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
              decode kernel over a pool of the query's dtype or int8); and
              K1, K3 (K4 bit for bit) and K5 at the heads of the families
              of phase 10 that the kernels had not met: chameleon-34b's G 8
              (G * T = 2048 prefill rows), mixtral-8x22b's G 6 and
              gemma3-27b's 32 / 16 heads at its window 1024 (on its local
              slab of 65 pages), bf16 pools, windows 0 and > 0, and
              musicgen-medium's 24 / 24 heads (G 1, hd 64; it has no
              window), window 0. f32
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
              head dims, at their models' dtypes (TINY f32, the others bf16),
              and at the four family shapes (bf16, window 0)
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
              and the same kernel launches. Then the reduced f32 gemma3-27b
              (3 local layers of window 64, 1 global) and mixtral-8x7b (swa
              64, MoE) the same way, engine (prompts of 96-160 tokens) and
              one-shot, gemma3 at budget 128 (above the window) and mixtral
              at 48 (below it), and 2 AdamW steps of each on the card
              against the CPU (B 1 x
              S 1024; losses and aux losses within 1e-4 relative). Then the
              recurrent families the same way: the reduced f32 jamba
              (attention, then 3 mamba layers; budget 48) and xlstm (3
              mLSTM, 1 sLSTM; no attention layer, so no kernel and no
              lineage ledger): no prefix adoption (sharing is off for
              them), and each run's recurrent states within 1e-3 of their
              magnitude of the other's (printed). Then the reduced f32
              musicgen (cross-attention, 4 codebooks), which the engine
              refuses: forward_step with cross caches from
              make_cross_cache over mixed and decode-only steps (greedy
              tokens per codebook, devstats, pool state equal, logits
              within 1e-4), one-shot and 2 AdamW steps, the same way
  4. serve    llama-3.2-1b at full width (bf16, random weights from a seed;
              1 of its 16 layers, a depth cut for the run time):
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
  5. one-shot llama-3.2-1b at full width (4 of its 16 layers, a depth cut
              for the run time), the paper's own experiment: 4
              prompts of up to 4096 tokens prefilled through the flash
              kernel (all 4 launches on the tensor-core route), compressed
              to budget 512 by Alg. 2, then 32 greedy tokens under Alg. 3,
              once on a bf16 and once on an int8 pool
  6. int8     phase 4's workload (4 requests) served on an int8 pool at 1
              of the 16 layers (full width; depth cut for the run time;
              every prefill launch on the CUDA-core route: a bf16 query
              over the dequantized f32 pool)
  7. baselines the paper's comparison: streaming_llm, inverse_key_l2 and
              keydiff each serve 4 of phase 4's requests (16 greedy tokens)
              and run phase 5's prompts one-shot (bf16, 16 decode steps),
              at 1 of the model's 16 layers (full width; depth cut for the
              run time).
              Checks after every step the budget (budget + page, plus the
              shared prefix for rows that share one: copy-on-write sheds it
              one page per call), StreamingLLM's sinks (unless the layer
              forced a rollover), that tokens were evicted, F1-F4 and the
              kernels' routes; prints tok/s, step times, live tokens per
              mapped page, forced evictions and prefix adoptions.
  8. regret   eviction-regret shadow probes at full width, 2 of the 16
              layers: 2 of phase 4's requests, 16 greedy tokens, probes
              every 4 decode steps, under paged_eviction at budget 512;
              every probe's divergence finite, its evicted attention mass
              in [0, 1] and above 0 in one probe at least; prints the
              shadow cache's bytes and the taps read per step.
  9. train    9a: a reduced f32 llama-3.2-1b from one init on the card and
              its copy on the CPU, 4 AdamW steps of lm_batch at B 1 x S 3072
              (the blocked attention route; TF32 off, PyTorch's default for
              matmuls): losses within 1e-4 relative at every step, step-1
              gradients within atol 1e-5 + rtol 1e-4 leaf by leaf, every
              layer's wq/wk/wv gradient nonzero, no kernel launched; a
              params + AdamW-state checkpoint restored bit for bit.
              9b: llama-3.2-1b at full width (bf16, random weights from a
              seed; 2 of its 16 layers, a depth cut for the run time)
              trains 6 steps at B 2 x S 4096 (warmup 2): losses
              finite and falling, every layer's attention weights with a
              gradient at step 1, no kernel launched; prints the median
              step time of steps 2-6, tokens/s, peak memory and the model
              FLOP/s (6 N T + 12 L B H hd S^2) as a share of 989 TFLOP/s;
              its params checkpoint is restored bit for bit and serves 2
              requests of 1024 prompt tokens (8 greedy tokens, max batch
              2, paged_eviction at budget 512): K1 and K3 (tensor cores)
              launch, pages are evicted, F1-F4 hold, nothing requires grad.
              9c: TINY (benchmarks/accuracy.py) trained 900 steps on the
              recall task by accuracy.py's recipe, then scored on 6
              held-out batches by forward_prefill and 2 decode_steps (K5 on
              the f32 CUDA-core route, K1): full at budget 32 must answer
              >= 0.60; paged_eviction and streaming_llm at budgets 16 and 8
              are printed. Prints phase 9's seconds.
 10. families stablelm-3b (4 of 32 layers), gemma3-27b (6 of 62: one period
              of 5 local layers and 1 global), chameleon-34b (2 of 48) and
              mixtral-8x7b (2 of 32) at full width (bf16, random weights
              from a seed; depth cut for the run time): each serves 4
              requests of 1024-3072 prompt tokens (2 share a 256-token
              prefix), 16 greedy tokens, page 16, max batch 4, chunk 256
              (4 chunks a step: the prompts prefill side by side), decode
              splits 4, paged_eviction at budget 512 (gemma3 2048,
              above its local window), then runs phase 5's prompts one-shot
              (16 decode steps). Checks every request's token count, K1 and
              K3 (tensor cores) served and K5 (tensor cores, every layer)
              and K1 one-shot, pages evicted, F1-F4 and the devstats
              identities at every step, and after each chunk evict no live
              token at or below newest - window on an unshared page of a
              windowed layer (a shared page keeps them until its lazy
              copy-on-write fork, as in the JAX package); prints forced
              rollovers and live tokens by layer kind, and mixtral's MoE
              share of the mixed steps (host-clocked).
 11. recurrent jamba-1.5-large (4 of 72 layers: attention + dense MLP, mamba
              + MoE, mamba + dense, mamba + MoE; 23.02 B parameters) and
              xlstm-1.3b (8 of 48: 7 mLSTM, 1 sLSTM) at full width (bf16,
              random weights from a seed; depth cut for the card's memory
              and the run time): each serves phase 10's 4 requests (page
              16, max batch 4, 4 chunks of 256 a step, decode splits 4,
              paged_eviction at budget 512, 16 greedy tokens), then 4
              prompts of 2048 tokens one-shot (16 decode steps). Checks
              every request's token count, no prefix adoption, every
              recurrent state finite after every step; jamba: K1 and K3
              (tensor cores) served, K5 (tensor cores) and K1 one-shot,
              pages evicted, F1-F4 and the devstats identities at every
              step; xlstm: no kernel launched. Prints tok/s, step times,
              one-shot times and the recurrent layers' share of the mixed
              steps (host-clocked, synchronized around each layer).
 12. musicgen musicgen-medium at full width (bf16, random weights from a
              seed, all 48 layers, 2.29 B parameters; a random
              conditioning of (4, 64, 1536)): 4 prompts of 4 codebooks x
              2048 tokens one-shot under paged_eviction (page 16, budget
              512), 16 greedy decode steps, once on a bf16 pool (K5 on the
              tensor cores, K1) and once on int8 (K5, K2), each beside the
              plain-kernel run of the same inputs for its first 4 steps
              (greedy tokens equal are printed); then at 8 of the 48 layers
              (the same weights) three forward_step calls with cross
              caches (prompt chunks of 256, a mixed step, a decode-only
              step: K3 on the tensor cores, K1) and 2 AdamW steps at B 2 x
              4 x S 1024: every layer's self- and cross-attention wq / wk /
              wv with a gradient, no kernel launched. Checks the launches,
              evictions, the budget, F1-F4; prints prefill and decode-step
              ms, peak memory and the step and training times.
 13. tp       tensor-parallel serving at tp 2: two ranks spawned on the
              one card (gloo; NCCL refuses two ranks on one device), each
              with its half of the KV heads. (a) gemma3-27b and
              mixtral-8x7b at reduced(tp=2) (per rank KV 1, G 2), phase
              3's workload under paged_eviction on f32 and int8 pools,
              against tp 1 run here on the same weights: greedy tokens,
              devstats, victims and integer pool state equal at every
              step, scores within 1e-6 (int8: one quantization step
              relative), the ranks' metadata equal after every step, each
              rank's K/V its slice of the tp-1 pool (1e-5; int8 one
              step). (b) llama-3.1-8b at full width (bf16, random weights
              from a seed, 4 of 32 layers): 8 requests of 1024-2048
              tokens, half sharing a 256-token prefix, 16 greedy tokens
              (page 16, budget 512, max batch 8, chunk 256, splits 4).
              Checks every request's token count, K1 and K3 (tensor
              cores) launched on each rank at KV 4, pages evicted and
              prefixes shared, F1-F4 and the devstats identities at every
              step, the ranks' metadata equal at every step, each rank's
              payload <= total / 2 + one page, every step's collectives
              against launch.mesh.step_collectives (all-reduces only);
              prints tok/s and step times (two ranks time-sharing one
              card: no TP speed), the share of greedy tokens equal to tp
              1's, peak memory per rank and the phase's seconds.
 14. grid     training over a grid: four ranks spawned on the one card
              (gloo, the functional collectives staged through the host),
              each case first trained on one rank here. (a) the CPU
              test's cases, reduced f32, B 4 x S 64, 2 AdamW steps (aux
              weight 0: the MoE regions average aux per data shard, as
              JAX's): llama-3.2-1b at (data 2, model 2) with ZeRO-1,
              qwen2.5-3b reduced(tp=2) (KV heads split), mixtral-8x7b
              model-split and expert-parallel (data 1, expert 2, tp 2),
              jamba; losses within 1e-5 relative, parameters 1e-5,
              moments 1e-4 of their largest. (b) llama-3.2-1b at full
              width, 2 of 16 layers, bf16, B 4 x S 2048, (2, 2) with
              ZeRO-1, 3 steps; (c) mixtral-8x7b at full width, 1 of 32
              layers, bf16, B 2 x S 1024, expert-parallel, 2 steps, and
              its MoE block alone against one rank's (load, dropped,
              out); losses within 1e-2 relative, moment bytes per rank
              at most 1.01 x total / 4, all-to-alls in every (c) step.
              Prints per rank the parameter and moment bytes, peak
              memory, collectives per step by kind (CommDebugMode) and
              step ms (ranks time-slicing the card: no grid speed).
 15. dry      (a) the five examples (repro_torch.examples) at their
              defaults with --device cuda: budgets held, tokens
              generated, train_small's loss falling and its checkpoint
              restored equal; K5 and K1 launched by quickstart and
              long_context_decode, K3 and K1 by serve_batch and
              train_small's serving. (b) the one-shot path
              (forward_prefill / decode_step with ac) at (data 2, model
              2) on four gloo ranks, each case also on one rank: reduced
              llama f32 and int8, mixtral and jamba (4 right-padded
              prompts, 8 decode steps of one rank's tokens): logits
              within 1e-5 relative, the integer pool state equal after
              the prefill and every step; llama-3.2-1b at full width (2
              of 16 layers, bf16, 4 x 2048 tokens, 16 steps): K5 on the
              tensor cores and K1 on every rank, pool payload per rank
              <= total / 4 + a page per row, one rank's tokens decoded:
              logits within SHARD_BF16_RTOL relative of one rank's and
              the integer pool state equal after the prefill and every
              step; each case's collectives in a decode step, and the
              full-width case's peak per rank in one. (c) the dry run
              (launch.dryrun) in subprocesses on the host, started first:
              llama-3.2-1b at the four shapes on (16, 16), mixtral-8x7b
              train_4k on (16, 8, 2), phase 14 (b)'s step on a fake (2,
              2) group, whose parameter and moment bytes per rank and
              collectives per step must equal phase 14 (b)'s and whose
              peak (arguments + temp) must lie within 0.5-2x the measured
              one, and (b)'s full-width decode step on a fake (2, 2)
              group, whose temp must lie within 0.5-2x the peak above
              the arguments measured on each rank.

Prints the card's name and power limit, one JSON line describing every
kernel (with the route each timing took, "timed_route", the device-only
times "device_ms", "device_clean_ms" and "library_device_ms", the launch
floor "floor_device_ms", the head dims it was checked at, "head_dims", its
device_ms and bound at hd 32, 80 and 96, "other_head_dims", and at the
family shapes, "other_shapes"), and as the
last line {"ok": true, "device":
{...}}. Exits non-zero without a CUDA device or without the repository's
sources beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# each rank's heads in phase 13 (tp 2): (b) llama-3.1-8b's 32 / 8 heads,
# (a) the reduced gemma3 / mixtral's 4 / 2 (f32 and int8 pools, page 8)
TP_SHAPES = {
    "llama-3.1-8b tp 2 (per rank)": (4, 4, 128, 16),
    "reduced(tp=2) (per rank)": (1, 2, 64, 8),
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


# the heads of the families the kernels had not met on the card, each on a
# bf16 pool: (KV, G, hd, page), the pool's slots per row, the windows held
# (gemma3's local window at its local slab of (1024 + 16) / 16 = 65 pages)
FAMILY_SHAPES = {
    "chameleon-34b (G 8)": ((8, 8, 128, 16), P, (0, 8 * 16)),
    "mixtral-8x22b (G 6)": ((8, 6, 128, 16), P, (0, 8 * 16)),
    "gemma3-27b (32/16 heads, window 1024)": ((16, 2, 128, 16), 65,
                                              (0, 1024)),
    "musicgen-medium (G 1, 24/24 heads)": ((24, 1, 64, 16), P, (0,)),
}


def check_family_shapes(torch, worst):
    """K1, K3 (with K4 bit for bit) and K5 against their plain versions at
    FAMILY_SHAPES, bf16 throughout: K1 at splits 1 and 4 on a churned pool
    (row 1 unmapped, row 2 at cur_pos -1: exact zeros), K3/K4 at chunk 256
    (G * T rows up to 2048), K5 on one prompt of 4096 tokens; each at the
    shape's windows, within today's tolerances (K1 one bf16 step, the
    tensor-core routes the derived bound)."""
    from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                                   flash_attention_plain,
                                                   flash_route,
                                                   paged_prefill_cuda,
                                                   paged_prefill_plain,
                                                   prefill_route)
    from repro_torch.kernels.paged_attention import (combine_splits,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.kernels.ref import (abs_value_weight, churned_pool,
                                         prefill_positions)
    bf16 = torch.bfloat16
    for n, (label, ((KV, G, hd, page), Pn, windows)) in enumerate(
            FAMILY_SHAPES.items()):
        seed = 5000 + 10 * n
        k, v, pos, bt, cur = churned_pool(B, Pn, page, KV, hd, bf16, seed)
        bt[1] = -1
        cur[2] = -1
        g = torch.Generator().manual_seed(seed)
        q = torch.randn((B, KV, G, hd), generator=g).to(bf16).cuda()
        err = share = nerr = 0.0
        for window in windows:
            for splits in (1, 4):
                kw = dict(window=window, num_splits=splits,
                          return_scores=True)
                a, m, l, nk = paged_attention_cuda(q, k, v, pos, bt, cur,
                                                   **kw)
                a2, m2, l2, nk2 = paged_attention_plain(q, k, v, pos, bt,
                                                        cur, **kw)
                o = combine_splits(a, m, l).to(bf16)
                torch.cuda.synchronize()
                if o[1:3].any():
                    fail(f"paged_decode: the unmapped row or the row at "
                         f"cur_pos -1 is not zero ({label})")
                e, sh = _err(o, combine_splits(a2, m2, l2).to(bf16),
                             "bfloat16")
                err, share = max(err, e), max(share, sh)
                nerr = max(nerr, _norm_err(nk, nk2))
        _check(worst, "paged_decode", f"{label} (KV {KV}, G {G}, hd {hd}, "
               f"{Pn} slots) bf16, windows {windows} x splits 1/4", err,
               share, nerr, hd=hd)
        # the prefill kernels on the same pool (its row 1 mapped again)
        k, v, pos, bt, cur = churned_pool(B, Pn, page, KV, hd, bf16,
                                          seed + 1)
        qp = prefill_positions(cur.cpu(), T).cuda()
        qf = torch.randn((B, T, KV * G, hd), generator=g).to(bf16).cuda()
        route = prefill_route(bf16, bf16, hd)
        for window in windows:
            kw = dict(window=window, return_scores=True)
            o, nk = paged_prefill_cuda(qf, k, v, pos, bt, qp, **kw)
            o2, nk2 = paged_prefill_plain(qf, k, v, pos, bt, qp, **kw)
            o3, _ = paged_prefill_cuda(qf, k, v, pos, bt, qp,
                                       window=window, per_qhead=True)
            torch.cuda.synchronize()
            wt = abs_value_weight(qf, k, v, window=window, pos=pos,
                                  block_table=bt, q_pos=qp) \
                if route == "tensor_core" else None
            case = f"{label} bf16 window {window}, {G * T} rows ({route})"
            _check(worst, "paged_prefill", case, *_err(o, o2, "bfloat16", wt),
                   _norm_err(nk, nk2), hd=hd)
            _check(worst, "paged_prefill_per_qhead", case,
                   *_err(o3, o2, "bfloat16", wt),
                   extra=f"; bit-equal to the G-fold kernel: "
                         f"{bool(torch.equal(o3, o))}", hd=hd)
            if not torch.equal(o3, o):
                fail(f"the per-Q-head prefill kernel is not bit-equal to "
                     f"the G-fold one ({label}, window {window})")
            del o, o2, o3, nk, nk2, wt
        del k, v, pos, bt, qf
        route = flash_route(bf16, hd)
        for window in windows:
            x = [torch.randn((1, S1, n, hd), generator=g).to(bf16).cuda()
                 for n in (KV * G, KV, KV)]
            o = flash_attention_cuda(*x, window=window)
            o2 = flash_attention_plain(*x, window=window)
            torch.cuda.synchronize()
            wt = abs_value_weight(*x, window=window) \
                if route == "tensor_core" else None
            _check(worst, "flash_attention", f"{label} bf16 S {S1} window "
                   f"{window} ({route})", *_err(o, o2, "bfloat16", wt),
                   hd=hd)
            del x, o, o2, wt
        torch.cuda.empty_cache()


def check_decode(torch, worst):
    """The decode kernel (float and int8 pools) against its plain version:
    every shape of DECODE_SHAPES, NEW_HD_SHAPES and TP_SHAPES, every q /
    pool dtype pair the wrapper takes, window 0 and 8 pages, splits 1, 2, 4
    and P (one page per split),
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
              **{k: shape for k, (shape, _) in NEW_HD_SHAPES.items()},
              **TP_SHAPES}
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
    check_family_shapes(torch, worst)
    seed = 0
    shapes = {**SHAPES,
              **{k: shape for k, (shape, _) in NEW_HD_SHAPES.items()},
              **TP_SHAPES}
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

def states(layers):
    """The recurrent states among a model's layer caches, in depth
    order."""
    from repro_torch.core.paged_cache import PagedLayerCache
    return [c for c in layers if not isinstance(c, PagedLayerCache)]


def state_tensors(st):
    return [getattr(st, f.name) for f in dataclasses.fields(st)]


def recurrent_gap(torch, layers_a, layers_b):
    """(largest |a - b| over the recurrent states of two runs, the states'
    largest finite magnitude); entries equal on both (the -inf of an
    unused xLSTM row among them) count 0, and any other non-finite entry
    on either run makes the gap inf."""
    gap = mag = 0.0
    for sa, sb in zip(states(layers_a), states(layers_b)):
        for a, b in zip(state_tensors(sa), state_tensors(sb)):
            d = torch.where(a == b, 0.0, (a.float() - b.float()).abs())
            g = float(d.nan_to_num(math.inf, posinf=math.inf).max())
            gap = max(gap, g)
            mag = max(mag, float(a.float().abs().nan_to_num(
                0.0, posinf=0.0, neginf=0.0).max()))
    return gap, mag


def check_states_finite(torch, layers, rows, what):
    """Every recurrent state of batch ``rows`` finite."""
    for i, st in enumerate(states(layers)):
        for f, t in zip(dataclasses.fields(st), state_tensors(st)):
            if not bool(torch.isfinite(t[rows]).all()):
                fail(f"{what}: recurrent layer {i} {f.name} not finite")


def pool_totals(torch, eng):
    """[sum(ref_count), free pages, mapped entries] over every attention
    layer (one device read); None without one."""
    from repro_torch.models.transformer import paged_layers
    ps = paged_layers(eng.cache.layers)
    if not ps:
        return None
    return torch.stack([torch.stack([c.ref_count.sum(),
                                     (c.ref_count == 0).sum(),
                                     (c.block_table >= 0).sum()])
                        for c in ps]).sum(0).cpu().numpy()


def check_conservation(np, devstats, before, after, st):
    alloc, freed = st[devstats.PAGES_ALLOCATED], st[devstats.PAGES_FREED]
    rel, adopt = st[devstats.PAGES_RELEASED], st[devstats.PAGES_ADOPTED]
    want = np.array([alloc + adopt - rel, freed - alloc,
                     alloc + adopt - rel])
    if not np.array_equal(after - before, want):
        fail(f"devstats conservation: pool moved {after - before}, "
             f"devstats say {want}")


def check_invariants(np, layers):
    from repro_torch.models.transformer import paged_layers
    for i, c in enumerate(paged_layers(layers)):
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
    ledger on, it is reconciled after every step. A model without an
    attention layer has no devstats and no pool to conserve (None per
    step)."""
    from repro_torch.core.paged_cache import lineage_snapshot_host
    from repro_torch.models.transformer import paged_layers
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
            errs = led.reconcile(lineage_snapshot_host(
                paged_layers(eng.cache.layers)[0]))
            if errs:
                fail(f"lineage ledger after step {eng.stats.steps}: {errs}")
        if before is not None:
            check_conservation(np, devstats, before,
                               pool_totals(torch, eng), eng.last_stats)
        if on_step is not None:
            on_step(eng)
        per_step.append(None if before is None else eng.last_stats.copy())
        t_check += time.perf_counter() - c0
        if not more:
            break
    wall = time.perf_counter() - t0 - t_check
    tokens = {r.request_id: list(r.output_tokens)
              for r in eng.scheduler.finished}
    return tokens, per_step, wall, step_walls


def pool_state(np, layers):
    """Per attention layer: the integer pool state (one array) and, on int8
    pools, (int8 K and V, their scales)."""
    from repro_torch.models.transformer import paged_layers
    ints, q8 = [], []
    for c in paged_layers(layers):
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


def engine_parity(torch, np, kv_dtype, policy="paged_eviction", arch=None,
                  budget=48):
    """The reduced config served through the kernels and through their plain
    versions (with a trace, the lineage ledger and a timeline), and, for
    paged_eviction on a float pool, through the kernels once more with
    regret probes every 2 decode steps. ``arch``: that arch's reduced config
    instead (prompts of 96-160 tokens, past a windowed family's window of
    64; no probe run; prefix adoptions printed, not required, since
    windowed layers shed prompt pages). A recurrent family (jamba, xlstm)
    must adopt no prefix (sharing is off for it) and its recurrent states
    after the two runs must agree within 1e-3 of their magnitude; xlstm,
    with no attention layer, has no lineage ledger and launches no
    kernel."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.trace import validate_file
    from repro_torch.serving import Engine
    cfg = _reduced(get_arch) if arch is None else get_arch(arch).reduced()
    params = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 32)
    rest = (8, 64) if arch is None else (64, 128)
    prompts = [np.concatenate([shared if i % 2 else
                               rng.integers(0, cfg.vocab_size, 32),
                               rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(*rest)))])
               .astype(np.int32) for i in range(8)]
    probe = policy == "paged_eviction" and kv_dtype == "float32" and \
        arch is None
    attn = cfg.num_attn_layers() > 0
    out, inputs, obs_out = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for plain, every in ((False, 0), (True, 0)) + \
                (((False, 2),) if probe else ()):
            trace = os.path.join(tmp, f"{plain}-{every}.jsonl")
            eng = Engine(cfg, params, cache_cfg=CacheConfig(
                page_size=8, cache_budget=budget, policy=policy,
                dtype=kv_dtype), max_batch=4,
                max_prompt_len=32 + rest[1], max_new_tokens=16, chunk_size=32,
                decode_splits=2, device="cuda", plain_kernels=plain,
                obs=ObsConfig(trace_path=trace, lineage=attn, timeline=True,
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
                        eng.stats, eng.cache.layers))
    (tk, sk, ik, qk, stk, cache_k), (tp, sp, ip, qp, stp, cache_p) = out
    what = f"engine parity ({arch or 'reduced, G 2'}, {policy}, {kv_dtype}" \
        f", budget {budget})"
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
    # the baselines' token holes may leave no intact prefix to adopt, nor
    # may a windowed family's layers; above its window, the window alone
    # may drop its pages (freed) and force its rollovers
    dropped = getattr(stk, evicted_stat(policy))
    if arch is not None and attn:
        dropped += stk.forced_evictions + int(
            sum(st[devstats.PAGES_FREED] for st in sk))
    if (attn and not dropped) or (policy == "paged_eviction" and
                                  arch is None and
                                  not stk.shared_prefix_hits):
        fail(f"{what} exercised too little: {stk}")
    if states(cache_k):
        gap, mag = recurrent_gap(torch, cache_k, cache_p)
        launched = {k: v for k, v in obs_out[0][1].items() if v}
        if stk.shared_prefix_hits or gap > 1e-3 * mag or \
                (not attn and launched):
            fail(f"{what}: {stk.shared_prefix_hits} prefix adoptions, "
                 f"recurrent states {gap:.3g} apart (magnitude {mag:.3g}), "
                 f"launches {launched}")
        print(f"  engine {arch}: recurrent states of the two runs at most "
              f"{gap:.3g} apart (magnitude {mag:.3g}, {gap / mag:.3g} of "
              f"it); launches {launched}", flush=True)
    print(f"  engine {arch or ''} {policy} {kv_dtype:8s} budget {budget}: "
          f"{len(tk)} requests, {len(sk)} "
          f"steps: tokens, per-step devstats, pool state, trace step "
          f"records, {n_events} lineage events and timelines equal; int8 "
          f"values one step apart {flips[0]} of {flips[1]}; evicted "
          f"{stk.pages_evicted} pages, {stk.tokens_evicted} tokens, forced "
          f"{stk.forced_evictions}, {stk.shared_prefix_hits} prefix "
          f"adoptions", flush=True)


def oneshot_run(torch, params, cfg, ccfg, tokens, valid, steps, plain,
                decode_splits=1, on_step=None, cond=None):
    """forward_prefill (of ``tokens`` (B, S), or (B, K, S) with codebooks,
    under the conditioning ``cond`` when given), then ``steps`` greedy
    decode_steps (the kernels' eviction ranking, fused_scores, on both).
    The caches get devstats vectors after the prefill (a wholesale reset,
    it emits none), so every decode step's events are read; ``on_step(layers)``, when given, after
    each step (its time counts). Returns (tokens (B, steps), layer caches,
    live tokens per attention layer and row after prefill, per-step
    devstats (steps, NSTATS; zeros without an attention layer), prefill
    seconds, decode seconds); with codebooks the tokens are (B, steps,
    K)."""
    from repro_torch.core import devstats
    from repro_torch.core.policies import get_policy
    from repro_torch.models.transformer import (collect_step_stats,
                                                decode_step, forward_prefill,
                                                paged_layers)
    pol = get_policy(ccfg.policy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = forward_prefill(params, cfg, tokens, pol, ccfg,
                                    valid=valid,
                                    total_seq_hint=tokens.shape[-1] + steps,
                                    plain_kernels=plain, cond=cond)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ps = paged_layers(cache.layers)
    live = torch.stack([c.total_valid() for c in ps]) if ps else \
        torch.zeros((0, tokens.shape[0]), dtype=torch.int32)
    for c in ps:
        c.stats = devstats.zeros(c.device)
    none = torch.zeros((devstats.NSTATS,), dtype=torch.int32,
                       device=tokens.device)
    out, stats = [], []
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, tok, cache, pol, ccfg,
                                    decode_splits=decode_splits,
                                    fused_scores=True, plain_kernels=plain)
        st = collect_step_stats(cache)
        stats.append(none if st is None else st)
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


def oneshot_parity(torch, np, kv_dtype, S=128, policy="paged_eviction",
                   arch=None, budget=32):
    """The reduced config's one-shot path (forward_prefill + 8 decode
    steps) through the kernels and through their plain versions; ``arch``:
    that arch's reduced config instead (musicgen: (B, K, S) codebook
    tokens and a random conditioning)."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.multimodal import token_shape
    from repro_torch.models.transformer import init_model
    cfg = _reduced(get_arch) if arch is None else get_arch(arch).reduced()
    params = init_model(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    Bp = 3
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, token_shape(cfg, Bp, S)).astype(np.int32)).cuda()
    cond = None
    if cfg.cross_attention:
        cond = torch.from_numpy(rng.standard_normal(
            (Bp, cfg.cond_len, cfg.d_model)).astype(np.float32)).cuda()
    valid = torch.arange(S, device="cuda")[None, :] < \
        torch.tensor([[S], [S - 5], [S - 19]], device="cuda")
    ccfg = CacheConfig(page_size=8, cache_budget=budget, policy=policy,
                       dtype=kv_dtype)
    reset_launches()
    runs, inputs = [], []
    for plain in (False, True):
        seen, undo = record_quantize()
        try:
            runs.append(oneshot_run(torch, params, cfg, ccfg, tokens, valid,
                                    8, plain, decode_splits=2, cond=cond))
        finally:
            undo()
        inputs.append(seen)
    launches = read_launches()
    (tk, lk, _, sk, _, _), (tp, lp, _, sp, _, _) = runs
    what = f"one-shot parity ({arch or 'reduced, G 2'}, {policy}, " \
        f"{kv_dtype}, S {S}, budget {budget})"
    dec = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    attn = cfg.num_attn_layers() > 0
    if attn != bool(launches["flash_attention"] and launches[dec]) or \
            (not attn and any(launches.values())):
        fail(f"{what}: kernels not launched as the layers ask: {launches}")
    gap, mag = recurrent_gap(torch, lk, lp)
    if gap > 1e-3 * mag:
        fail(f"{what}: recurrent states {gap:.3g} apart (magnitude "
             f"{mag:.3g})")
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
    if arch is not None:        # above its window: forced rollovers
        evicted += int(sk[:, devstats.FORCED_EVICTIONS].sum())
    unit = name.removesuffix("_evicted")
    if attn and not evicted:
        fail(f"{what}: no {unit} evicted in decode")
    if qk:
        print(f"  one-shot int8 quantizer inputs: "
              f"{first_flip(torch, *inputs)}", flush=True)
    print(f"  one-shot {arch or ''} {policy} {kv_dtype:8s} S {S} budget "
          f"{budget}: {tk.shape[0]} prompts, "
          f"8 steps: tokens, per-step devstats and integer cache state "
          f"equal; int8 values one step apart {flips[0]} of {flips[1]}; "
          f"evicted {evicted} {unit}; recurrent states {gap:.3g} apart "
          f"(magnitude {mag:.3g}); launches {launches}", flush=True)


def serving_prompts(np, vocab, n_requests, max_len, prompt_len=None):
    """``n_requests`` prompts of 1024-``max_len`` tokens from seed 0, every
    other one opening with a shared 256-token prefix; each cut to
    ``prompt_len`` tokens when given."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 256)
    prompts = []
    for i in range(n_requests):
        n = int(rng.integers(1024, max_len + 1))
        head = shared if i % 2 == 0 else rng.integers(0, vocab, 256)
        prompts.append(np.concatenate(
            [head, rng.integers(0, vocab, n - 256)]).astype(np.int32)
            [:prompt_len])
    return prompts


def serve_full_width(torch, np, kv_dtype, n_requests,
                     policy="paged_eviction", new_tokens=32, on_step=None,
                     obs=None, max_batch=8, num_layers=None, params=None,
                     prompt_len=None, arch="llama-3.2-1b", budget=512,
                     max_len=2048, sharing=None, on_engine=None,
                     token_budget=None):
    """Serve ``n_requests`` prompts of 1024-``max_len`` tokens (every other
    one opening with a shared 256-token prefix; each cut to ``prompt_len``
    tokens when given) on ``arch`` at full width, ``new_tokens`` greedy
    tokens each, with ``obs`` (an ObsConfig; default metrics only), at
    ``num_layers`` of its layers when given, from ``params`` when given
    (else random weights from seed 0), at ``budget``. Checks that every
    request finished, the path's kernels and routes, that the policy evicted
    (and, under paged_eviction with more than 2 requests or when
    ``sharing``, shared prefixes) and F1-F4 at the end. ``on_engine(eng)``,
    when given, runs once before the first request is submitted;
    ``token_budget``: the engine's tokens per step (default one prefill
    chunk beside the decode rows). Returns
    (launches, engine, wall seconds, per-step wall seconds of
    ``eng.step()``)."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    cfg = get_arch(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    t0 = time.perf_counter()
    if params is None:
        params = init_model(cfg, seed=0, device="cuda")
    eng = Engine(cfg, params, cache_cfg=CacheConfig(
        page_size=16, cache_budget=budget, policy=policy,
        dtype=kv_dtype), max_batch=max_batch, max_prompt_len=max_len,
        max_new_tokens=new_tokens, chunk_size=256, decode_splits=4,
        token_budget=token_budget, device="cuda", obs=obs)
    torch.cuda.synchronize()
    # block-table widths differ by layer kind (a windowed layer's slab)
    slots = sorted({(spec.attn_kind, c.num_pages) for spec, c in
                    zip(cfg.layer_specs(), eng.cache.layers)})
    print(f"  model + caches ready in {time.perf_counter() - t0:.1f} s; "
          f"pool payload {eng.pool_bytes()['payload_total'] / 2 ** 20:.1f} "
          f"MiB over {cfg.num_layers} layers ({kv_dtype}, {policy}, slots "
          f"per row by layer kind {slots})", flush=True)
    prompts = serving_prompts(np, cfg.vocab_size, n_requests, max_len,
                              prompt_len)
    if on_engine is not None:
        on_engine(eng)
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
    if sharing is None:
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
    cfg = dataclasses.replace(get_arch("llama-3.2-1b"),
                              num_layers=ONESHOT_LAYERS)
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


# depth cuts for the run time (of llama-3.2-1b's 16 layers, full width):
# phase 4, phase 5, phase 6, phase 7 (served and one-shot), phase 8 and
# 9b, so that the run with phase 3's recurrent and musicgen runs and
# phases 11 and 12 takes no longer than it did without them (PERF.md
# section 4 gives what each cut saves)
SERVE_LAYERS = 1
ONESHOT_LAYERS = 4
INT8_SERVE_LAYERS = 1
BASELINE_LAYERS = 1
REGRET_LAYERS = 2
TRAIN_LAYERS = 2


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
            torch, np, "bfloat16", n_requests, num_layers=SERVE_LAYERS,
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
    """Phase 8: eviction-regret shadow probes at full width (REGRET_LAYERS
    of the 16 layers): 2 of phase 4's requests (max batch 2), 16 greedy
    tokens, probes every 4 decode steps, paged_eviction at budget 512."""
    from repro_torch.obs import ObsConfig
    taps = []
    _, eng, wall, _ = serve_full_width(
        torch, np, "bfloat16", 2, new_tokens=16, max_batch=2,
        num_layers=REGRET_LAYERS, obs=ObsConfig(regret_every=4),
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


# ---------------------------------------------------------------------------
# phase 10: the attention-only families at full width
# ---------------------------------------------------------------------------

# arch -> (layers run, budget): depth cut for the run time, widths never cut;
# gemma3 runs one whole period (5 local layers, 1 global) at a budget above
# its local window, so that the window, not the budget, bounds those layers
FAMILIES = {
    "stablelm-3b": (4, 512),
    "gemma3-27b": (6, 2048),
    "chameleon-34b": (2, 512),
    "mixtral-8x7b": (2, 512),
}
FAMILY_NEW_TOKENS = 16


def _kind_sums(torch, cfg, layers, field):
    """{attn kind: sum over its layers} of a devstats field."""
    out: dict = {}
    for spec, c in zip(cfg.layer_specs(), layers):
        out[spec.attn_kind] = out.get(spec.attn_kind, 0) + \
            int(c.stats[field])
    return out


def _kind_live(cfg, layers):
    """{attn kind: the most live tokens a row holds in one of its
    layers}."""
    out: dict = {}
    for spec, c in zip(cfg.layer_specs(), layers):
        out[spec.attn_kind] = max(out.get(spec.attn_kind, 0),
                                  int(c.total_valid().max()))
    return out


def _window_leftovers(torch, cfg, layers, rows):
    """Live tokens at or below newest - window in the windowed layers'
    ``rows``: (on pages the row holds alone, on shared pages). A chunk
    evict drops the first kind all; a shared page keeps its tokens until
    its copy-on-write fork, one per row and call, as in the JAX
    package."""
    from repro_torch.models.attention import spec_window
    alone = shared = 0
    for spec, c in zip(cfg.layer_specs(), layers):
        w = spec_window(cfg, spec)
        if not w or not rows:
            continue
        pv = c.pos_view()[rows]                          # (r, P, page)
        newest = pv.reshape(len(rows), -1).amax(-1)[:, None, None]
        out = (pv >= 0) & (pv <= newest - w)
        own = (c.ref_count[c._phys()[rows]] <= 1)[..., None]
        alone += int((out & own).sum())
        shared += int((out & ~own).sum())
    return alone, shared


def family_full_width(torch, np, arch, num_layers, budget):
    """One family at full width (bf16, random weights from seed 0, the
    first ``num_layers`` layers): 4 requests of 1024-3072 prompt tokens
    served (2 share a 256-token prefix; 16 greedy tokens, page 16, max batch
    4, chunk 256 with a token budget of 4 chunks a step, so that the 4
    prompts prefill side by side; decode splits 4, paged_eviction at
    ``budget``), F1-F4
    and devstats conservation at every step; then phase 5's 4 prompts
    one-shot (K5), compressed to ``budget`` and 16 decode steps. Checks K1,
    K3 (tensor cores) and K5 (tensor cores, every layer) launched and pages
    evicted; on windowed layers, no live token at or below newest - window
    in a row just after its chunk evict. Prints forced rollovers and live
    tokens by layer kind, and for an MoE model the MoE blocks' share of the
    mixed steps (host-clocked: the card synchronized around each block).
    Returns the launches of the serving and the one-shot runs."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models import transformer as tf
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=num_layers)
    t0 = time.perf_counter()
    params = tf.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"  {arch}: {num_layers} of {full.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters "
          f"({sum(nbytes(p) for p in _leaves(params)) / 2 ** 30:.2f} GiB), "
          f"initialised in {time.perf_counter() - t0:.1f} s; layer kinds "
          f"{[s.attn_kind + '/' + s.mlp for s in cfg.layer_specs()]}",
          flush=True)
    seen = {"forced": {}, "live": {}, "leftover": 0, "on_shared": 0,
            "mixed_moe_s": 0.0,
            "moe_s": 0.0, "plan": None}

    def on_engine(eng):
        plan = eng.scheduler.plan

        def recorded():
            seen["plan"] = plan()
            return seen["plan"]
        eng.scheduler.plan = recorded

    def on_step(eng):
        layers = eng.cache.layers
        check_invariants(np, layers)
        for k, v in _kind_sums(torch, cfg, layers,
                               devstats.FORCED_EVICTIONS).items():
            seen["forced"][k] = seen["forced"].get(k, 0) + v
        for k, v in _kind_live(cfg, layers).items():
            seen["live"][k] = max(seen["live"].get(k, 0), v)
        plan = seen["plan"]
        rows = [slot for slot, *_ in plan.prefill]
        alone, shared = _window_leftovers(torch, cfg, layers, rows)
        seen["leftover"] += alone
        seen["on_shared"] = max(seen["on_shared"], shared)
        if plan.prefill:
            seen["mixed_moe_s"] += seen["moe_s"]
        seen["moe_s"] = 0.0

    block = tf.mlp_block

    def timed_block(lp, cfg_, spec, x, dense_combine, **kw):
        if spec.mlp != "moe":
            return block(lp, cfg_, spec, x, dense_combine, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = block(lp, cfg_, spec, x, dense_combine, **kw)
        torch.cuda.synchronize()
        seen["moe_s"] += time.perf_counter() - t
        return out

    moe = any(s.mlp == "moe" for s in cfg.layer_specs())
    if moe:
        tf.mlp_block = timed_block
    try:
        launches, eng, wall, _ = serve_full_width(
            torch, np, "bfloat16", 4, new_tokens=FAMILY_NEW_TOKENS,
            max_batch=4, params=params, arch=arch, budget=budget,
            max_len=3072, sharing=False, on_step=on_step,
            on_engine=on_engine, num_layers=num_layers, token_budget=4 * 256)
    finally:
        tf.mlp_block = block
    s = eng.stats
    if seen["leftover"]:
        fail(f"{arch}: {seen['leftover']} live tokens at or below newest - "
             f"window on unshared pages of windowed layers after their "
             f"chunk evict")
    if launches["paged_prefill/tensor_core"] != launches["paged_prefill"]:
        fail(f"{arch}: a prefill launch left the tensor cores: {launches}")
    print(f"  {arch} serving: forced rollovers by layer kind "
          f"{seen['forced']}, most live tokens per row by layer kind "
          f"{seen['live']}; after a chunk evict no live token out of the "
          f"window on an unshared page, at most {seen['on_shared']} on "
          f"shared pages awaiting their copy-on-write fork", flush=True)
    if moe:
        print(f"  {arch} serving: MoE blocks {1e3 * seen['mixed_moe_s']:.1f} "
              f"ms of {1e3 * s.prefill_s:.1f} ms in the "
              f"{s.steps - s.decode_steps} mixed steps "
              f"({seen['mixed_moe_s'] / s.prefill_s:.3f}; host-clocked, the "
              f"card synchronized around each block)", flush=True)
    del eng
    torch.cuda.empty_cache()

    # one-shot
    tokens, valid = oneshot_prompts(torch, np, cfg.vocab_size)
    ccfg = CacheConfig(page_size=16, cache_budget=budget,
                       policy="paged_eviction", dtype="bfloat16")
    forced: dict = {}

    def on_decode(layers):
        check_invariants(np, layers)
        for k, v in _kind_sums(torch, cfg, layers,
                               devstats.FORCED_EVICTIONS).items():
            forced[k] = forced.get(k, 0) + v

    reset_launches()
    toks, layers, live, stats, t_pre, t_dec = oneshot_run(
        torch, params, cfg, ccfg, tokens, valid, FAMILY_NEW_TOKENS,
        plain=False, decode_splits=4, on_step=on_decode)
    one = read_launches()
    L = cfg.num_layers
    if one["flash_attention"] != L or one["flash_attention/tensor_core"] != L \
            or not one["paged_decode"]:
        fail(f"{arch} one-shot: not {L} flash launches on the tensor cores "
             f"and decode launches: {one}")
    evicted = int(stats[:, devstats.PAGES_EVICTED].sum() +
                  stats[:, devstats.FORCED_EVICTIONS].sum())
    if not evicted:
        fail(f"{arch} one-shot: no page evicted in decode")
    if int(live.max()) > budget + 16:
        fail(f"{arch} one-shot: {int(live.max())} live tokens after "
             f"prefill, above budget + page")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{arch} one-shot: a token outside the vocabulary")
    kinds = [sp.attn_kind for sp in cfg.layer_specs()]
    after = {k: int(max(live[i].max() for i in range(L) if kinds[i] == k))
             for k in set(kinds)}
    print(f"  {arch} one-shot: prefill {1e3 * t_pre:.1f} ms, mean decode "
          f"step {1e3 * t_dec / FAMILY_NEW_TOKENS:.2f} ms; live tokens per "
          f"row after prefill by layer kind {after}; "
          f"{int(stats[:, devstats.PAGES_EVICTED].sum())} pages evicted and "
          f"forced rollovers by layer kind {forced} in decode; launches "
          f"{one}", flush=True)
    del layers, params
    torch.cuda.empty_cache()
    return {"serving": launches, "one_shot": one}


def families_full_width(torch, np):
    return {arch: family_full_width(torch, np, arch, layers, budget)
            for arch, (layers, budget) in FAMILIES.items()}


# ---------------------------------------------------------------------------
# phase 11: the recurrent families at full width
# ---------------------------------------------------------------------------

# arch -> layers run, the source's widths: jamba 4 of 72 (attention + dense
# MLP, mamba + MoE, mamba + dense, mamba + MoE; 23.02 B parameters, 46.0
# GB in bf16, beside one attention layer's pool; its period of 8 layers
# would be 45.2 B, ~90 GB, past the card); xlstm one period, 8 of 48 (7
# mLSTM, 1 sLSTM; 0.508 B; the whole model would fit, but the serving
# step's per-token scan is host-bound)
RECURRENT = {"jamba-1.5-large-398b": 4, "xlstm-1.3b": 8}


def recurrent_full_width(torch, np, arch, num_layers, card):
    """One recurrent family at full width (bf16, random weights from seed
    0, the first ``num_layers`` layers): 4 requests of 1024-3072 prompt
    tokens (2 share a 256-token prefix), 16 greedy tokens, page 16, max
    batch 4, chunk 256 with a token budget of 4 chunks a step, decode
    splits 4, paged_eviction at budget 512; then 4 prompts of 2048 tokens
    one-shot, 16 decode steps. Checks every request's token count, no
    prefix adoption (sharing is off for a recurrent model), every recurrent
    state finite after every step; with an attention layer (jamba) K1 and
    K3 (tensor cores) served, K5 (tensor cores) and K1 one-shot, pages
    evicted, F1-F4 and the devstats identities at every step; without one
    (xlstm) no kernel launched. Prints the recurrent layers' share of the
    mixed steps (host-clocked: the card synchronized around each layer),
    each reading beside ``card`` (its name and power limit). Returns the
    launches of the serving and the one-shot runs."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Engine
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=num_layers)
    attn = cfg.num_attn_layers() > 0
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"  {arch}: {num_layers} of {full.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters "
          f"({sum(nbytes(p) for p in _leaves(params)) / 2 ** 30:.2f} GiB; "
          f"{before / 2 ** 30:.2f} GiB allocated before), initialised in "
          f"{time.perf_counter() - t0:.1f} s; layer kinds "
          f"{[s.mixer + '/' + s.mlp for s in cfg.layer_specs()]}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ccfg = CacheConfig(page_size=16, cache_budget=512,
                       policy="paged_eviction", dtype="bfloat16")
    eng = Engine(cfg, params, cache_cfg=ccfg, max_batch=4,
                 max_prompt_len=3072, max_new_tokens=FAMILY_NEW_TOKENS,
                 chunk_size=256, token_budget=4 * 256, decode_splits=4,
                 device="cuda")
    seen = {"used": set(), "rec_s": 0.0, "mixed_rec_s": 0.0, "plan": None}
    plan = eng.scheduler.plan

    def recorded():
        seen["plan"] = plan()
        return seen["plan"]
    eng.scheduler.plan = recorded

    def on_step(eng):
        check_invariants(np, eng.cache.layers)
        seen["used"] |= {i for i, r in enumerate(eng.scheduler.slots)
                         if r is not None}
        check_states_finite(torch, eng.cache.layers, sorted(seen["used"]),
                            f"{arch} serving step {eng.stats.steps}")
        if seen["plan"].prefill:
            seen["mixed_rec_s"] += seen["rec_s"]
        seen["rec_s"] = 0.0

    step_recurrent = tf._step_recurrent

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_recurrent(*args, **kw)
        torch.cuda.synchronize()
        seen["rec_s"] += time.perf_counter() - t
        return out

    prompts = serving_prompts(np, cfg.vocab_size, 4, 3072)
    tf._step_recurrent = timed
    reset_launches()
    try:
        tokens, _, wall, _ = run_engine(torch, np, devstats, eng, prompts,
                                        FAMILY_NEW_TOKENS, on_step)
    finally:
        tf._step_recurrent = step_recurrent
    launches = read_launches()
    s = eng.stats
    mixed = s.steps - s.decode_steps
    print(f"  {arch} serving: {len(tokens)} requests, {s.tokens_generated} "
          f"tokens, {s.steps} steps ({mixed} mixed, {s.decode_steps} "
          f"decode-only) in {wall:.2f} s: {s.tokens_generated / wall:.1f} "
          f"tok/s; mean step {1e3 * s.prefill_s / max(mixed, 1):.2f} ms "
          f"mixed, {1e3 * s.decode_s / max(s.decode_steps, 1):.2f} ms "
          f"decode-only; recurrent layers {1e3 * seen['mixed_rec_s']:.1f} ms "
          f"of {1e3 * s.prefill_s:.1f} ms in the mixed steps "
          f"({seen['mixed_rec_s'] / s.prefill_s:.3f}; host-clocked, the card "
          f"synchronized around each layer); pages evicted "
          f"{s.pages_evicted}, forced {s.forced_evictions}, prefix "
          f"adoptions {s.shared_prefix_hits}; pool {eng.pool_stats()}; "
          f"launches {launches}; {card}", flush=True)
    if len(tokens) != 4 or any(len(t) != FAMILY_NEW_TOKENS
                               for t in tokens.values()) or \
            any(not 0 <= x < cfg.vocab_size for t in tokens.values()
                for x in t):
        fail(f"{arch} serving: not every request finished with "
             f"{FAMILY_NEW_TOKENS} tokens in the vocabulary: {tokens}")
    if s.shared_prefix_hits:
        fail(f"{arch} serving: {s.shared_prefix_hits} prefix adoptions with "
             f"sharing off")
    if attn:
        if not launches["paged_decode"] or not launches["paged_prefill"] or \
                launches["paged_prefill/tensor_core"] != \
                launches["paged_prefill"] or launches["paged_decode_int8"] \
                or not s.pages_evicted:
            fail(f"{arch} serving: K1 and K3 (tensor cores) not as expected "
                 f"or no page evicted: {launches}, {s}")
    elif any(launches.values()):
        fail(f"{arch} serving: kernels launched without an attention layer: "
             f"{launches}")
    del eng
    torch.cuda.empty_cache()

    # one-shot: equal lengths (a padded prompt would run its padding
    # through the recurrence, fault 9)
    B, S = 4, 2048
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    valid = torch.ones((B, S), dtype=torch.bool, device="cuda")

    def on_decode(layers):
        check_invariants(np, layers)
        check_states_finite(torch, layers, list(range(B)),
                            f"{arch} one-shot decode")

    reset_launches()
    toks, layers, live, stats, t_pre, t_dec = oneshot_run(
        torch, params, cfg, ccfg, tokens, valid, FAMILY_NEW_TOKENS,
        plain=False, decode_splits=4, on_step=on_decode)
    one = read_launches()
    check_states_finite(torch, layers, list(range(B)), f"{arch} one-shot")
    evicted = int(stats[:, devstats.PAGES_EVICTED].sum())
    L = cfg.num_attn_layers()
    if attn:
        if one["flash_attention"] != L or \
                one["flash_attention/tensor_core"] != L or \
                not one["paged_decode"] or not evicted or \
                int(live.max()) > 512 + 16:
            fail(f"{arch} one-shot: not {L} flash launches on the tensor "
                 f"cores, decode launches, evictions and the budget: {one}, "
                 f"{evicted} pages evicted, {int(live.max())} live tokens")
    elif any(one.values()):
        fail(f"{arch} one-shot: kernels launched without an attention "
             f"layer: {one}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{arch} one-shot: a token outside the vocabulary")
    print(f"  {arch} one-shot, {B} x {S}: prefill {1e3 * t_pre:.1f} ms, mean "
          f"decode step {1e3 * t_dec / FAMILY_NEW_TOKENS:.2f} ms; "
          f"{evicted} pages evicted in decode; launches {one}; {card}",
          flush=True)
    print(f"  {arch}: peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    del layers, params
    torch.cuda.empty_cache()
    return {"serving": launches, "one_shot": one}


# ---------------------------------------------------------------------------
# phase 12: musicgen (cross-attention to static conditioning, codebooks)
# ---------------------------------------------------------------------------

MUSICGEN = "musicgen-medium"
MUSICGEN_PROMPT = 2048       # one-shot prompt tokens per codebook
MUSICGEN_STEPS = 16          # one-shot greedy decode steps at full width
MUSICGEN_PLAIN_STEPS = 4     # of them, run beside the plain-kernel run
# depth of phase 12's forward_step calls and training steps (of 48 layers)
MUSICGEN_CUT_LAYERS = 8


def step_run(torch, params, cfg, ccfg, tokens, lens, cond, chunk,
             decode_steps, plain, feed=None):
    """The unified step (forward_step) over (B, K, S) codebook prompts of
    ``lens`` tokens, each layer's cross cache made from ``cond`` by
    make_cross_cache: ceil(max(lens) / chunk) steps of prompt chunks (a row
    whose prompt is done decodes beside the others: a mixed step), then
    ``decode_steps`` decode-only steps (T 1). A decoding row is fed its
    greedy tokens, or those of ``feed`` (another run's, so that two runs
    see the same inputs). Returns (per-step greedy tokens (B, K), logits,
    devstats, the fed tokens, the cache, per-step seconds)."""
    from repro_torch.core.policies import get_policy
    from repro_torch.models.attention import make_cross_cache
    from repro_torch.models.transformer import (collect_step_stats,
                                                forward_step,
                                                init_decode_caches)
    pol = get_policy(ccfg.policy)
    B, K, S = tokens.shape
    dev = tokens.device
    lens_t = torch.tensor(lens, device=dev)
    cache = init_decode_caches(cfg, B, S + decode_steps, pol, ccfg,
                               chunk_tokens=chunk, track_stats=True,
                               device=dev)
    cache.cross = [make_cross_cache(lp["xattn"], cfg, cond)
                   for lp in params["layers"]]
    done = torch.zeros(B, dtype=torch.long, device=dev)
    last = torch.zeros((B, K), dtype=torch.int32, device=dev)
    n_prefill = -(-max(lens) // chunk)
    out = {"greedy": [], "logits": [], "stats": [], "fed": [], "s": []}
    for t in range(n_prefill + decode_steps):
        T = chunk if t < n_prefill else 1
        dec = done >= lens_t
        n_tok = torch.where(dec, 1, (lens_t - done).clamp(max=chunk)).to(
            torch.int32)
        idx = (done[:, None] + torch.arange(T, device=dev)).clamp(max=S - 1)
        tok = tokens.gather(2, idx[:, None, :].expand(B, K, T)).clone()
        fed = last if feed is None else feed[t]
        tok[:, :, 0] = torch.where(dec[:, None], fed, tok[:, :, 0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = forward_step(
            params, cfg, tok, n_tok, cache, pol, ccfg, decode_mask=dec,
            reset_mask=torch.full((B,), t == 0, device=dev),
            decode_splits=4, fused_scores=True, plain_kernels=plain)
        torch.cuda.synchronize()
        out["s"].append(time.perf_counter() - t0)
        done = done + n_tok.long()
        last = logits.argmax(-1).to(torch.int32)
        for key, val in (("greedy", last), ("logits", logits), ("fed", fed),
                         ("stats", collect_step_stats(cache))):
            out[key].append(val)
    if not all(bool(torch.isfinite(x).all()) for x in out["logits"]):
        fail(f"{cfg.name} forward_step: non-finite logits")
    return out, cache


def musicgen_step_parity(torch, np):
    """The reduced f32 musicgen through forward_step with cross caches from
    make_cross_cache, through the kernels and through their plain versions
    fed the same tokens: 3 prompts of 150 / 97 / 64 tokens in chunks of 32
    (mixed steps once a prompt is done), then 4 decode-only steps, under
    paged_eviction at budget 48 (page 8): greedy tokens per codebook,
    per-step devstats and the integer pool state equal, logits within
    1e-4, pages evicted, K1 and K3 (CUDA cores) launched."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.multimodal import make_inputs
    from repro_torch.models.transformer import init_model
    cfg = get_arch(MUSICGEN).reduced()
    params = init_model(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = [150, 97, 64]
    inp = make_inputs(gen, cfg, len(lens), max(lens), "cuda")
    ccfg = CacheConfig(page_size=8, cache_budget=48,
                       policy="paged_eviction", dtype="float32")
    reset_launches()
    run, cache = step_run(torch, params, cfg, ccfg, inp["tokens"], lens,
                          inp["cond"], 32, 4, plain=False)
    launches = read_launches()
    ref, ref_cache = step_run(torch, params, cfg, ccfg, inp["tokens"], lens,
                              inp["cond"], 32, 4, plain=True,
                              feed=run["fed"])
    what = "musicgen forward_step parity (reduced, f32, budget 48)"
    for name in ("greedy", "stats"):
        if any(not torch.equal(a, b) for a, b in zip(run[name], ref[name])):
            fail(f"{what}: {name} differ between kernels and plain")
    err = max(float((a - b).abs().max())
              for a, b in zip(run["logits"], ref["logits"]))
    if err > TOL["float32"][0]:
        fail(f"{what}: logits {err:.3g} apart")
    ik, _ = pool_state(np, cache.layers)
    ip, _ = pool_state(np, ref_cache.layers)
    if any(not np.array_equal(a, b) for a, b in zip(ik, ip)):
        fail(f"{what}: integer pool state differs")
    check_invariants(np, cache.layers)
    evicted = int(sum(int(st[devstats.PAGES_EVICTED])
                      for st in run["stats"]))
    if not evicted or not launches["paged_decode"] or \
            launches["paged_prefill/cuda_core"] != launches["paged_prefill"] \
            or not launches["paged_prefill"]:
        fail(f"{what}: {evicted} pages evicted, launches {launches}")
    print(f"  forward_step {MUSICGEN} (reduced, f32): {len(run['s'])} steps "
          f"(mixed, then 4 decode-only), greedy tokens (B, K) per step, "
          f"devstats and integer pool state equal; logits {err:.3g} apart "
          f"(tol {TOL['float32'][0]}); {evicted} pages evicted; launches "
          f"{launches}", flush=True)


def musicgen_full_width(torch, np, card):
    """musicgen-medium at full width (bf16, random weights from seed 0, all
    48 layers, a random conditioning (4, 64, 1536)): 4 prompts of 4
    codebooks x 2048 tokens one-shot under paged_eviction (page 16, budget
    512), MUSICGEN_STEPS greedy decode steps, once on a bf16 pool (K5, K1)
    and once on int8 (K5, K2), each beside the plain-kernel run of the same
    inputs for its first MUSICGEN_PLAIN_STEPS steps (a cut for the run
    time); then at MUSICGEN_CUT_LAYERS layers (the same weights) three
    forward_step calls (prompt chunks of 256, a mixed step, a decode-only
    step; K3, K1) and 2 AdamW steps at B 2 x 4 x S 1024, every layer's
    self- and cross-attention wq / wk / wv with a gradient, no kernel
    launched. Returns the launches of each run."""
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.core import devstats
    from repro_torch.models.multimodal import make_inputs
    from repro_torch.models.transformer import init_model
    from repro_torch.training import AdamWConfig, DataConfig, lm_batch
    from repro_torch.training.tree import map_leaves
    cfg = get_arch(MUSICGEN)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    gib = sum(nbytes(p) for p in _leaves(params)) / 2 ** 30
    print(f"  {MUSICGEN}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters ({gib:.2f} GiB), initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    Bm, S = 4, MUSICGEN_PROMPT
    inp = make_inputs(gen, cfg, Bm, S, "cuda")
    valid = torch.ones((Bm, S), dtype=torch.bool, device="cuda")
    budget, page, L = 512, 16, cfg.num_layers
    out = {}
    for kv_dtype in ("bfloat16", "int8"):
        ccfg = CacheConfig(page_size=page, cache_budget=budget,
                           policy="paged_eviction", dtype=kv_dtype)
        runs = {}
        for plain, steps in ((False, MUSICGEN_STEPS),
                             (True, MUSICGEN_PLAIN_STEPS)):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            runs[plain] = oneshot_run(torch, params, cfg, ccfg,
                                      inp["tokens"], valid, steps, plain,
                                      decode_splits=4, cond=inp["cond"])
            runs[plain] += (read_launches(),
                            torch.cuda.max_memory_allocated())
        toks, layers, live, stats, t_pre, t_dec, one, peak = runs[False]
        dec = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
        other = "paged_decode" if kv_dtype == "int8" else "paged_decode_int8"
        evicted = int(stats[:, devstats.PAGES_EVICTED].sum())
        if one["flash_attention"] != L or \
                one["flash_attention/tensor_core"] != L or not one[dec] or \
                one[other] or not evicted or int(live.max()) > budget + page:
            fail(f"{MUSICGEN} one-shot {kv_dtype}: not {L} flash launches on "
                 f"the tensor cores, {dec} launches, evictions and the "
                 f"budget: {one}, {evicted} pages evicted, "
                 f"{int(live.max())} live tokens")
        if any(runs[True][-2].values()):
            fail(f"{MUSICGEN} one-shot {kv_dtype}: the plain run launched "
                 f"{runs[True][-2]}")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or \
                toks.shape != (Bm, MUSICGEN_STEPS, cfg.num_codebooks):
            fail(f"{MUSICGEN} one-shot {kv_dtype}: tokens {toks.shape} "
                 f"outside the vocabulary or of the wrong shape")
        check_invariants(np, layers)
        plain_toks = runs[True][0]
        same = int((toks[:, :MUSICGEN_PLAIN_STEPS] == plain_toks).sum())
        print(f"  {MUSICGEN} one-shot {kv_dtype:8s} {Bm} x {cfg.num_codebooks}"
              f" x {S}: prefill {1e3 * t_pre:.1f} ms (plain "
              f"{1e3 * runs[True][4]:.1f}), mean decode step "
              f"{1e3 * t_dec / MUSICGEN_STEPS:.2f} ms (plain "
              f"{1e3 * runs[True][5] / MUSICGEN_PLAIN_STEPS:.2f}); peak "
              f"{peak / 2 ** 30:.2f} GiB; {evicted} pages evicted; greedy "
              f"tokens of the first {MUSICGEN_PLAIN_STEPS} steps equal to "
              f"the plain run's {same} of {plain_toks.size}; "
              f"launches {one}; {card}", flush=True)
        out[kv_dtype] = one
        del layers, runs
        torch.cuda.empty_cache()

    # forward_step and training at cut depth, on the same weights
    Lc = MUSICGEN_CUT_LAYERS
    cut = dataclasses.replace(cfg, num_layers=Lc)
    pc = {**params, "layers": params["layers"][:Lc]}
    ccfg = CacheConfig(page_size=page, cache_budget=budget,
                       policy="paged_eviction", dtype="bfloat16")
    reset_launches()
    run, cache = step_run(torch, pc, cut, ccfg, inp["tokens"][..., :512],
                          [256, 512, 256, 512], inp["cond"], 256, 1,
                          plain=False)
    step = read_launches()
    check_invariants(np, cache.layers)
    if not step["paged_decode"] or not step["paged_prefill"] or \
            step["paged_prefill/tensor_core"] != step["paged_prefill"] or \
            run["logits"][-1].shape != (Bm, cfg.num_codebooks,
                                        cfg.vocab_size):
        fail(f"{MUSICGEN} forward_step: K1 / K3 (tensor cores) not launched "
             f"or logits {run['logits'][-1].shape}: {step}")
    print(f"  {MUSICGEN} forward_step, {Lc} of {L} layers: prompt chunks, "
          f"mixed, decode-only {[f'{1e3 * x:.2f}' for x in run['s']]} ms; "
          f"logits {tuple(run['logits'][-1].shape)}; launches {step}; "
          f"{card}", flush=True)
    out["step"] = step
    del cache, run
    train = _require_grad(map_leaves(lambda t: t.detach().clone(), pc))
    del params, pc
    torch.cuda.empty_cache()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, batch_size=2,
                      seed=0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, _, losses, grads, walls, _ = train_run(
        torch, cut, train, AdamWConfig(lr_peak=1e-4, warmup_steps=1,
                                       total_steps=2),
        [lm_batch(dcfg, i, num_codebooks=cfg.num_codebooks)
         for i in range(2)], "cuda", cond=inp["cond"][:2])
    peak = torch.cuda.max_memory_allocated()
    _no_kernel_launched(f"{MUSICGEN} training")
    if not all(np.isfinite(losses)):
        fail(f"{MUSICGEN} training: losses {losses}")
    for i, lp in enumerate(grads["layers"]):
        for block in ("attn", "xattn"):
            for name in ("wq", "wk", "wv"):
                if not float(lp[block][name].abs().max()) > 0:
                    fail(f"{MUSICGEN} training: layer {i} {block} {name} "
                         f"has no gradient at step 1")
    print(f"  {MUSICGEN} training, {Lc} of {L} layers, B 2 x "
          f"{cfg.num_codebooks} x S 1024: losses "
          f"{[f'{x:.4f}' for x in losses]}; step times "
          f"{[f'{1e3 * w:.1f}' for w in walls]} ms; peak {peak / 2 ** 30:.2f}"
          f" GiB; every layer's attn and xattn wq / wk / wv with a gradient; "
          f"no kernel launched; {card}", flush=True)
    del train, grads
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13: tensor-parallel serving, two ranks time-sharing the card
# ---------------------------------------------------------------------------

TP = 2
TP_TIMEOUT_S = 180        # a collective that waits longer fails the run
# (a): the reduced families of phase 3, at reduced(tp=2) (per rank KV 1,
# G 2), served as phase 3 serves them; arch -> budget
TP_REDUCED = {"gemma3-27b": 128, "mixtral-8x7b": 48}
# (b): llama-3.1-8b at full width (32 / 8 heads, hd 128: KV 4, G 4 per
# rank), bf16, 4 of its 32 layers for the run time
TP_LLAMA = "llama-3.1-8b"
TP_LLAMA_LAYERS = 4
META = ("pos", "score", "block_table", "ref_count", "cur_page", "cur_off")
INT_META = ("pos", "block_table", "ref_count", "cur_page", "cur_off")


def tp_reduced_setup(np, arch):
    """(config, engine arguments, prompts) of phase 13 (a): phase 3's
    engine workload on ``arch``'s reduced(tp=2) config."""
    from repro_torch.configs import CacheConfig, get_arch
    cfg = get_arch(arch).reduced(tp=TP)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([shared if i % 2 else
                               rng.integers(0, cfg.vocab_size, 32),
                               rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(64, 128)))])
               .astype(np.int32) for i in range(8)]
    kw = lambda dt: dict(cache_cfg=CacheConfig(  # noqa: E731
        page_size=8, cache_budget=TP_REDUCED[arch], policy="paged_eviction",
        dtype=dt), max_batch=4, max_prompt_len=160, max_new_tokens=16,
        chunk_size=32, decode_splits=2)
    return cfg, kw, prompts


def tp_llama_setup(np):
    from repro_torch.configs import CacheConfig, get_arch
    cfg = dataclasses.replace(get_arch(TP_LLAMA), num_layers=TP_LLAMA_LAYERS)
    kw = dict(cache_cfg=CacheConfig(page_size=16, cache_budget=512,
                                    policy="paged_eviction",
                                    dtype="bfloat16"),
              max_batch=8, max_prompt_len=2048, max_new_tokens=16,
              chunk_size=256, decode_splits=4)
    return cfg, kw, serving_prompts(np, cfg.vocab_size, 8, 2048)


def tp_serve(torch, np, eng, prompts, new_tokens, group=None, kv=True):
    """Serve ``prompts`` through ``run_engine`` (devstats identities every
    step), recording after every step the pool metadata and, under TP, the
    step's collectives and whether it ran decode / prefill rows; F1-F4
    checked after every step. Returns the record, with the final pools'
    K/V when ``kv``."""
    from repro_torch.core import devstats
    from repro_torch.models.transformer import paged_layers
    from repro_torch.serving import engine as engine_mod
    flags, steps = [], []
    real = engine_mod.forward_step

    def spy(*args, **kw):
        flags.append((bool(kw["decode_mask"].any()),
                      bool(kw["prefill_mask"].any())))
        return real(*args, **kw)

    prev = {"coll": dict(group.counts) if group else {}, "ran": 0}

    def on_step(eng):
        check_invariants(np, eng.cache.layers)
        now = dict(group.counts) if group else {}
        ran = flags[-1] if len(flags) > prev["ran"] else None
        steps.append({
            "meta": [{f: getattr(c, f).cpu().numpy() for f in META}
                     for c in paged_layers(eng.cache.layers)],
            "coll": {k: v - prev["coll"].get(k, 0) for k, v in now.items()
                     if v - prev["coll"].get(k, 0)},
            "ran": ran,
            "stats": None if ran is None else eng.last_stats.copy()})
        prev.update(coll=now, ran=len(flags))

    engine_mod.forward_step = spy
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        tokens, _, wall, walls = run_engine(torch, np, devstats, eng,
                                            prompts, new_tokens, on_step)
    finally:
        engine_mod.forward_step = real
    s = eng.stats
    return {"tokens": tokens, "steps": steps, "launches": read_launches(),
            "wall": wall, "walls": walls, "tokens_generated":
            s.tokens_generated, "decode_steps": s.decode_steps,
            "prefill_s": s.prefill_s, "decode_s": s.decode_s,
            "pages_evicted": s.pages_evicted,
            "prefix_hits": s.shared_prefix_hits,
            "pool_bytes": eng.pool_bytes(), "fused": eng.fused_scores,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "kv": [{f: getattr(c, f).float().cpu().numpy()
                    if getattr(c, f).dtype == torch.bfloat16
                    else getattr(c, f).cpu().numpy()
                    for f in ("k", "v", "k_scale", "v_scale")
                    if getattr(c, f) is not None}
                   for c in paged_layers(eng.cache.layers)] if kv else None}


def tp_rank(group, reduced_cases):
    """One rank of phase 13: (a) every reduced case, then (b) llama; each
    engine built from the full weights of seed 0, drawn on this rank's
    device (tp 1's draws) and handed over on the host in (a), on the card
    in (b): the engine moves only its slice. The kernels' KV heads are
    recorded at every launch."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    seen = {}
    wrapped = {}
    for name in ("paged_attention_cuda", "paged_attention_int8_cuda",
                 "paged_prefill_cuda"):
        real = getattr(ops, name)

        def call(*args, _name=name, _real=real, **kw):
            seen.setdefault(_name, set()).add(int(args[1].shape[2]))
            return _real(*args, **kw)
        wrapped[name] = real
        setattr(ops, name, call)
    out = {}
    for arch, kv_dtype in reduced_cases:
        cfg, kw, prompts = tp_reduced_setup(np, arch)
        host = tree_map(lambda t: t.cpu(),
                        init_model(cfg, seed=0, device=group.device))
        eng = Engine(cfg, host, tp_group=group, **kw(kv_dtype))
        if any(t.device != group.device for t in tree_leaves(eng.params)):
            fail("the engine left weights off its rank's device")
        out[(arch, kv_dtype)] = tp_serve(torch, np, eng, prompts, 16, group)
        out[(arch, kv_dtype)]["kv_heads"] = {k: sorted(v)
                                             for k, v in seen.items()}
        seen.clear()
        del eng
    cfg, kw, prompts = tp_llama_setup(np)
    params = init_model(cfg, seed=0, device=group.device)
    eng = Engine(cfg, params, tp_group=group, **kw)
    del params
    torch.cuda.empty_cache()
    out["llama"] = tp_serve(torch, np, eng, prompts, 16, group, kv=False)
    out["llama"]["kv_heads"] = {k: sorted(v) for k, v in seen.items()}
    out["backend"] = torch.distributed.get_backend()
    for name, real in wrapped.items():
        setattr(ops, name, real)
    return out


def tp_compare(np, got, want, what, kv_dtype, tp_rank_no=None):
    """A tp run against the tp-1 run: tokens, per-step devstats and
    integer pool state equal, scores within 1e-6 (f32) or one int8 step
    relative (1/127: an element on a rounding boundary quantizes either
    way under tp's other summation order, and the next layers move by a
    fraction of that step); K/V, when ``tp_rank_no`` is given, within
    1e-5 of that rank's slice (int8: one step, scales 1/127 relative)."""
    if got["tokens"] != want["tokens"]:
        fail(f"{what}: greedy tokens differ from tp 1")
    if len(got["steps"]) != len(want["steps"]):
        fail(f"{what}: {len(got['steps'])} steps against tp 1's "
             f"{len(want['steps'])}")
    rtol, atol = (1 / 127, 0) if kv_dtype == "int8" else (0, 1e-6)
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        if (g["stats"] is None) != (w["stats"] is None) or (
                g["stats"] is not None and
                not np.array_equal(g["stats"], w["stats"])):
            fail(f"{what}: devstats differ at step {i}")
        for li, (gm, wm) in enumerate(zip(g["meta"], w["meta"])):
            for f in INT_META:
                if not np.array_equal(gm[f], wm[f]):
                    fail(f"{what}: step {i} layer {li} {f} differs from "
                         f"tp 1 (an eviction victim or the allocator)")
            if not np.allclose(gm["score"], wm["score"], rtol=rtol,
                               atol=atol):
                d = np.abs(gm["score"] - wm["score"])
                fail(f"{what}: step {i} layer {li} scores "
                     f"{np.nanmax(np.where(np.isfinite(d), d, 0)):.3g} "
                     f"apart")
    if tp_rank_no is None:
        return
    for li, (kv, kv1) in enumerate(zip(got["kv"], want["kv"])):
        for f, a in kv.items():
            n = kv1[f].shape[2] // TP
            ref = kv1[f][:, :, tp_rank_no * n:(tp_rank_no + 1) * n]
            if kv_dtype == "int8" and f in ("k", "v"):
                ok = np.abs(a.astype(np.int32) - ref.astype(np.int32)).max() \
                    <= 1
            elif kv_dtype == "int8":
                ok = np.allclose(a, ref, rtol=1 / 127, atol=0)
            else:
                ok = np.allclose(a, ref, rtol=0, atol=1e-5)
            if not ok:
                fail(f"{what}: rank {tp_rank_no} layer {li} {f} is not its "
                     f"slice of the tp-1 pool")


def tp_check_ranks(np, ranks, key, what):
    """The ranks' metadata equal after every step; returns rank 0's
    record."""
    r0 = ranks[0][key]
    for rank, r in enumerate(ranks):
        rec = r[key]
        if len(rec["steps"]) != len(r0["steps"]):
            fail(f"{what}: rank {rank} ran {len(rec['steps'])} steps, "
                 f"rank 0 {len(r0['steps'])}")
        for i, (g, w) in enumerate(zip(rec["steps"], r0["steps"])):
            for li, (gm, wm) in enumerate(zip(g["meta"], w["meta"])):
                for f in META:
                    if not np.array_equal(gm[f], wm[f]):
                        fail(f"{what}: rank {rank} step {i} layer {li} {f} "
                             f"differs from rank 0's")
    return r0


def tp_inventory(np, cfg, rec, what):
    """Each step's collectives against ``mesh.step_collectives``."""
    from collections import Counter

    from repro_torch.launch.mesh import step_collectives
    total = Counter()
    for i, s in enumerate(rec["steps"]):
        want = Counter() if s["ran"] is None else step_collectives(
            cfg, "paged_eviction", has_decode=s["ran"][0],
            has_prefill=s["ran"][1], fused_scores=rec["fused"], metrics=True)
        if Counter(s["coll"]) != want:
            fail(f"{what}: step {i} issued {s['coll']}, the inventory says "
                 f"{dict(want)}")
        total.update(s["coll"])
    return dict(total)


def tp_full(torch, np, card):
    """Phase 13: (a) the reduced gemma3 / mixtral at tp 2 against tp 1, f32
    and int8 pools; (b) llama-3.1-8b (4 of 32 layers, bf16) at tp 2, its
    greedy tokens beside a tp-1 run of the same weights. Both tp-1 runs
    here, the two ranks spawned once (gloo over the one card)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import Engine
    from datetime import timedelta
    cases = [(a, dt) for a in TP_REDUCED for dt in ("float32", "int8")]
    ref = {}
    for arch, kv_dtype in cases:
        cfg, kw, prompts = tp_reduced_setup(np, arch)
        eng = Engine(cfg, init_model(cfg, seed=0, device="cuda"),
                     device="cuda", **kw(kv_dtype))
        ref[(arch, kv_dtype)] = tp_serve(torch, np, eng, prompts, 16)
        del eng
    cfg8, kw8, prompts8 = tp_llama_setup(np)
    eng = Engine(cfg8, init_model(cfg8, seed=0, device="cuda"),
                 device="cuda", **kw8)
    ref["llama"] = tp_serve(torch, np, eng, prompts8, 16, kv=False)
    one = ref["llama"]
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP, cases, device="cuda",
                      timeout=timedelta(seconds=TP_TIMEOUT_S))
    spawn_s = time.perf_counter() - t0
    if [r["backend"] for r in ranks] != ["gloo"] * TP:
        fail(f"phase 13: two ranks on one card should take gloo, not "
             f"{[r['backend'] for r in ranks]}")
    for arch, kv_dtype in cases:
        what = f"phase 13 (a) {arch} reduced(tp=2) {kv_dtype}"
        r0 = tp_check_ranks(np, ranks, (arch, kv_dtype), what)
        for rank, r in enumerate(ranks):
            tp_compare(np, r[(arch, kv_dtype)], ref[(arch, kv_dtype)],
                       f"{what} rank {rank}", kv_dtype, rank)
        cfg = tp_reduced_setup(np, arch)[0]
        coll = tp_inventory(np, cfg, r0, what)
        dec = "paged_attention_int8_cuda" if kv_dtype == "int8" \
            else "paged_attention_cuda"
        heads = cfg.num_kv_heads // TP
        if r0["kv_heads"].get(dec) != [heads] or \
                r0["kv_heads"].get("paged_prefill_cuda") != [heads]:
            fail(f"{what}: the kernels did not launch at KV {heads}: "
                 f"{r0['kv_heads']}")
        print(f"  (a) {arch} {kv_dtype:8s}: {len(r0['steps'])} steps, "
              f"{r0['pages_evicted']} pages evicted, {r0['prefix_hits']} "
              f"prefix adoptions: tokens, devstats, victims and integer "
              f"pool state equal to tp 1 at every step, ranks' metadata "
              f"equal, K/V each rank's slice; kernels at KV {heads} "
              f"{r0['kv_heads']}; collectives {coll}", flush=True)
    what = f"phase 13 (b) {TP_LLAMA} tp 2"
    r0 = tp_check_ranks(np, ranks, "llama", what)
    coll = tp_inventory(np, cfg8, r0, what)
    heads = cfg8.num_kv_heads // TP
    for rank, r in enumerate(ranks):
        rec = r["llama"]
        lc = rec["launches"]
        if len(rec["tokens"]) != 8 or any(len(t) != 16 for t in
                                          rec["tokens"].values()):
            fail(f"{what}: rank {rank}: not every request finished with 16 "
                 f"tokens")
        if not lc["paged_decode"] or not lc["paged_prefill"] or \
                lc["paged_prefill/tensor_core"] != lc["paged_prefill"] or \
                rec["kv_heads"] != {"paged_attention_cuda": [heads],
                                    "paged_prefill_cuda": [heads]}:
            fail(f"{what}: rank {rank}: K1 / K3 (tensor cores) not launched "
                 f"at KV {heads}: {lc}, {rec['kv_heads']}")
        if not rec["pages_evicted"] or not rec["prefix_hits"]:
            fail(f"{what}: rank {rank}: no eviction or no prefix sharing")
        pb = rec["pool_bytes"]
        page = 2 * 16 * cfg8.num_kv_heads * cfg8.resolved_head_dim * 2 * \
            cfg8.num_layers
        if pb["devices"] != TP or \
                pb["per_device_max"] > pb["payload_total"] / TP + page:
            fail(f"{what}: rank {rank} holds {pb}")
    n_tok = sum(len(t) for t in one["tokens"].values())
    same = sum(a == b for rid, t in r0["tokens"].items()
               for a, b in zip(t, one["tokens"][rid]))
    mixed = len(r0["steps"]) - r0["decode_steps"]
    print(f"  (b) {TP_LLAMA} ({TP_LLAMA_LAYERS} of 32 layers, bf16), two "
          f"ranks time-sharing one card over gloo ({card}): "
          f"{r0['tokens_generated']} tokens in {r0['wall']:.2f} s "
          f"({r0['tokens_generated'] / r0['wall']:.1f} tok/s), mixed "
          f"{1e3 * r0['prefill_s'] / max(mixed, 1):.2f} ms, decode-only "
          f"{1e3 * r0['decode_s'] / max(r0['decode_steps'], 1):.2f} ms per "
          f"step ({mixed} / {r0['decode_steps']}); tp 1 on the card: "
          f"{one['tokens_generated'] / one['wall']:.1f} tok/s, mixed "
          f"{1e3 * one['prefill_s'] / max(len(one['steps']) - one['decode_steps'], 1):.2f} ms, "
          f"decode-only "
          f"{1e3 * one['decode_s'] / max(one['decode_steps'], 1):.2f} ms",
          flush=True)
    print(f"  (b) greedy tokens equal to tp 1: {same} of {n_tok} "
          f"({same / n_tok:.4f}); pages evicted {r0['pages_evicted']}, "
          f"prefix adoptions {r0['prefix_hits']}; payload per rank "
          f"{r0['pool_bytes']['per_device_max'] / 2 ** 20:.1f} of "
          f"{r0['pool_bytes']['payload_total'] / 2 ** 20:.1f} MiB; peak "
          f"memory per rank "
          f"{', '.join(f'{r['llama']['peak_gib']:.2f}' for r in ranks)} "
          f"GiB (tp 1 {one['peak_gib']:.2f}); K1 / K3 launches per rank "
          f"{r0['launches']['paged_decode']} / "
          f"{r0['launches']['paged_prefill']} at KV {heads}; collectives "
          f"{coll}; ranks spawned and run in {spawn_s:.1f} s", flush=True)
    return {"ranks": ranks, "ref": ref}


# ---------------------------------------------------------------------------
# phase 14: training over a grid, four ranks time-sharing the card
# ---------------------------------------------------------------------------

GRID = 4                  # ranks
GRID_TIMEOUT_S = 300      # a collective that waits longer fails the run
GRID_2D = ((2, 2), ("data", "model"))
GRID_EP = ((1, 2, 2), ("data", "expert", "tp"))
# (a): tests/test_torch_grid.py's four cases and jamba, reduced f32, B 4 x
# S 64, 2 AdamW steps; name -> (arch, reduced(tp=), grid, ZeRO-1). The
# MoE block's regions average aux per data shard (as JAX's do), so every
# case trains with aux weight 0 here: its step must then equal one rank's
GRID_REDUCED = {
    "llama-zero1": ("llama-3.2-1b", 1, GRID_2D, True),
    "kv-split": ("qwen2.5-3b", 2, GRID_2D, False),
    "mixtral-model": ("mixtral-8x7b", 1, GRID_2D, False),
    "mixtral-ep": ("mixtral-8x7b", 1, GRID_EP, False),
    "jamba": ("jamba-1.5-large-398b", 1, GRID_2D, False),
}
GRID_OPT = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10, eps=1e-5)
# (b), (c): a smaller step for random full-width weights (at 1e-3 every
# weight moves by about 6% of its scale a step and the loss climbs)
GRID_FULL_LR = 1e-4
# the CPU test's tolerances: losses (relative), parameters (absolute),
# moments (of their largest value)
GRID_RTOL, GRID_ATOL, GRID_MOMENT_RTOL = 1e-5, 1e-5, 1e-4
# (b), (c): full width, bf16, depth cut; (arch, layers, grid, B, S, steps,
# ZeRO-1). A bf16 step sums in another order on the grid: losses within
# GRID_BF16_RTOL of one rank's
GRID_FULL = {
    "b": ("llama-3.2-1b", 2, GRID_2D, 4, 2048, 3, True),
    "c": ("mixtral-8x7b", 1, GRID_EP, 2, 1024, 2, False),
}
GRID_BF16_RTOL = 1e-2
# (b), (c): Adam's update hardly sees the gradient's scale, so the
# gradient itself is held to one rank's at full width, in f32 (where the
# grid's equals one rank's to rounding): one step of the same model and
# first batch, every leaf's gradient norm and an even stride of at most
# GRID_SAMPLE elements of these leaves within GRID_F32_RTOL (relative,
# L2). A missing sum over an axis, a gradient counted twice or half a
# batch moves them by far more. In bf16 each step's grad norm is held
# within GRID_BF16_GNORM_RTOL: the tied embedding's bf16 gradient is a
# sum that mostly cancels at random init, its rounding noise some tens
# of percent of it on either side (one rank and the grid alike), which
# moves the total norm by about 1.5%
GRID_SAMPLE_KEYS = {
    "b": ("embed", "layers/0/attn/wq", "layers/1/mlp/w_down"),
    "c": ("embed", "layers/0/attn/wq", "layers/0/moe/w_down", "lm_head"),
}
GRID_SAMPLE = 1 << 22
GRID_F32_RTOL, GRID_BF16_GNORM_RTOL = 1e-4, 5e-2


def grid_batches(cfg, B, S, steps):
    from repro_torch.training import DataConfig, lm_batch
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      seed=0)
    return [lm_batch(dcfg, i) for i in range(steps)]


def grid_sample(torch, t):
    """An even stride of at most GRID_SAMPLE elements of a leaf's whole
    value (a collective on a grid), as a host f32 array."""
    from repro_torch.sharding import rules
    flat = rules.full(t).detach().reshape(-1)
    return flat[::-(-flat.numel() // GRID_SAMPLE)].float().cpu().numpy()


def grid_grads(torch, cfg, params, batch, keys, grid=None):
    """One f32 loss and gradient of ``params`` on ``batch`` (aux weight 0;
    on ``grid`` placed by the rules, ``ac`` pinning the layers): the
    loss, every leaf's gradient norm, and samples (:func:`grid_sample`)
    of the leaves named in ``keys``."""
    from repro_torch.sharding import rules
    from repro_torch.training import batch_to_device
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import key_of, leaves, leaves_with_path
    ac = None
    if grid is not None:
        params = rules.distribute(grid, params,
                                  rules.param_shardings(grid, cfg, params))
        ac = rules.activation_constraint(grid, batch["tokens"].shape[0])
    for p in leaves(params):
        p.requires_grad_(True)
    (loss, _), g = value_and_grad(params, cfg,
                                  batch_to_device(batch, "cuda", grid),
                                  aux_weight=0.0, ac=ac)
    named = [(key_of(p), t) for p, t in leaves_with_path(g)]
    return {"loss": float(rules.full(loss)),
            "norm": {k: float(rules.full(torch.linalg.vector_norm(t)))
                     for k, t in named},
            "sample": {k: grid_sample(torch, t) for k, t in named
                       if k in keys}}


def grid_train(torch, cfg, params, batches, *, grid=None, zero1=False,
               keep=True, lr=GRID_OPT["lr_peak"]):
    """AdamW steps (GRID_OPT, aux weight 0) of ``params`` (whole, on the
    card) over ``batches``, on ``grid`` when given (ZeRO-1 moments with
    ``zero1``; ``ac`` pinning the layers), each step timed and its
    collectives counted by kind (``CommDebugMode``). Returns losses, grad
    norms, step ms, collectives, this rank's parameter and moment bytes
    and peak memory, and with ``keep`` the final parameters and moments
    as host f32 arrays."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.sharding import rules
    from repro_torch.training import (AdamWConfig, batch_to_device,
                                      init_adamw, make_train_step)
    from repro_torch.training.tree import key_of, leaves, leaves_with_path
    ac = None
    B = batches[0]["tokens"].shape[0]
    if grid is not None:
        # the parameters placed first (DTensor ones stay as they are), the
        # moments made on their shards: no rank holds the whole f32 state
        p_sh = rules.param_shardings(grid, cfg, params)
        params = rules.distribute(grid, params, p_sh)
        opt = init_adamw(params)
        o_sh = rules.opt_shardings(grid, cfg, opt, p_sh, zero1=zero1)
        opt = opt._replace(mu=rules.distribute(grid, opt.mu, o_sh.mu),
                           nu=rules.distribute(grid, opt.nu, o_sh.nu))
        ac = rules.activation_constraint(grid, B)
    else:
        opt = init_adamw(params)
    torch.cuda.empty_cache()
    for p in leaves(params):
        p.requires_grad_(True)
    step = make_train_step(cfg, AdamWConfig(**{**GRID_OPT, "lr_peak": lr}),
                           aux_weight=0.0, ac=ac)
    local = lambda t: t.to_local() if grid is not None else t  # noqa: E731
    out = {"loss": [], "gnorm": [], "ms": [], "comm": [],
           "param_bytes": sum(local(t).nbytes for t in leaves(params)),
           "moment_bytes": sum(local(t).nbytes for t in
                               leaves(opt.mu) + leaves(opt.nu))}
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        batch = batch_to_device(b, "cuda", grid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mode = CommDebugMode()
        with mode:
            params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["comm"].append({str(k).split(".")[-1]: v for k, v in
                            mode.get_comm_counts().items()})
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if keep:
        out.update({n: {key_of(p): rules.full(t).detach().float().cpu()
                        .numpy() for p, t in leaves_with_path(tree)}
                    for n, tree in (("params", params), ("mu", opt.mu),
                                    ("nu", opt.nu))})
    return out


def grid_full_cfg(arch, layers, dtype=None):
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def grid_moe_check(torch, cfg, params, grid=None):
    """The full-width MoE block alone on one (2, 1024, D) bf16 input from
    seed 3: (out, load, dropped) as host arrays; on ``grid`` through the
    expert-parallel region (``ac``)."""
    from repro_torch.models.moe import moe_forward
    from repro_torch.sharding import rules
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((2, 1024, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    ac = None
    if grid is not None:
        ac = rules.activation_constraint(grid, 2)
        h = ac(h)
    with torch.no_grad():
        out, st = moe_forward(params["layers"][0]["moe"], cfg, h, ac=ac)
    return tuple(rules.full(t).float().cpu().numpy()
                 for t in (out, st.load, st.dropped))


def grid_rank(group):
    """One rank of phase 14: (a) every reduced case, (b) llama, (c)
    mixtral; rank 0 brings back (a)'s parameters and moments."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models.transformer import init_model
    from repro_torch.training.tree import map_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {g: make_grid(*g, device=group.device) for g in (GRID_2D,
                                                             GRID_EP)}
    out = {"backend": torch.distributed.get_backend()}
    t0 = time.perf_counter()

    def progress(what):
        if group.rank == 0:
            print(f"    rank 0: {what} at {time.perf_counter() - t0:.1f} s",
                  flush=True)
    for name, (arch, tp, g, zero1) in GRID_REDUCED.items():
        cfg = get_arch(arch).reduced(tp=tp)
        # every rank gathers the whole values (a collective); rank 0
        # brings them back
        out[name] = grid_train(torch, cfg, init_model(cfg, seed=0,
                                                      device="cuda"),
                               grid_batches(cfg, 4, 64, 2), grid=grids[g],
                               zero1=zero1)
        progress(f"(a) {name}")
    for key, (arch, layers, g, B, S, steps, zero1) in GRID_FULL.items():
        cfg32 = grid_full_cfg(arch, layers, "float32")
        out[key + "32"] = grid_grads(
            torch, cfg32, init_model(cfg32, seed=0, device="cuda"),
            grid_batches(cfg32, B, S, 1)[0], GRID_SAMPLE_KEYS[key],
            grids[g])
        torch.cuda.empty_cache()
        cfg = grid_full_cfg(arch, layers)
        # the one-rank draw, held on the host as train.py --mesh holds its
        # own: each leaf is cut there and only this rank's shard goes to
        # the card
        params = map_leaves(lambda t: t.cpu(),
                            init_model(cfg, seed=0, device="cuda"))
        torch.cuda.empty_cache()
        params = rules_distribute(grids[g], cfg, params)
        if cfg.num_experts:
            out["moe"] = grid_moe_check(torch, cfg, params, grids[g])
        out[key] = grid_train(torch, cfg, params, grid_batches(cfg, B, S,
                                                               steps),
                              grid=grids[g], zero1=zero1, keep=False,
                              lr=GRID_FULL_LR)
        del params
        torch.cuda.empty_cache()
        progress(f"({key}) {arch}")
    return out if group.rank == 0 else {
        k: ({kk: vv for kk, vv in v.items()
             if kk not in ("params", "mu", "nu", "sample")}
            if isinstance(v, dict) else v) for k, v in out.items()}


def rules_distribute(grid, cfg, params):
    from repro_torch.sharding import rules
    return rules.distribute(grid, params,
                            rules.param_shardings(grid, cfg, params))


def grid_full(torch, np, card):
    """Phase 14: the one-rank references on the card, then four ranks
    spawned once (gloo, sharing it) running (a)-(c)."""
    from datetime import timedelta

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import init_model
    ref = {}
    t_ref = time.perf_counter()
    for name, (arch, tp, _, _) in GRID_REDUCED.items():
        cfg = get_arch(arch).reduced(tp=tp)
        ref[name] = grid_train(torch, cfg, init_model(cfg, seed=0,
                                                      device="cuda"),
                               grid_batches(cfg, 4, 64, 2))
    for key, (arch, layers, _, B, S, steps, _) in GRID_FULL.items():
        cfg32 = grid_full_cfg(arch, layers, "float32")
        ref[key + "32"] = grid_grads(
            torch, cfg32, init_model(cfg32, seed=0, device="cuda"),
            grid_batches(cfg32, B, S, 1)[0], GRID_SAMPLE_KEYS[key])
        torch.cuda.empty_cache()
        cfg = grid_full_cfg(arch, layers)
        params = init_model(cfg, seed=0, device="cuda")
        if cfg.num_experts:
            ref["moe"] = grid_moe_check(torch, cfg, params)
        ref[key] = grid_train(torch, cfg, params, grid_batches(
            cfg, B, S, steps), keep=False, lr=GRID_FULL_LR)
        del params
        torch.cuda.empty_cache()
    print(f"  one-rank references done ({time.perf_counter() - t_ref:.1f} "
          f"s)", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks(grid_rank, GRID, device="cuda",
                      timeout=timedelta(seconds=GRID_TIMEOUT_S))
    spawn_s = time.perf_counter() - t0
    if [r["backend"] for r in ranks] != ["gloo"] * GRID:
        fail(f"phase 14: four ranks on one card should take gloo, not "
             f"{[r['backend'] for r in ranks]}")
    for name in GRID_REDUCED:
        what = f"phase 14 (a) {name}"
        want = ref[name]
        for rank, r in enumerate(ranks):
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(r[name]["loss"], want["loss"]))
            if rel > GRID_RTOL:
                fail(f"{what}: rank {rank} losses {r[name]['loss']}, one "
                     f"rank {want['loss']}")
        got = ranks[0][name]
        worst = {}
        for part in ("params", "mu", "nu"):
            top = max(float(np.abs(v).max()) for v in want[part].values())
            tol = GRID_ATOL if part == "params" else GRID_MOMENT_RTOL * top
            worst[part] = max(float(np.abs(got[part][k] - v).max())
                              for k, v in want[part].items())
            if worst[part] > tol:
                fail(f"{what}: {part} {worst[part]:.3g} from one rank's "
                     f"(tol {tol:.3g})")
        print(f"  (a) {name}: losses {[f'{x:.6f}' for x in got['loss']]} "
              f"(one rank {[f'{x:.6f}' for x in want['loss']]}), params "
              f"within {worst['params']:.3g}, mu {worst['mu']:.3g}, nu "
              f"{worst['nu']:.3g}; collectives per step "
              f"{got['comm'][-1]}", flush=True)
    for key, (arch, layers, (shape, axes), B, S, steps, zero1) in \
            GRID_FULL.items():
        what = f"phase 14 ({key}) {arch}"
        want = ref[key]
        rel, grel = 0.0, 0.0
        for rank, r in enumerate(ranks):
            rel = max([rel] + [abs(a - b) / abs(b) for a, b in
                               zip(r[key]["loss"], want["loss"])])
            grel = max([grel] + [abs(a - b) / abs(b) for a, b in
                                 zip(r[key]["gnorm"], want["gnorm"])])
            if rel > GRID_BF16_RTOL or grel > GRID_BF16_GNORM_RTOL:
                fail(f"{what}: rank {rank} losses {r[key]['loss']}, grad "
                     f"norms {r[key]['gnorm']}; one rank {want['loss']}, "
                     f"{want['gnorm']} ({rel:.3g}, {grel:.3g} relative)")
        g1, g = ref[key + "32"], ranks[0][key + "32"]
        f32 = {"loss": abs(g["loss"] - g1["loss"]) / abs(g1["loss"])}
        f32["norm"] = max(abs(g["norm"][k] - v) / v
                          for k, v in g1["norm"].items() if v > 0)
        f32.update({k: float(np.linalg.norm(g["sample"][k] - v) /
                             np.linalg.norm(v))
                    for k, v in g1["sample"].items()})
        if len(g["norm"]) != len(g1["norm"]) or \
                max(f32.values()) > GRID_F32_RTOL:
            fail(f"{what}: one f32 step's gradient against one rank's "
                 f"(relative; loss, worst leaf norm, samples): {f32}")
        mb = [r[key]["moment_bytes"] for r in ranks]
        if max(mb) > want["moment_bytes"] / GRID * 1.01:
            fail(f"{what}: moment bytes per rank {mb}, one rank "
                 f"{want['moment_bytes']}")
        r0 = ranks[0][key]
        f32_txt = {k: f"{v:.3g}" for k, v in f32.items()}
        print(f"  ({key}) {arch} ({layers} layers, bf16, B {B} x S {S}, "
              f"grid {dict(zip(axes, shape))}{', ZeRO-1' if zero1 else ''}"
              f", {steps} steps) on four ranks time-sharing the card over "
              f"gloo ({card}): losses {[f'{x:.4f}' for x in r0['loss']]} "
              f"(one rank {[f'{x:.4f}' for x in want['loss']]}, "
              f"{rel:.3g} relative, tol {GRID_BF16_RTOL}); grad norms "
              f"{[f'{x:.4f}' for x in r0['gnorm']]} (one rank "
              f"{[f'{x:.4f}' for x in want['gnorm']]}, {grel:.3g} "
              f"relative, tol {GRID_BF16_GNORM_RTOL}); one f32 step's "
              f"gradient relative to one rank's {f32_txt} (tol "
              f"{GRID_F32_RTOL}); step ms per rank "
              f"{[[round(x, 1) for x in r[key]['ms']] for r in ranks]}"
              f" (one rank {[round(x, 1) for x in want['ms']]}); "
              f"parameter bytes per rank "
              f"{[r[key]['param_bytes'] for r in ranks]} (one rank "
              f"{want['param_bytes']}); moment bytes per rank {mb} "
              f"(total / 4 {want['moment_bytes'] / GRID:.0f}); peak GiB "
              f"per rank {[round(r[key]['peak_gib'], 2) for r in ranks]} "
              f"(one rank {want['peak_gib']:.2f}); collectives per step "
              f"{r0['comm']}", flush=True)
    out, load, dropped = ranks[0]["moe"]
    o1, l1, d1 = ref["moe"]
    err = float(np.abs(out - o1).max())
    # a near-tie in the f32 router may round the other way on a shard's
    # rows: a few assignments of the 4096 (one is 1 / 4096 of the load)
    slack = 4 / (2 * 1024 * 2)
    dl, dd = float(np.abs(load - l1).max()), float(abs(dropped - d1))
    if dl > slack or dd > slack or err > 2 ** -7 * float(np.abs(o1).max()):
        fail(f"phase 14 (c): the expert-parallel block's load {load} / "
             f"dropped {dropped} / out (max err {err:.3g}) against one "
             f"rank's {l1} / {d1}")
    a2a = [c.get("all_to_all_single", 0) for c in ranks[0]["c"]["comm"]]
    if not all(a2a):
        fail(f"phase 14 (c): no all-to-all in a step: {ranks[0]['c']['comm']}")
    print(f"  (c) the MoE block alone, (2, 1024) tokens: load {load} "
          f"(one rank {l1}, max diff {dl:.3g}), dropped {float(dropped):.6f}"
          f" (one rank {float(d1):.6f}), out within {err:.3g}; all-to-alls "
          f"per step {a2a}; ranks spawned and run in {spawn_s:.1f} s",
          flush=True)
    return {"ranks": ranks, "ref": ref}


# ---------------------------------------------------------------------------
# phase 15: the examples, the sharded one-shot path, the dry run
# ---------------------------------------------------------------------------

# (a): each example at its defaults on the card -> the kernels it must
# launch (K5 flash_attention, K1 paged_decode, K3 paged_prefill)
EXAMPLES = {"quickstart": ("flash_attention", "paged_decode"),
            "long_context_decode": ("flash_attention", "paged_decode"),
            "eviction_comparison": (),
            "serve_batch": ("paged_prefill", "paged_decode"),
            "train_small": ("paged_prefill", "paged_decode")}
# (b): the one-shot path at (data 2, model 2), four gloo ranks sharing the
# card, against one rank: reduced f32 cases (name -> (arch, pool dtype)),
# B 4 right-padded prompts of SHARD_LENS tokens, SHARD_STEPS decode steps,
# each step's logits within SHARD_RTOL (relative to the largest) and the
# integer pool state after the prefill and every step bit-equal (which pins
# every victim)
SHARD_REDUCED = {"llama-f32": ("llama-3.2-1b", "float32"),
                 "mixtral": ("mixtral-8x7b", "float32"),
                 "jamba": ("jamba-1.5-large-398b", "float32"),
                 "llama-int8": ("llama-3.2-1b", "int8")}
SHARD_LENS, SHARD_STEPS, SHARD_RTOL = (96, 64, 80, 72), 8, 1e-5
# llama-3.2-1b at full width, bf16, 2 of 16 layers: B 4 x 2048-token
# prompts, page 16, budget 512 (the dry run's cache config: slabs in
# multiples of 16 pages), 16 decode steps of one rank's tokens; the logits
# within SHARD_BF16_RTOL of one rank's, relative to the largest (2.1x the
# largest reading, 0.0233, of chip call d2 in PERF.md)
SHARD_FULL = dict(layers=2, S=2048, steps=16, page=16, budget=512)
SHARD_BF16_RTOL = 5e-2
# past the first layer a bf16 score rounds differently on the grid and a
# near tie at the budget's edge may go the other way: the share of each
# row's kept positions that one rank keeps too, at least (a wrong row or
# head slice would keep an unrelated set)
SHARD_POS_SHARE = 0.9
SHARD_INT = ("block_table", "ref_count", "cur_page", "cur_off")
# (c): the dry runs on the host, each a subprocess: llama-3.2-1b at the
# four shapes on the (16, 16) grid, mixtral-8x7b train_4k expert-parallel
DRYRUN = [["--arch", "llama-3.2-1b", "--shape", s, "--mesh", "single"]
          for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
DRYRUN_EP = ["--arch", "mixtral-8x7b", "--shape", "train_4k", "--mesh",
             "single", "--layout", "ep"]
# the dry run of phase 14 (b)'s step on a fake (2, 2) group: its bytes and
# collectives against the measured ones, its peak within PEAK_RATIO; of
# (b)'s full-width decode step: its temp against the peak per rank
PEAK_RATIO = (0.5, 2.0)
DRYRUN_DECODE = """
import dataclasses, json, warnings
warnings.filterwarnings("ignore")
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_arch("llama-3.2-1b"), num_layers={layers})
shape = ShapeConfig("decode_32k", {seq}, {B}, "decode")
grid = dryrun.fake_grid((2, 2), ("data", "model"))
r = dryrun.run_one("llama-3.2-1b", "decode_32k", "single", "paged_eviction",
                   {budget}, {page}, False, None, grid=grid, cfg=cfg,
                   shape=shape)
print(json.dumps({{"memory": r["memory_analysis"],
                  "collectives": {{k: v[0] for k, v in
                                  r["collective_counts"].items()}}}}))
"""
DRYRUN_CROSS = """
import dataclasses, json, warnings
warnings.filterwarnings("ignore")
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import analysis, dryrun
cfg = dataclasses.replace(get_arch("llama-3.2-1b"), num_layers={layers})
shape = ShapeConfig("train_4k", {S}, {B}, "train")
grid = dryrun.fake_grid((2, 2), ("data", "model"))
_, args = dryrun.build_step("llama-3.2-1b", "train_4k", grid, "full", 4096,
                            16, True, cfg=cfg, shape=shape)
r = dryrun.run_one("llama-3.2-1b", "train_4k", "single", "full", 4096, 16,
                   True, None, grid=grid, cfg=cfg, shape=shape)
print(json.dumps({{"param_bytes": analysis.local_bytes(args[0]),
                  "moment_bytes": analysis.local_bytes(args[1].mu)
                  + analysis.local_bytes(args[1].nu),
                  "memory": r["memory_analysis"],
                  "collectives": {{k: v[0] for k, v in
                                  r["collective_counts"].items()}}}}))
"""
# CommDebugMode's names of the functional collectives -> the dry run's
COMM_NAMES = {"all_reduce": "all-reduce",
              "all_gather_into_tensor": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all"}


def examples_on_card(torch):
    """(a): the five examples at their defaults with ``--device cuda``,
    each one's result and kernel launches checked."""
    import importlib
    out = {}
    for name, kernels in EXAMPLES.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        reset_launches()
        t0 = time.perf_counter()
        r = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        what = f"phase 15 (a) {name}"
        if name == "quickstart":
            bad = [s["live"] for s in r["steps"]
                   if s["live"] > r["budget"] + r["page"]]
            if not r["finite"] or r["live_after_prefill"] > r["budget"] or \
                    bad or len(r["tokens"]) != 20:
                fail(f"{what}: {r['live_after_prefill']} live after the "
                     f"prefill, {bad} above budget + page, finite "
                     f"{r['finite']}")
            summary = (f"{r['live_after_prefill']} live after the prefill "
                       f"(budget {r['budget']}), {len(r['tokens'])} tokens")
        elif name == "long_context_decode":
            live = [c["live"] for c in r["checkpoints"]]
            if not r["finite"] or max(live) > r["budget"] + r["page"] or \
                    r["checkpoints"][-1]["position"] != 96 + 600:
                fail(f"{what}: live tokens {live}, {r['checkpoints']}")
            summary = (f"live tokens {live} at positions "
                       f"{[c['position'] for c in r['checkpoints']]}")
        elif name == "eviction_comparison":
            frag = {p: v["fragmented"] for p, v in r.items()}
            if frag["paged_eviction"] or frag["full"]:
                fail(f"{what}: fragmented pages {frag}")
            summary = f"fragmented pages {frag}"
        elif name == "serve_batch":
            if r["requests"] != 10 or set(r["generated"]) != {32} or \
                    r["max_live"] > r["budget"] + r["chunk"]:
                fail(f"{what}: {r}")
            summary = (f"{r['requests']} requests, {r['tokens']} tokens in "
                       f"{r['steps']} steps, max live {r['max_live']} "
                       f"(budget {r['budget']} + chunk {r['chunk']})")
        else:
            if not r["losses"][-1] < r["losses"][0] or \
                    not r["restored_equal"] or len(r["generated"]) != 16:
                fail(f"{what}: loss {r['losses'][0]} -> {r['losses'][-1]}, "
                     f"restored equal {r['restored_equal']}, generated "
                     f"{r['generated']}")
            summary = (f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} "
                       f"in {len(r['losses'])} steps, checkpoint restored "
                       f"equal, served 16 tokens")
        missing = [k for k in kernels if not launches[k]]
        if missing:
            fail(f"{what}: kernels not launched: {missing} ({launches})")
        used = {k: launches[k] for k in ("flash_attention", "paged_decode",
                                         "paged_prefill")}
        print(f"  (a) {name}: {summary}; launches {used}; {seconds:.1f} s",
              flush=True)
        out[name] = used
    return out


def shard_prompts(torch, vocab, S, lens):
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, vocab, (len(lens), S), generator=gen,
                           dtype=torch.int32).cuda()
    valid = torch.arange(S, device="cuda")[None, :] < torch.tensor(
        lens, device="cuda")[:, None]
    return tokens, valid


def shard_state(torch, cache):
    """The integer pool state of a one-shot cache (whole; a collective on a
    grid) as host arrays."""
    from repro_torch.core.paged_cache import PagedLayerCache
    from repro_torch.sharding import rules
    whole = rules.whole_cache(cache)
    out = {"cur_pos": whole.cur_pos.cpu().numpy()}
    for i, c in enumerate(whole.layers):
        if isinstance(c, PagedLayerCache):
            out.update({f"{i}/{n}": getattr(c, n).cpu().numpy()
                        for n in SHARD_INT})
            out[f"{i}/pos"] = c.pos.cpu().numpy()
    return out


def kept_share(np, got, want, key):
    """The least share, over rows, of the positions a row keeps in layer
    ``key``'s pool (``.../pos``) that one rank's keeps too; the block
    tables equal."""
    bt = want[key[:-len("pos")] + "block_table"]
    shares = []
    for row in bt:
        pages = row[row >= 0]
        a, b = got[key][pages].ravel(), want[key][pages].ravel()
        a = a[a >= 0]
        shares.append(float(np.isin(a, b[b >= 0]).mean()) if a.size else 1.0)
    return min(shares)


def shard_run(torch, cfg, ccfg, S, lens, steps, feed=None, grid=None,
              comm_step=None):
    """The one-shot prefill of ``lens``-token prompts and ``steps`` decode
    steps (on ``grid`` when given; ``feed``: the tokens to decode, default
    greedy) -> logits and states per step, the greedy tokens, kernel
    launches, this rank's pool payload bytes, and with ``comm_step`` the
    collectives of that decode step (CommDebugMode) and its peak bytes
    above those allocated before it, and the same peak of one more step
    through the kernels' plain versions (what the dry run counts)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.paged_cache import PagedLayerCache
    from repro_torch.core.policies import get_policy
    from repro_torch.models.transformer import (decode_step, forward_prefill,
                                                init_model)
    from repro_torch.sharding import rules
    params = init_model(cfg, seed=0, device="cuda")
    tokens, valid = shard_prompts(torch, cfg.vocab_size, S, lens)
    pol = get_policy(ccfg.policy)
    ac = None
    if grid is not None:
        params = rules.distribute(grid, params,
                                  rules.param_shardings(grid, cfg, params))
        ac = rules.activation_constraint(grid, len(lens))
    reset_launches()
    logits, cache = forward_prefill(params, cfg, tokens, pol, ccfg,
                                    valid=valid, total_seq_hint=S + steps,
                                    ac=ac)
    full = rules.full(logits)
    out = {"logits": [full.float().cpu().numpy()],
           "state": [shard_state(torch, cache)], "tokens": [], "comm": None}
    for i in range(steps):
        tok = torch.argmax(full, -1).to(torch.int32)
        out["tokens"].append(tok.cpu().numpy())
        if feed is not None:
            tok = torch.from_numpy(feed[i]).cuda()
        mode = CommDebugMode()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with mode:
            logits, cache = decode_step(params, cfg, tok, cache, pol, ccfg,
                                        ac=ac)
        if i == comm_step:
            torch.cuda.synchronize()
            out["step_peak"] = torch.cuda.max_memory_allocated() - base
            out["comm"] = {COMM_NAMES.get(str(k).split(".")[-1], str(k)): v
                           for k, v in mode.get_comm_counts().items()}
        full = rules.full(logits)
        out["logits"].append(full.float().cpu().numpy())
        out["state"].append(shard_state(torch, cache))
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    if comm_step is not None:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        decode_step(params, cfg, tok, cache, pol, ccfg, ac=ac,
                    plain_kernels=True)
        torch.cuda.synchronize()
        out["plain_step_peak"] = torch.cuda.max_memory_allocated() - base
    # the bytes this rank holds (a shard that views a larger buffer keeps
    # all of it); one rank's pool without its trash row
    local = (lambda t: t.to_local().untyped_storage().nbytes()) \
        if grid is not None else (lambda t: nbytes(t[:-1]))
    out["pages"] = sum(c.pos.shape[0] for c in rules.whole_cache(
        cache).layers if isinstance(c, PagedLayerCache))
    out["pool_bytes"] = sum(local(t) for c in cache.layers
                            if isinstance(c, PagedLayerCache)
                            for t in (c.k_buf, c.v_buf, c.k_scale_buf,
                                      c.v_scale_buf) if t is not None)
    return out


def shard_cfgs():
    """name -> (config, cache config, S, lens, steps) of phase 15 (b)."""
    from repro_torch.configs import CacheConfig, get_arch
    cases = {name: (get_arch(arch).reduced(),
                    CacheConfig(page_size=8, cache_budget=32, dtype=dt),
                    max(SHARD_LENS), SHARD_LENS, SHARD_STEPS)
             for name, (arch, dt) in SHARD_REDUCED.items()}
    from repro_torch.launch.dryrun import make_cache_cfg
    f = SHARD_FULL
    cases["llama-full"] = (
        dataclasses.replace(get_arch("llama-3.2-1b"), num_layers=f["layers"]),
        make_cache_cfg("paged_eviction", f["budget"], f["page"], "bfloat16"),
        f["S"], (f["S"],) * 4, f["steps"])
    return cases


def shard_rank(group, feeds):
    """One rank of phase 15 (b): every case at (data 2, model 2), decoding
    one rank's tokens."""
    import torch

    from repro_torch.launch.mesh import make_grid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid((2, 2), ("data", "model"), device=group.device)
    out = {"backend": torch.distributed.get_backend()}
    for name, (cfg, ccfg, S, lens, steps) in shard_cfgs().items():
        t0 = time.perf_counter()
        out[name] = shard_run(torch, cfg, ccfg, S, lens, steps,
                              feed=feeds.get(name), grid=grid, comm_step=1)
        out[name]["seconds"] = time.perf_counter() - t0
        if group.rank:
            out[name] = {k: v for k, v in out[name].items()
                         if k not in ("logits", "state")}
    return out


def shard_full(torch, np, card):
    """(b): the one-rank references, then four ranks spawned once."""
    from datetime import timedelta

    from repro_torch.launch.mesh import run_ranks
    ref = {}
    for name, (cfg, ccfg, S, lens, steps) in shard_cfgs().items():
        t0 = time.perf_counter()
        ref[name] = shard_run(torch, cfg, ccfg, S, lens, steps, comm_step=1)
        ref[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    feeds = {name: r["tokens"] for name, r in ref.items()}
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, GRID, feeds, device="cuda",
                      timeout=timedelta(seconds=GRID_TIMEOUT_S))
    spawn_s = time.perf_counter() - t0
    if [r["backend"] for r in ranks] != ["gloo"] * GRID:
        fail("phase 15 (b): four ranks on one card should take gloo")
    for name, (cfg, ccfg, S, lens, steps) in shard_cfgs().items():
        what = f"phase 15 (b) {name}"
        want, got = ref[name], ranks[0][name]
        kern = "paged_decode_int8" if ccfg.dtype == "int8" else "paged_decode"
        for rank, r in enumerate(ranks):
            lr = r[name]["launches"]
            if not lr["flash_attention"] or not lr[kern]:
                fail(f"{what}: rank {rank} launched {lr}")
            if cfg.dtype == "bfloat16" and \
                    lr["flash_attention/tensor_core"] != lr["flash_attention"]:
                fail(f"{what}: rank {rank} flash off the tensor cores: {lr}")
        per_rank = [r[name]["pool_bytes"] for r in ranks]
        row_page = want["pool_bytes"] // want["pages"] * len(lens)
        if max(per_rank) > want["pool_bytes"] / GRID + row_page:
            fail(f"{what}: pool payload per rank {per_rank}, one rank "
                 f"{want['pool_bytes']}")
        worst = max(float(np.abs(g - w).max() / np.abs(w).max())
                    for g, w in zip(got["logits"], want["logits"]))
        tol = SHARD_RTOL if name in SHARD_REDUCED else SHARD_BF16_RTOL
        if tol is not None and worst > tol:
            fail(f"{what}: logits {worst:.3g} from one rank's (tol {tol})")
        # in bf16 a score past the first layer rounds differently on the
        # grid, so the tokens those layers keep may differ: their share
        # equal to one rank's is held to SHARD_POS_SHARE
        loose = set() if name in SHARD_REDUCED else {
            k for k in want["state"][0] if k.endswith("/pos")
            and not k.startswith("0/")}
        for i, (g, w) in enumerate(zip(got["state"], want["state"])):
            bad = [k for k in w if k not in loose
                   and not np.array_equal(g[k], w[k])]
            if bad:
                fail(f"{what}: integer pool state after step {i} "
                     f"differs from one rank's: {bad}")
        kept = [min((kept_share(np, g, w, k) for k in loose), default=1.0)
                for g, w in zip(got["state"], want["state"])]
        if name not in SHARD_REDUCED and SHARD_POS_SHARE is not None and \
                min(kept) < SHARD_POS_SHARE:
            fail(f"{what}: kept positions equal to one rank's {kept}")
        if name in SHARD_REDUCED:
            print(f"  (b) {name}: logits within {worst:.3g} of one rank's "
                  f"(tol {SHARD_RTOL}), integer pool state equal after the "
                  f"prefill and each of {steps} steps; pool payload per "
                  f"rank {per_rank} (one rank {want['pool_bytes']}); "
                  f"collectives in a decode step {got['comm']}; "
                  f"{got['seconds']:.1f} s on rank 0", flush=True)
        else:
            per_step = [float(np.abs(g - w).max() / np.abs(w).max())
                        for g, w in zip(got["logits"], want["logits"])]
            print(f"  (b) {name} ({cfg.num_layers} layers, bf16, B "
                  f"{len(lens)} x S {S}, {steps} steps of one rank's "
                  f"tokens) on four ranks ({card}): logits within "
                  f"{worst:.4g} of one rank's, relative to the largest (tol "
                  f"{SHARD_BF16_RTOL}; prefill, then each step: "
                  f"{[f'{e:.3g}' for e in per_step]}), integer pool state "
                  f"equal after the prefill and each step but the kept "
                  f"positions past layer 0, whose share equal to one "
                  f"rank's is {min(kept):.4f} at least (tol "
                  f"{SHARD_POS_SHARE}; per step "
                  f"{[f'{k:.3f}' for k in kept]}); K5 / K5 on "
                  f"tensor cores / K1 per rank "
                  f"{[(r[name]['launches']['flash_attention'], r[name]['launches']['flash_attention/tensor_core'], r[name]['launches']['paged_decode']) for r in ranks]}; "
                  f"pool payload per rank {per_rank} (one rank "
                  f"{want['pool_bytes']}, total / 4 + a page per row "
                  f"{want['pool_bytes'] / GRID + row_page:.0f}); peak above "
                  f"the arguments in decode step 1 per rank "
                  f"{[r[name]['step_peak'] for r in ranks]} bytes (one rank "
                  f"{want['step_peak']}), in a step through the plain "
                  f"versions {[r[name]['plain_step_peak'] for r in ranks]} "
                  f"(one rank {want['plain_step_peak']}); collectives in a "
                  f"decode step "
                  f"{got['comm']}; prefill + decode {got['seconds']:.1f} s "
                  f"on rank 0 (one rank {want['seconds']:.1f} s)",
                  flush=True)
    print(f"  (b) ranks spawned and run in {spawn_s:.1f} s", flush=True)
    return {"ref": ref, "ranks": ranks}


class DryRuns:
    """(c): the dry runs, each a subprocess on the host (no card: its
    devices hidden), started at once in the background: the llama shapes
    one after another in a thread, the expert-parallel run and the
    cross-check beside them. ``stop`` ends whatever still runs."""

    def __init__(self, out_dir):
        import threading
        self.out_dir, self.procs, self.results = out_dir, [], {}
        self.env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        mod = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
               out_dir]
        _, layers, _, B, S, _, _ = GRID_FULL["b"]
        f = SHARD_FULL
        decode = DRYRUN_DECODE.format(layers=f["layers"],
                                      seq=f["S"] + f["steps"], B=4,
                                      budget=f["budget"], page=f["page"])
        self.threads = [threading.Thread(target=self._run, args=(name, cmd))
                        for name, cmd in [
                            ("ep", mod + DRYRUN_EP),
                            ("cross", [sys.executable, "-c",
                                       DRYRUN_CROSS.format(layers=layers,
                                                           S=S, B=B)]),
                            ("decode", [sys.executable, "-c", decode])]]
        self.threads.append(threading.Thread(target=lambda: [
            self._run(args[3], mod + args) for args in DRYRUN]))
        for t in self.threads:
            t.start()

    def _run(self, name, cmd):
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, env=self.env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             cwd=self.out_dir)
        self.procs.append(p)
        text, _ = p.communicate()
        self.results[name] = (p.returncode, text,
                              time.perf_counter() - t0)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def finish(self):
        for t in self.threads:
            t.join(timeout=900)
        self.stop()
        names = [a[3] for a in DRYRUN] + ["ep", "cross", "decode"]
        for name in names:
            if name not in self.results:
                fail(f"phase 15 (c) {name}: did not finish")
            rc, text, secs = self.results[name]
            if rc:
                fail(f"phase 15 (c) {name}: exit {rc}: {text[-3000:]}")
        return {n: self.results[n] for n in names}


def dryrun_check(dry: dict, grid14, shard, card):
    """(c): every roofline line printed with its wall seconds; the
    cross-checks against phase 14 (b)'s and 15 (b)'s measurements."""
    for name, (_, text, secs) in dry.items():
        for line in text.splitlines():
            if line.startswith("[dryrun]"):
                print(f"  (c) {line} (wall {secs:.1f} s)", flush=True)
    _, text, secs = dry["cross"]
    got = json.loads(text.strip().splitlines()[-1])
    r0 = grid14["ranks"][0]["b"]
    measured = {COMM_NAMES.get(k, k): v for k, v in r0["comm"][-1].items()}
    peak = (got["memory"]["argument_size_in_bytes"] +
            got["memory"]["temp_size_in_bytes"]) / 2 ** 30
    ratio = peak / r0["peak_gib"]
    print(f"  (c) the dry run of phase 14 (b)'s step (a fake (2, 2) group, "
          f"{secs:.1f} s) against its measurement ({card}): parameter bytes "
          f"per rank {got['param_bytes']} (measured {r0['param_bytes']}), "
          f"moment bytes {got['moment_bytes']} (measured "
          f"{r0['moment_bytes']}), collectives per step "
          f"{got['collectives']} (measured {measured}), predicted peak "
          f"{peak:.2f} GiB (arguments + temp) against the measured "
          f"{r0['peak_gib']:.2f} GiB: ratio {ratio:.3f}", flush=True)
    if got["param_bytes"] != r0["param_bytes"] or \
            got["moment_bytes"] != r0["moment_bytes"]:
        fail("phase 15 (c): the dry run's bytes per rank differ from phase "
             "14 (b)'s")
    if got["collectives"] != measured:
        fail(f"phase 15 (c): the dry run's collectives {got['collectives']} "
             f"differ from phase 14 (b)'s {measured}")
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        fail(f"phase 15 (c): predicted / measured peak {ratio:.3f} outside "
             f"{PEAK_RATIO}")
    _, text, secs = dry["decode"]
    got = json.loads(text.strip().splitlines()[-1])
    temp = got["memory"]["temp_size_in_bytes"]
    peaks = [r["llama-full"]["plain_step_peak"] for r in shard["ranks"]]
    ratios = [temp / p for p in peaks]
    measured = shard["ranks"][0]["llama-full"]["comm"]
    print(f"  (c) the dry run of phase 15 (b)'s full-width decode step (a "
          f"fake (2, 2) group, {secs:.1f} s; the kernels' plain versions) "
          f"against its measurement ({card}): temp per rank {temp} bytes "
          f"against the peak above the arguments of a step through the "
          f"plain versions {peaks}: ratios {[f'{x:.3f}' for x in ratios]} "
          f"(through the kernels "
          f"{[r['llama-full']['step_peak'] for r in shard['ranks']]}); "
          f"arguments {got['memory']['argument_size_in_bytes']} bytes; "
          f"collectives per step {got['collectives']} (measured "
          f"{measured})", flush=True)
    if not all(PEAK_RATIO[0] <= x <= PEAK_RATIO[1] for x in ratios):
        fail(f"phase 15 (c): predicted decode temp / measured peak "
             f"{ratios} outside {PEAK_RATIO}")
    return ratio


# ---------------------------------------------------------------------------
# phase 9: training, and the trained weights handed to serving and one-shot
# ---------------------------------------------------------------------------

# the in-repo eval model of benchmarks/accuracy.py:42-46 (TINY), copied
TINY = dict(name="tiny-recall", arch_type="dense",
            source="in-repo eval model", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512,
            vocab_size=64, norm="rmsnorm", act="silu", dtype="float32")
TRAIN_RTOL = 1e-4                    # losses, card against CPU
# the weights of each mixer that must get a gradient in 9a
MIXER_WEIGHTS = {"attn": ("wq", "wk", "wv"),
                 "mamba": ("in_proj", "x_proj", "dt_proj", "A_log"),
                 "mlstm": ("wq", "wk", "wv", "w_igate", "w_fgate"),
                 "slstm": ("w_gates", "r_z", "r_i", "r_f", "r_o")}
GRAD_TOL = (1e-5, 1e-4)              # step-1 gradients: atol, rtol
RECALL_GATE = 0.60                   # TINY, full cache at budget 32


def _leaves(tree):
    from repro_torch.training.tree import leaves
    return leaves(tree)


def _require_grad(params):
    for p in _leaves(params):
        p.requires_grad_(True)
    return params


def _no_kernel_launched(what):
    launched = {k: v for k, v in read_launches().items() if v}
    if launched:
        fail(f"{what}: kernels launched during training: {launched}")


def _checkpoint_round_trip(torch, tree, what):
    """save_checkpoint, then load_checkpoint into ``tree`` itself as the
    template: every leaf bit-equal (dtype, device, requires_grad kept).
    Returns (the restored tree, bytes on disk, save s, load s)."""
    from repro_torch.training import load_checkpoint, save_checkpoint
    with tempfile.TemporaryDirectory(prefix=".ckpt-", dir=ROOT) as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 1, tree)
        t1 = time.perf_counter()
        size = os.path.getsize(path)
        back = load_checkpoint(tmp, 1, tree)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    for a, b in zip(_leaves(back), _leaves(tree)):
        if isinstance(b, int):
            same = a == b
        else:
            same = (a.dtype == b.dtype and a.device == b.device and
                    a.requires_grad == b.requires_grad and
                    torch.equal(a.detach().view(torch.uint8),
                                b.detach().view(torch.uint8)))
        if not same:
            fail(f"{what}: the checkpoint did not restore bit for bit")
    return back, size, t1 - t0, t2 - t1


def train_run(torch, cfg, params, opt_cfg, batches, device, cond=None):
    """Train from ``params`` (leaves that require grad) on the numpy
    ``batches`` (under the conditioning ``cond`` when given), the first
    step by ``value_and_grad`` then
    ``adamw_update`` (the body of ``train_step``, so that its gradient is
    kept), the rest by ``make_train_step``. Returns (params, opt state,
    losses, step-1 gradients, wall seconds of each step, aux losses)."""
    from repro_torch.training import (adamw_update, batch_to_device,
                                      init_adamw, make_train_step,
                                      value_and_grad)
    step = make_train_step(cfg, opt_cfg)
    opt = init_adamw(params)
    losses, walls, auxes, grads = [], [], [], None
    for i, batch in enumerate(batches):
        batch = batch_to_device(batch, device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            (loss, parts), grads = value_and_grad(params, cfg, batch,
                                                  cond=cond)
            params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
            _require_grad(params)
        else:
            params, opt, parts = step(params, opt, batch, cond=cond)
            loss = parts["loss"]
        losses.append(float(loss))
        auxes.append(float(parts["aux"]))
        walls.append(time.perf_counter() - t0)
    return params, opt, losses, grads, walls, auxes


def train_parity(torch, np, arch="llama-3.2-1b", steps=4, seq=3072):
    """9a: reduced f32 ``arch``, one init on the card and its copy on the
    CPU, ``steps`` AdamW steps of lm_batch (B 1, S ``seq``; 3072 takes the
    blocked attention route) on each by :func:`train_run`; TF32 off
    (PyTorch's default for matmuls). The losses hold the MoE layers' aux
    term (0.01 aux), and the aux losses are held alike. A codebook model
    trains on (B, K, S) batches, a cross-attention one under one random
    conditioning, and its cross-attention weights must get a gradient
    too."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_model
    from repro_torch.training import AdamWConfig, DataConfig, lm_batch
    from repro_torch.training.tree import leaves_with_path, map_leaves
    if torch.backends.cuda.matmul.allow_tf32:
        fail("9a: TF32 is on for matmuls")
    cfg = get_arch(arch).reduced()
    card = _require_grad(init_model(cfg, seed=0, device="cuda"))
    host = _require_grad(map_leaves(lambda t: t.detach().cpu(), card))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=1,
                      seed=0)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=steps)
    cond = None
    if cfg.cross_attention:
        cond = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, cfg.cond_len, cfg.d_model)).astype(np.float32))
    out = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        reset_launches()
        batches = [lm_batch(dcfg, i, num_codebooks=cfg.num_codebooks)
                   for i in range(steps)]
        params, opt, losses, grads, _, aux = train_run(
            torch, cfg, params, opt_cfg, batches, dev,
            cond=None if cond is None else cond.to(dev))
        if dev == "cuda":
            _no_kernel_launched("9a")
        out[dev] = (losses, grads, params, opt, aux)
    (lk, gk, pk, ok, ak), (lc, gc, _, _, ac) = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lc))
    if rel > TRAIN_RTOL:
        fail(f"9a: losses on the card {lk} and on the CPU {lc}: {rel:.3g} "
             f"relative")
    rel_aux = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ak, ac)) \
        if any(ac) else 0.0
    if rel_aux > TRAIN_RTOL or (any(ak) != bool(cfg.num_experts)):
        fail(f"9a {arch}: aux losses on the card {ak} and on the CPU {ac}")
    atol, rtol = GRAD_TOL
    worst = 0.0
    for (path, a), b in zip(leaves_with_path(gk), _leaves(gc)):
        err = ((a.cpu() - b).abs() / (atol + rtol * b.abs())).max()
        worst = max(worst, float(err))
        if float(err) > 1:
            fail(f"9a: step-1 gradient {path} beyond atol {atol} + rtol "
                 f"{rtol}: {float(err):.3g} of the tolerance")
    for i, (lp, spec) in enumerate(zip(gk["layers"], cfg.layer_specs())):
        for block in (spec.mixer, "xattn"):
            for name in MIXER_WEIGHTS[spec.mixer] if block in lp else ():
                if not float(lp[block][name].abs().max()) > 0:
                    fail(f"9a: layer {i} {block} {name} has no gradient "
                         f"on the card")
    _, size, _, _ = _checkpoint_round_trip(torch, {"params": pk, "opt": ok},
                                           "9a")
    print(f"  9a reduced {arch} f32, B 1 x S {seq}, TF32 off: losses card "
          f"{[f'{x:.6f}' for x in lk]}, CPU {[f'{x:.6f}' for x in lc]} "
          f"({rel:.3g} relative, tol {TRAIN_RTOL}); aux {ak} ({rel_aux:.3g} "
          f"relative); step-1 gradients within {worst:.3g} of atol "
          f"{atol} + rtol {rtol}, every mixer's weights "
          f"({', '.join(sorted({s.mixer for s in cfg.layer_specs()}))}"
          f"{', xattn' if cfg.cross_attention else ''}) "
          f"nonzero in every layer; no kernel "
          f"launched; params + AdamW checkpoint ({size} bytes) restored bit "
          f"for bit", flush=True)


def train_full_width(torch, np):
    """9b: llama-3.2-1b at full width (bf16, random weights from seed 0;
    TRAIN_LAYERS of its 16 layers): 6 AdamW steps of lm_batch at B 2 x S
    4096 (the blocked route), lr 1e-4, warmup 2, by :func:`train_run`;
    then a params checkpoint restored bit for bit and 2 requests of 1024
    prompt tokens served from the restored weights (which require grad).
    Returns the serving launches."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_model
    from repro_torch.training import AdamWConfig, DataConfig, lm_batch
    cfg = dataclasses.replace(get_arch("llama-3.2-1b"),
                              num_layers=TRAIN_LAYERS)
    B, S, steps = 2, 4096, 6
    params = _require_grad(init_model(cfg, seed=0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                      seed=0)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, grads, walls, _ = train_run(
        torch, cfg, params, AdamWConfig(lr_peak=1e-4, warmup_steps=2,
                                        total_steps=steps),
        [lm_batch(dcfg, i) for i in range(steps)], "cuda")
    peak = torch.cuda.max_memory_allocated()
    for i, lp in enumerate(grads["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            if not float(lp["attn"][name].abs().max()) > 0:
                fail(f"9b: layer {i} {name} has no gradient at step 1")
    del grads
    _no_kernel_launched("9b")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"9b: losses {losses} not finite or not falling")
    med = float(np.median(walls[1:]))
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    flops = 6 * n_params * B * S + 12 * L * B * H * hd * S * S
    print(f"  9b llama-3.2-1b bf16, {L} of 16 layers, {n_params} parameters, "
          f"B {B} x S {S}: "
          f"losses {[f'{x:.4f}' for x in losses]}; step times "
          f"{[f'{1e3 * w:.1f}' for w in walls]} ms, median of steps 2-{steps} "
          f"{1e3 * med:.1f} ms, {B * S / med:.0f} tokens/s; peak memory "
          f"{peak} bytes ({peak / 2 ** 30:.2f} GiB); {flops:.4g} model FLOP "
          f"per step (6 N T + 12 L B H hd S^2), {flops / med / 1e12:.1f} "
          f"TFLOP/s, {100 * flops / med / PEAK_FLOPS['bfloat16']:.2f}% of "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f}; no kernel launched",
          flush=True)
    del opt
    torch.cuda.empty_cache()
    restored, size, t_save, t_load = _checkpoint_round_trip(
        torch, {"params": params}, "9b")
    del params
    torch.cuda.empty_cache()
    print(f"  9b params checkpoint: {size} bytes, saved in {t_save:.1f} s, "
          f"restored bit for bit in {t_load:.1f} s", flush=True)
    launches, eng, _, _ = serve_full_width(
        torch, np, "bfloat16", 2, new_tokens=8, max_batch=2,
        params=restored["params"], prompt_len=1024, num_layers=TRAIN_LAYERS)
    graph = [f for c in eng.cache.layers for f, t in vars(c).items()
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if graph or not all(p.requires_grad for p in _leaves(restored)):
        fail(f"9b: serving recorded a graph ({graph}) or the weights lost "
             f"requires_grad")
    return launches


def recall_accuracy(torch, params, cfg, dcfg, policy, budget, page=8,
                    n_batches=6, seed0=10_000):
    """benchmarks/accuracy.py:eval_policy on the port: each held-out batch's
    context prefilled under ``policy`` / ``budget`` (forward_prefill), then
    the 2-token query decoded (decode_step) and the answer scored."""
    from repro_torch.configs import CacheConfig
    from repro_torch.core.policies import get_policy
    from repro_torch.models.transformer import decode_step, forward_prefill
    from repro_torch.training import recall_batch
    pol = get_policy(policy)
    ccfg = CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                       dtype="float32")
    S = dcfg.seq_len
    correct = total = 0
    for i in range(n_batches):
        b = recall_batch(dcfg, seed0 + i)
        tok = torch.from_numpy(b["tokens"]).cuda()
        lg, cache = forward_prefill(params, cfg, tok[:, :S - 2], pol, ccfg,
                                    total_seq_hint=S + 2)
        lg, cache = decode_step(params, cfg, tok[:, S - 2], cache, pol, ccfg)
        lg, cache = decode_step(params, cfg, tok[:, S - 1], cache, pol, ccfg)
        pred = lg.argmax(-1).cpu().numpy()
        correct += int((pred == b["answers"]).sum())
        total += len(pred)
    return correct / total


def train_recall(torch, np):
    """9c: TINY trained on the card by accuracy.py's recipe (recall_batch
    steps 0-899, seq 32, batch 32, lr 3e-3, warmup 50, 2 pairs, key space
    8), then scored on 6 held-out batches: full at budget 32 (gated),
    paged_eviction and streaming_llm at budgets 16 and 8 (page 8)."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      batch_to_device, init_adamw,
                                      make_train_step, recall_batch)
    cfg = ModelConfig(**TINY)
    steps = 900
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=32,
                      seed=0, num_pairs=2, key_space=8)
    params = _require_grad(init_model(cfg, seed=0, device="cuda"))
    opt = init_adamw(params)
    step = make_train_step(cfg, AdamWConfig(lr_peak=3e-3, warmup_steps=50,
                                            total_steps=steps))
    reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        params, opt, m = step(params, opt,
                              batch_to_device(recall_batch(dcfg, i), "cuda"))
        if i == 0:
            first = float(m["loss"])
    loss = float(m["loss"])
    t_train = time.perf_counter() - t0
    _no_kernel_launched("9c")
    if not np.isfinite(loss) or not loss < first:
        fail(f"9c: training loss {first} -> {loss}")
    reset_launches()
    t0 = time.perf_counter()
    acc = {("full", 32): recall_accuracy(torch, params, cfg, dcfg, "full",
                                         32)}
    for budget in (16, 8):
        for policy in ("paged_eviction", "streaming_llm"):
            acc[(policy, budget)] = recall_accuracy(torch, params, cfg, dcfg,
                                                    policy, budget)
    t_eval = time.perf_counter() - t0
    launches = read_launches()
    if not launches["paged_decode"] or not launches["flash_attention"] or \
            launches["flash_attention/cuda_core"] != \
            launches["flash_attention"]:
        fail(f"9c: the one-shot path did not run K5 on the f32 CUDA-core "
             f"route and K1: {launches}")
    print(f"  9c TINY (f32, 2 layers, d 128, hd 32) trained {steps} steps "
          f"in {t_train:.1f} s ({1e3 * t_train / steps:.2f} ms/step): loss "
          f"{first:.4f} -> {loss:.4f}; recall accuracy on 192 held-out "
          f"prompts: " + ", ".join(f"{p} @ {b} {a:.4f}"
                                   for (p, b), a in acc.items()) +
          f" ({t_eval:.1f} s); launches {launches}", flush=True)
    if acc[("full", 32)] < RECALL_GATE:
        fail(f"9c: full-cache recall accuracy {acc[('full', 32)]:.4f} below "
             f"{RECALL_GATE}")


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
    print(f"[1/15] build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry func")):
                print(f"  {name}: {line.strip()}", flush=True)

    def phase(title):
        print(f"{title} (at {time.perf_counter() - t_start:.0f} s)",
              flush=True)

    phase("[2/15] kernels against their plain versions")
    reset_launches()
    worst = check_kernels(torch)
    checked = read_launches()
    timing = time_kernels(torch, F)
    other_hd = {shape[2]: time_kernels(torch, F, shape, dname, full=False)
                for shape, dname in NEW_HD_SHAPES.values()}
    other_shapes = {label: time_kernels(torch, F, shape, full=False)
                    for label, (shape, _, _) in FAMILY_SHAPES.items()}

    phase("[3/15] kernels vs plain versions: engine (with trace, lineage and "
          "timeline; probes on and off) and one-shot, float and int8 pools, "
          "every policy that evicts")
    for policy in ("paged_eviction",) + BASELINES:
        for kv_dtype in ("float32", "int8"):
            engine_parity(torch, np, kv_dtype, policy)
        for kv_dtype in ("float32", "int8"):
            oneshot_parity(torch, np, kv_dtype, policy=policy)
    # a ragged prompt above 2048 tokens: the flash kernel on the card
    oneshot_parity(torch, np, "float32", S=3000)
    # the windowed families, reduced (window 64), served and one-shot:
    # gemma3 at a budget above the window (the window bounds its local
    # layers), mixtral below it (the budget binds); 2 AdamW steps each card
    # against CPU
    # and the recurrent ones, jamba (budget 48: its attention layer
    # evicts) and xlstm (no attention layer)
    for arch, budget in (("gemma3-27b", 128), ("mixtral-8x7b", 48),
                         ("jamba-1.5-large-398b", 48), ("xlstm-1.3b", 48)):
        engine_parity(torch, np, "float32", arch=arch, budget=budget)
        oneshot_parity(torch, np, "float32", arch=arch, budget=budget)
        train_parity(torch, np, arch=arch, steps=2, seq=1024)
    # musicgen, which the engine refuses (codebooks): forward_step with
    # cross caches, one-shot, training
    musicgen_step_parity(torch, np)
    oneshot_parity(torch, np, "float32", arch=MUSICGEN, budget=48)
    train_parity(torch, np, arch=MUSICGEN, steps=2, seq=1024)

    phase(f"[4/15] llama-3.2-1b at full width: serving, bf16 pool, with "
          f"metrics, trace, timeline and lineage ledger ({SERVE_LAYERS} "
          f"layers)")
    serve = serve_observed(torch, np)
    torch.cuda.empty_cache()

    phase("[5/15] llama-3.2-1b at full width: one-shot, bf16 and int8 pools")
    oneshot = oneshot_full_width(torch, np)
    torch.cuda.empty_cache()

    phase(f"[6/15] llama-3.2-1b at full width: serving, int8 pool "
          f"({INT8_SERVE_LAYERS} layers)")
    serve8 = serve_full_width(torch, np, "int8", 4,
                              num_layers=INT8_SERVE_LAYERS)[0]
    torch.cuda.empty_cache()

    phase(f"[7/15] llama-3.2-1b at full width: the paper's baselines "
          f"({BASELINE_LAYERS} layers)")
    baselines_full_width(torch, np)
    torch.cuda.empty_cache()

    phase(f"[8/15] llama-3.2-1b at full width: eviction-regret probes "
          f"({REGRET_LAYERS} layers)")
    regret_full_width(torch, np)
    torch.cuda.empty_cache()

    phase("[9/15] training: card against CPU, llama-3.2-1b at full width "
          "then served from its checkpoint, TINY trained and scored")
    t9 = time.perf_counter()
    train_parity(torch, np)
    train_full_width(torch, np)
    torch.cuda.empty_cache()
    train_recall(torch, np)
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
    torch.cuda.empty_cache()

    phase("[10/15] the attention-only families at full width: "
          + ", ".join(f"{a} ({n} layers, budget {b})"
                      for a, (n, b) in FAMILIES.items()))
    t10 = time.perf_counter()
    families = families_full_width(torch, np)
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s; K1 / K3 / K5 "
          f"launches by family: " + "; ".join(
              f"{a} {r['serving']['paged_decode']} / "
              f"{r['serving']['paged_prefill']} / "
              f"{r['one_shot']['flash_attention']} (one-shot K1 "
              f"{r['one_shot']['paged_decode']})"
              for a, r in families.items()), flush=True)
    torch.cuda.empty_cache()

    phase("[11/15] the recurrent families at full width: "
          + ", ".join(f"{a} ({n} layers)" for a, n in RECURRENT.items()))
    t11 = time.perf_counter()
    recurrent = {arch: recurrent_full_width(torch, np, arch, n, card)
                 for arch, n in RECURRENT.items()}
    jamba = recurrent["jamba-1.5-large-398b"]
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s; jamba K1 / K3 "
          f"served {jamba['serving']['paged_decode']} / "
          f"{jamba['serving']['paged_prefill']}, K5 / K1 one-shot "
          f"{jamba['one_shot']['flash_attention']} / "
          f"{jamba['one_shot']['paged_decode']}; {card}", flush=True)
    torch.cuda.empty_cache()

    phase(f"[12/15] {MUSICGEN} at full width: one-shot (48 layers, bf16 and "
          f"int8 pools), forward_step and training ({MUSICGEN_CUT_LAYERS} "
          f"layers)")
    t12 = time.perf_counter()
    music = musicgen_full_width(torch, np, card)
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s; one-shot K5 / K1 "
          f"/ K2 {music['bfloat16']['flash_attention']} / "
          f"{music['bfloat16']['paged_decode']} / "
          f"{music['int8']['paged_decode_int8']}, forward_step K3 / K1 "
          f"{music['step']['paged_prefill']} / "
          f"{music['step']['paged_decode']}; {card}", flush=True)
    torch.cuda.empty_cache()

    phase(f"[13/15] tensor-parallel serving at tp {TP}, two ranks "
          f"time-sharing the card over gloo: "
          + ", ".join(f"{a} reduced(tp=2)" for a in TP_REDUCED)
          + f" (f32, int8) against tp 1; {TP_LLAMA} ({TP_LLAMA_LAYERS} of 32 "
          f"layers, bf16)")
    t13 = time.perf_counter()
    tp_full(torch, np, card)
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s; {card}",
          flush=True)
    torch.cuda.empty_cache()

    phase(f"[14/15] training over a grid, {GRID} gloo ranks time-sharing "
          f"the card: (a) " + ", ".join(GRID_REDUCED) + " reduced f32 "
          f"against one rank; (b) {GRID_FULL['b'][0]} at (data 2, model 2) "
          f"with ZeRO-1, (c) {GRID_FULL['c'][0]} expert-parallel at (data "
          f"1, expert 2, tp 2), full width, bf16")
    t14 = time.perf_counter()
    grid14 = grid_full(torch, np, card)
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s; {card}",
          flush=True)
    torch.cuda.empty_cache()

    phase("[15/15] the examples on the card; the one-shot path at (data 2, "
          "model 2), four gloo ranks sharing the card: "
          + ", ".join(SHARD_REDUCED) + " reduced against one rank, "
          f"llama-3.2-1b ({SHARD_FULL['layers']} layers, bf16); the dry run "
          f"on the host")
    t15 = time.perf_counter()
    with tempfile.TemporaryDirectory() as dry_dir:
        dry = DryRuns(dry_dir)
        try:
            examples_on_card(torch)
            torch.cuda.empty_cache()
            shard = shard_full(torch, np, card)
            torch.cuda.empty_cache()
            results = dry.finish()
        finally:
            dry.stop()
    dryrun_check(results, grid14, shard, card)
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s; {card}",
          flush=True)

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
                         for hd, t in other_hd.items()},
                     "other_shapes": {
                         label: {"device_ms": t[name]["device_ms"],
                                 "bound_ms": t[name]["bound"][0],
                                 "bound_by": t[name]["bound"][1]}
                         for label, t in other_shapes.items()}})
    print(f"done in {time.perf_counter() - t_start:.0f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
