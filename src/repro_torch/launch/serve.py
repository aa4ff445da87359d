"""Serving driver of the torch port: continuous batching under an eviction
policy, on the GPU by default.

    python -m repro_torch.launch.serve --arch llama-3.2-1b --policy \
        paged_eviction --budget 512 --page 16 --requests 16 --max-batch 8 \
        --prompt-len 2048 --new-tokens 32 --chunk 256 --decode-splits 4

``--policy`` takes any registered policy (paged_eviction, full, and the
paper's baselines streaming_llm, inverse_key_l2 and keydiff) and refuses
other names, and a codebook model (musicgen), as the JAX package's
driver does. ``--reduced`` serves the family's tiny CPU-sized variant;
``--device cpu`` runs the kernels' plain torch versions on the CPU.
``--profile START:COUNT`` (repeatable) traces steps START .. START+COUNT-1
with ``torch.profiler`` and prints each window's device time by kernel and
the device's busy share (the host regions ``engine.plan`` and
``engine.step`` and the program's spans show in its table).

Observability (``repro_torch.obs``): the metrics dashboard (TTFT, TPOT, ITL,
queue, plan and step histograms; pool counters) is printed after the run
unless ``--no-metrics``; ``--trace FILE`` writes one JSONL record per step
(schema v2; validate with ``python -m repro_torch.obs.trace FILE``),
``--timeline FILE`` a Perfetto timeline of per-request spans, ``--lineage``
keeps the page-lineage ledger (reconciled after the run), ``--regret-every
N`` runs the eviction-regret shadow probes, ``--snapshot FILE`` writes the
final metrics as JSON:

    python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \
        --device cpu --trace t.jsonl --timeline tl.json --lineage \
        --regret-every 4 --snapshot s.json

Tensor parallelism (``--tp N``, as the JAX launcher's): N ranks, each serving
its KV/N heads and weight slices with the same scheduler
(``Engine(tp_group=)``);
spawned here (``torch.multiprocessing``, a ``FileStore`` rendezvous), or
joined under ``torchrun`` (``WORLD_SIZE`` set); over NCCL with one GPU
per rank, else gloo (``launch.mesh.make_tp_group``). Each rank builds the
weights on the host and moves its slice to its device. ``--reduced`` then
serves ``cfg.reduced(tp=N)``. Rank 0 alone prints and writes files; it also
prints the pool payload per device:

    python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced --tp 2 \
        --device cpu"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.core.paged_cache import lineage_snapshot_host
from repro_torch.core.policies import POLICIES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_tp_group, run_ranks
from repro_torch.models.transformer import init_model, paged_layers
from repro_torch.obs import ObsConfig
from repro_torch.serving import Engine, SamplingParams


def device_busy_us(events) -> tuple[float, float]:
    """(union, sum) in microseconds of the device's own activity intervals
    (kernels, copies, sets) among profiler ``events``. The union is the
    time the device was busy; the sum exceeds it only where work overlaps.
    CPU-side ops are left out: they carry their kernels' time again."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, sum(e - s for s, e in spans)


def profile_steps(eng: Engine, start: int, count: int) -> bool:
    """Run ``count`` engine steps under ``torch.profiler``; print the
    device time by kernel and the share of the window the device was busy.
    Returns whether work remains."""
    from torch.profiler import ProfilerActivity, profile
    cuda = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kinds = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            prefill_s = eng.stats.prefill_s
            more = eng.step()
            kinds.append("mixed" if eng.stats.prefill_s > prefill_s
                         else "decode")
            if not more:
                break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernel_us = device_busy_us(prof.events())
    events = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(f"profile: steps {start}..{start + len(kinds) - 1} ({kinds}), "
          f"wall {wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e6 / wall:.1f}%; device activities sum "
          f"{kernel_us / 1e3:.1f} ms), "
          f"{sum(e.count for e in events if e.key.startswith('aten::'))} "
          f"aten ops")
    print(events.table(sort_by=key, row_limit=15))
    return more


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="paged_eviction",
                    choices=sorted(POLICIES))
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--page", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=64,
                    help="prefill chunk size (tokens/step/request)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max tokens per unified step (default "
                         "max_batch + chunk)")
    ap.add_argument("--decode-splits", type=int, default=1,
                    help="split-K factor of the decode kernel's page walk")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prefix sharing across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request this many common leading "
                         "prompt tokens (exercises prefix sharing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="append", default=[],
                    metavar="START:COUNT",
                    help="trace steps START..START+COUNT-1 (repeatable)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a per-step JSONL trace here")
    ap.add_argument("--timeline", default=None, metavar="FILE",
                    help="write a Chrome-trace/Perfetto JSON timeline of "
                         "per-request spans here (load in chrome://tracing "
                         "or ui.perfetto.dev)")
    ap.add_argument("--lineage", action="store_true",
                    help="keep a host-side page-lineage ledger (emits v2 "
                         "'event' records into --trace and prints a "
                         "reconciliation + per-request loss summary)")
    ap.add_argument("--regret-every", type=int, default=0, metavar="N",
                    help="probe eviction regret every N decode steps per "
                         "request against an uncompressed shadow cache "
                         "(0 = off; emits v2 'probe' records into --trace)")
    ap.add_argument("--snapshot", default=None, metavar="FILE",
                    help="write the final metrics snapshot (JSON) here")
    ap.add_argument("--no-metrics", action="store_true",
                    help="disable all engine instrumentation: bare caches, "
                         "no stats vector and no per-step read of it")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="tensor-parallel degree: N ranks, KV-head-sharded "
                         "pools and kernels, replicated scheduler")
    args = ap.parse_args()
    if args.tp == 1:
        serve(None, args)
    elif "WORLD_SIZE" in os.environ:          # under torchrun
        serve(make_tp_group(args.tp, device=args.device), args)
        torch.distributed.destroy_process_group()
    else:
        run_ranks(serve, args.tp, args, device=args.device)


def serve(group, args) -> None:
    """Serve the synthetic requests of ``args`` (the parsed command line);
    ``group``: this rank's ``TPGroup`` under ``--tp``, else None."""
    rank0 = group is None or group.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    device = resolve_device(args.device) if group is None else group.device
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(tp=args.tp)
    if cfg.num_codebooks > 1:
        raise SystemExit("serve driver targets text archs; run a codebook "
                         "model one-shot (transformer.forward_prefill, "
                         "decode_step) or through forward_step")
    # under --tp the full weights stay on the host: the engine moves this
    # rank's slice to its device
    params = init_model(cfg, seed=args.seed,
                        device=device if group is None else "cpu")
    ccfg = CacheConfig(page_size=args.page, cache_budget=args.budget,
                       policy=args.policy,
                       dtype="float32" if args.reduced else "bfloat16")
    eng = Engine(cfg, params, cache_cfg=ccfg, max_batch=args.max_batch,
                 max_prompt_len=args.prompt_len,
                 max_new_tokens=args.new_tokens,
                 sampling=SamplingParams(greedy=True),
                 chunk_size=args.chunk, token_budget=args.token_budget,
                 prefix_sharing=not args.no_prefix_sharing,
                 decode_splits=args.decode_splits, device=device,
                 obs=ObsConfig(metrics=not args.no_metrics,
                               trace_path=args.trace,
                               timeline=args.timeline is not None,
                               lineage=args.lineage,
                               regret_every=args.regret_every),
                 tp_group=group)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size,
                          size=min(args.shared_prefix, args.prompt_len - 1))
    for _ in range(args.requests):
        n = int(rng.integers(args.prompt_len // 2, args.prompt_len))
        tail = rng.integers(0, cfg.vocab_size, size=max(n - len(shared), 1))
        eng.submit(np.concatenate([shared, tail]).astype(np.int32))
    windows = {}
    for w in args.profile:
        start, count = (int(x) for x in w.split(":"))
        windows[start] = count
    t0 = time.perf_counter()
    step = 0
    with eng:                   # closing flushes the trace, on error too
        while True:
            if step in windows and rank0:
                more = profile_steps(eng, step, windows[step])
                step += windows[step]
            elif step in windows:             # other ranks keep in step
                for _ in range(windows[step]):
                    more = eng.step()
                    if not more:
                        break
                step += windows[step]
            else:
                more = eng.step()
                step += 1
            if not more:
                break
    done = eng.scheduler.finished
    dt = time.perf_counter() - t0
    s = eng.stats
    say(f"device={device} policy={args.policy} budget={args.budget} "
        f"page={args.page}")
    say(f"finished {len(done)} requests, {s.tokens_generated} tokens "
        f"in {dt:.2f}s ({s.tokens_generated / dt:.1f} tok/s)")
    say(f"decode-only throughput: {s.decode_tok_per_s:.1f} tok/s; "
        f"steps={s.steps}; programs={eng.num_compiled_programs()}")
    say(f"evicted pages={s.pages_evicted} tokens={s.tokens_evicted} "
        f"forced={s.forced_evictions}")
    if args.tp > 1:
        pb = eng.pool_bytes()
        say(f"tp={args.tp}: pool payload {pb['payload_total'] / 1e6:.2f} MB"
            f" total, {pb['per_device_max'] / 1e6:.2f} MB max/device "
            f"across {pb['devices']} devices")
    if s.shared_prefix_hits:
        say(f"prefix sharing: {s.shared_prefix_hits} adoptions, "
            f"{s.shared_prefix_tokens} prompt tokens skipped; "
            f"pool={eng.pool_stats()}")
    ttfts = [r.ttft for r in done if r.ttft > 0]
    if ttfts:
        say(f"ttft: mean={1e3 * np.mean(ttfts):.1f}ms "
            f"max={1e3 * np.max(ttfts):.1f}ms (chunk={args.chunk})")
    if args.timeline:
        n = eng.export_timeline(args.timeline)
        say(f"wrote {args.timeline} ({n} timeline events)")
    led = eng.obs.ledger
    if led is not None:
        errs = led.reconcile(lineage_snapshot_host(
            paged_layers(eng.cache.layers)[0]))
        say(f"lineage: {led.counts()}; reconcile: "
            f"{'ok' if not errs else errs}")
        for slot in range(args.max_batch):
            rep = led.request_loss_report(slot)
            if rep["pages_lost"]:
                score = rep["mean_evict_score"]
                say(f"  slot {slot}: lost {rep['pages_lost']} pages / "
                    f"{rep['tokens_lost']} tokens at {rep['positions']} "
                    f"(mean victim score "
                    f"{'n/a' if score is None else format(score, '.3g')})")
    if args.regret_every:
        for req in done:
            summ = req.regret_summary()
            if summ:
                say(f"  req {req.request_id}: {summ['probes']} probes, "
                    f"divergence mean={summ['mean_divergence']:.3g} "
                    f"max={summ['max_divergence']:.3g}, evicted mass "
                    f"mean={summ['mean_evicted_mass']:.3g}")
        say(f"regret shadow cache: {eng.shadow_nbytes()} bytes")
    if not args.no_metrics:
        say(eng.obs.registry.render())
    if args.snapshot and rank0:
        with open(args.snapshot, "w") as f:
            json.dump(eng.metrics_snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        say(f"wrote {args.snapshot}")
    if args.trace and rank0:
        say(f"wrote {args.trace} ({eng.obs.writer.events_written} events)")


if __name__ == "__main__":
    main()
