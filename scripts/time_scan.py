#!/usr/bin/env python3
"""Time the serving step's recurrent scan (``transformer._scan_recurrent``)
against a variant with an all-live shortcut, at chip_smoke.py's phase-11
workload: jamba-1.5-large (4 of 72 layers) and xlstm-1.3b (8 of 48) at
full width, bf16, random weights from seed 0, 4 requests of 1024-3072
prompt tokens, 16 greedy tokens each, max batch 4, chunk 256 with 4 chunks
a step, decode splits 4, paged_eviction at budget 512, page 16.

The port's scan selects each token's new state row by row (``torch.where``
per state field and on the output), so that rows past their token count
freeze. The shortcut (``scan_all_live`` below, on) takes the new state as
it is at tokens where every row is live; the results are the same, and
both modes must give the same tokens. Each family serves the workload once
to warm up, then four times, on, off, off, on, and prints each timed run's
wall time, mean mixed-step time and the recurrent layers' time in the
mixed steps (host-clocked, the card synchronized around each layer), then
the card's name and power limit and one JSON line:

    python3 scripts/time_scan.py [--arch ARCH ...]

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=None,
                    help="families to time (default: chip_smoke's phase 11)")
    args = ap.parse_args()
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Engine

    scan, step_recurrent = tf._scan_recurrent, tf._step_recurrent
    mode = {"shortcut": True, "rec_s": 0.0}

    def scan_all_live(step_fn, state, init_state, h_seq, n_tok, reset_mask,
                      n_host):
        """``tf._scan_recurrent`` that skips the select while every row
        is live."""
        B, T = h_seq.shape[:2]
        n_all, n_run = int(n_host.min()), int(n_host.max())

        def select(mask, new, old):
            return type(old)(**{f.name: torch.where(
                mask.reshape((B,) + (1,) * (getattr(old, f.name).ndim - 1)),
                getattr(new, f.name), getattr(old, f.name))
                for f in dataclasses.fields(old)})

        st = state
        if reset_mask is not None:
            st = select(reset_mask, type(init_state)(**{
                f.name: getattr(init_state, f.name).to(
                    getattr(st, f.name).dtype)
                for f in dataclasses.fields(st)}), st)
        act = torch.arange(T, device=h_seq.device)[:, None] < n_tok[None, :]
        outs = []
        for t, h_t in enumerate(h_seq.unbind(1)[:n_run]):
            out, new = step_fn(h_t, st)
            if t < n_all:
                st = new
                outs.append(out)
            else:
                st = select(act[t], new, st)
                outs.append(torch.where(act[t][:, None], out, 0.0))
        outs += [torch.zeros_like(h_seq[:, 0])] * (T - n_run)
        tf._assign(state, st)
        return torch.stack(outs, 1)

    def scan_in_mode(*a):
        return (scan_all_live if mode["shortcut"] else scan)(*a)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_recurrent(*a, **kw)
        torch.cuda.synchronize()
        mode["rec_s"] += time.perf_counter() - t
        return out

    tf._scan_recurrent, tf._step_recurrent = scan_in_mode, timed
    archs = args.arch or list(cs.RECURRENT)
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch),
                                  num_layers=cs.RECURRENT[arch])
        params = tf.init_model(cfg, seed=0, device="cuda")
        ccfg = CacheConfig(page_size=16, cache_budget=512,
                           policy="paged_eviction", dtype="bfloat16")
        prompts = cs.serving_prompts(np, cfg.vocab_size, 4, 3072)
        runs, tokens = [], {}
        for i, shortcut in enumerate((True, True, False, False, True)):
            mode["shortcut"] = shortcut
            eng = Engine(cfg, params, cache_cfg=ccfg, max_batch=4,
                         max_prompt_len=3072,
                         max_new_tokens=cs.FAMILY_NEW_TOKENS, chunk_size=256,
                         token_budget=4 * 256, decode_splits=4,
                         device="cuda")
            for p in prompts:
                eng.submit(p, max_new_tokens=cs.FAMILY_NEW_TOKENS)
            plan, last = eng.scheduler.plan, {}

            def recorded(plan=plan, last=last):
                last["plan"] = plan()
                return last["plan"]
            eng.scheduler.plan = recorded
            mixed_rec = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while True:
                mode["rec_s"] = 0.0
                more = eng.step()
                if last["plan"].prefill:
                    mixed_rec += mode["rec_s"]
                if not more:
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s = eng.stats
            mixed = s.steps - s.decode_steps
            got = {r.request_id: list(r.output_tokens)
                   for r in eng.scheduler.finished}
            tokens.setdefault(shortcut, got)
            if got != tokens[shortcut] or got != tokens[True]:
                cs.fail(f"{arch}: tokens differ between runs")
            del eng
            torch.cuda.empty_cache()
            if i == 0:
                continue
            run = {"shortcut": shortcut, "wall_s": wall,
                   "mixed_steps": mixed,
                   "mixed_ms": 1e3 * s.prefill_s / max(mixed, 1),
                   "recurrent_mixed_ms": 1e3 * mixed_rec / max(mixed, 1)}
            runs.append(run)
            print(f"  {arch} shortcut {'on ' if shortcut else 'off'}: "
                  f"{wall:.3f} s, {mixed} mixed steps of "
                  f"{run['mixed_ms']:.2f} ms, recurrent layers "
                  f"{run['recurrent_mixed_ms']:.2f} ms of them", flush=True)
        out[arch] = runs
        del params
        torch.cuda.empty_cache()
    tf._scan_recurrent, tf._step_recurrent = scan, step_recurrent
    print(cs.card_line())
    print(json.dumps({"time_scan": out}))


if __name__ == "__main__":
    main()
