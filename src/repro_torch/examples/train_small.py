"""End-to-end training driver: train a small model for a few hundred steps
on the synthetic LM stream, with checkpointing, then reload and serve one
prompt from the trained weights.

    PYTHONPATH=src python -m repro_torch.examples.train_small \\
        [--steps 200] [--arch qwen2.5-3b] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.serving import Engine, SamplingParams
from repro_torch.training import (AdamWConfig, DataConfig, batch_to_device,
                                  init_adamw, latest_step, lm_batch,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint)
from repro_torch.training.tree import leaves


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--size", default="reduced", choices=("reduced", "100m"),
                    help="reduced = the family's small variant; 100m = a "
                         "~100M-parameter run (slower)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    if args.size == "100m":
        cfg = replace(cfg, num_layers=12, d_model=704, num_heads=8,
                      num_kv_heads=8, head_dim=88, d_ff=2816,
                      vocab_size=32000, dtype="float32")
        print(f"100m config: {cfg.param_count() / 1e6:.0f}M params, "
              f"{cfg.num_layers} layers")
    if params is None:
        params = init_model(cfg, seed=0, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = init_adamw(params)
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=20,
                                            total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch)

    t0 = time.perf_counter()
    losses = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for i in range(args.steps):
            b = batch_to_device(lm_batch(dcfg, i,
                                         num_codebooks=cfg.num_codebooks), dev)
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            if i % max(args.steps // 8, 1) == 0:
                print(f"step {i:4d} loss {losses[-1]:.4f} lr "
                      f"{float(m['lr']):.2e}")
        print(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}"
              f"s: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        save_checkpoint(ckpt_dir, args.steps, {"params": params})
        saved = latest_step(ckpt_dir)
        print(f"checkpoint saved at step {saved}")
        restored = load_checkpoint(ckpt_dir, args.steps,
                                   {"params": params})["params"]
    equal = all(torch.equal(a.detach(), b.detach()) for a, b in
                zip(leaves(params), leaves(restored)))

    # serve from the trained weights with the paper's eviction policy
    ccfg = CacheConfig(page_size=8, cache_budget=64, policy="paged_eviction",
                       dtype="float32")
    eng = Engine(cfg, restored, cache_cfg=ccfg, max_batch=2,
                 max_prompt_len=64, max_new_tokens=16,
                 sampling=SamplingParams(greedy=True), device=dev)
    req = eng.submit(np.arange(48, dtype=np.int32) % cfg.vocab_size)
    eng.run()
    print(f"served from trained checkpoint: generated {req.output_tokens}")
    return {"losses": losses, "saved_step": saved, "restored_equal": equal,
            "generated": list(req.output_tokens)}


if __name__ == "__main__":
    main()
