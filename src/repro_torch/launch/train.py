"""Training driver of the torch port, on the GPU by default.

    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
        --steps 50 --batch 8 --seq 128 --device cpu

Trains on the synthetic LM stream (``training.data.lm_batch``) with AdamW
(linear warmup over ``--warmup`` steps, cosine decay to the last step),
logging step, loss, ce, lr, grad norm and elapsed seconds about every tenth
step, as the JAX package's ``launch/train.py``. ``--ckpt-dir`` with
``--ckpt-every N`` saves {"params", "opt"} every N steps. A codebook model
(musicgen) trains on (B, K, S) tokens, and a cross-attention model on one
random conditioning (B, cond_len, D) drawn from seed 1 for the whole run,
as the JAX launcher does. Attention takes
the training route (plain autograd, never a kernel) on every device.
Training runs on one device: the JAX launcher's ``--mesh`` (its GSPMD
training rules, ZeRO-1 optimizer sharding, the ``ac`` activation
constraints, expert parallelism) is not ported; tensor parallelism is, for
serving (``launch/serve.py --tp``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.multimodal import make_inputs
from repro_torch.models.transformer import init_model
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    batch_to_device,
    init_adamw,
    lm_batch,
    make_train_step,
    save_checkpoint,
)
from repro_torch.training.tree import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-scale) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain torch throughout)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps)
    params = init_model(cfg, seed=args.seed, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = init_adamw(params)
    step_fn = make_train_step(cfg, opt_cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch, seed=args.seed)

    cond = None
    if cfg.cross_attention:
        gen = torch.Generator(device=device).manual_seed(1)
        cond = make_inputs(gen, cfg, args.batch, 4, device)["cond"]

    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = batch_to_device(
            lm_batch(dcfg, i, num_codebooks=cfg.num_codebooks), device)
        params, opt, m = step_fn(params, opt, batch, cond=cond)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"({(time.perf_counter() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, i + 1,
                                   {"params": params, "opt": opt})
            print(f"  checkpoint -> {path}", flush=True)
    print(f"done: {args.steps} steps in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
