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

``--mesh single|multi`` trains over the production grid, as the JAX
launcher's ``--mesh``: (16, 16) over (data, model), or (2, 16, 16) with a
pod axis, one process per rank (under ``torchrun``, or any launcher that
sets MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE; NCCL with a GPU per
rank). The weights are drawn whole on each process's host and only
each rank's slices, laid out by ``sharding.rules.param_shardings``, go
to its card; the f32 moments are made on the placed parameters, so no
card ever holds a whole model or a whole moment. The batch is placed by
``data_shardings``; the step is the same, with no ZeRO-1 and no ``ac``
(those are library options: ``make_train_step(..., ac=...)`` and
moments placed by ``opt_shardings(..., zero1=True)``). A process group
of another world size is refused, naming the one the grid needs;
nothing falls back to one device. Under a grid ``--ckpt-dir`` gathers every leaf whole (every rank
takes part) and rank 0 writes it: ``load_checkpoint`` on one device reads
it. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_grid
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
from repro_torch.sharding import rules
from repro_torch.training.tree import leaves, map_leaves


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
    ap.add_argument("--mesh", default=None, choices=("single", "multi"),
                    help="the production grid (needs a process group of "
                         "its size: 256 or 512 ranks)")
    args = ap.parse_args(argv)

    grid = None
    if args.mesh:
        grid = make_production_grid(multi_pod=args.mesh == "multi",
                                    device=args.device)
    device = grid.device if grid else resolve_device(args.device)
    say = print if grid is None or torch.distributed.get_rank() == 0 \
        else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps)
    # under a grid the whole model is drawn on the host and each rank's
    # card receives only its slices; the moments are then made on the
    # placed parameters (no ZeRO-1: opt_shardings gives the parameters'
    # own layout), so they are born split
    params = init_model(cfg, seed=args.seed,
                        device="cpu" if grid else device)
    if grid:
        params = rules.distribute(
            grid, params, rules.param_shardings(grid, cfg, params))
    opt = init_adamw(params)
    for p in leaves(params):
        p.requires_grad_(True)
    step_fn = make_train_step(cfg, opt_cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch, seed=args.seed)

    cond = None
    if cfg.cross_attention:
        gen = torch.Generator(device=device).manual_seed(1)
        cond = make_inputs(gen, cfg, args.batch, 4, device)["cond"]
        if grid:
            cond = rules.place(grid, cond, rules.data_shardings(
                grid, {"c": cond})["c"])

    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = batch_to_device(
            lm_batch(dcfg, i, num_codebooks=cfg.num_codebooks), device, grid)
        params, opt, m = step_fn(params, opt, batch, cond=cond)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            say(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"({(time.perf_counter() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            state = {"params": params, "opt": opt}
            if grid:
                # every rank gathers each leaf; rank 0 writes
                state = map_leaves(rules.full, state)
            if grid is None or torch.distributed.get_rank() == 0:
                path = save_checkpoint(args.ckpt_dir, i + 1, state)
                say(f"  checkpoint -> {path}", flush=True)
    say(f"done: {args.steps} steps in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
