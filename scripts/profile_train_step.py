#!/usr/bin/env python3
"""Profile one training step of the port on the card: where its time goes.

    python3 scripts/profile_train_step.py            # llama-3.2-1b, bf16,
                                                     # B 2 x S 4096
    python3 scripts/profile_train_step.py --seq 1024 --batch 8

chip_smoke.py phase 9b's configuration by default: random weights from
seed 0, AdamW (lr 1e-4, warmup 2), ``lm_batch`` of the given shape, TF32
off for matmuls. Runs ``--warmup`` steps, then one step under
``torch.profiler`` (CPU and CUDA activities), and prints the card's name
and power limit, the step's wall time, the device's busy time (the union of
its activity intervals) and its share of the wall time, the aten calls,
the device time by kernel group (:func:`kind`) and the ``--top`` kernels by
device time with their launch counts. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def kind(name: str) -> str:
    """A kernel's group by its name: f32 GEMMs on the CUDA cores (TF32 off),
    other GEMMs (bf16 on the tensor cores), the optimizer's multi-tensor
    kernels, reductions, elementwise kernels, the rest."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        return "GEMM f32 (CUDA cores)" if "f32f32" in low \
            else "GEMM bf16 (tensor cores)"
    if "multi_tensor_apply" in low:
        return "multi-tensor (AdamW)"
    if "reduce_kernel" in low:
        return "reductions"
    if "elementwise" in low or "copy" in low:
        return "elementwise and copies"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import device_busy_us
    from repro_torch.models.transformer import init_model
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      batch_to_device, init_adamw, lm_batch,
                                      make_train_step)
    from repro_torch.training.tree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_arch(args.arch)
    params = init_model(cfg, seed=0, device="cuda")
    for p in leaves(params):
        p.requires_grad_(True)
    opt = init_adamw(params)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch, seed=0)
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-4, warmup_steps=2,
                                            total_steps=args.warmup + 1))
    for i in range(args.warmup):
        params, opt, m = step(params, opt,
                              batch_to_device(lm_batch(dcfg, i), "cuda"))
        float(m["loss"])
    batch = batch_to_device(lm_batch(dcfg, args.warmup), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, total = device_busy_us(prof.events())
    print(f"{args.arch} B {args.batch} x S {args.seq}: profiled step wall "
          f"{1e3 * wall:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e6 / wall:.1f}%), device activity sum "
          f"{total / 1e3:.1f} ms", flush=True)
    ka = prof.key_averages()
    aten = sum(e.count for e in ka if e.key.startswith("aten::"))
    print(f"aten calls {aten}", flush=True)
    kernels = sorted((e for e in ka if not e.key.startswith("aten::")
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    groups: dict = {}
    for e in kernels:
        g = kind(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {us / 1e3:9.2f} ms ({100 * us / total:4.1f}%)",
              flush=True)
    for e in kernels[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"({100 * e.self_device_time_total / total:4.1f}%) "
              f"{e.count:6d}x  {e.key[:100]}", flush=True)


if __name__ == "__main__":
    main()
