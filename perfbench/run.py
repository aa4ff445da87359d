#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 perfbench/run.py --workload nemo12b.longdoc --seed 7 \\
        --seconds 51 --trace 0

Needs a CUDA card; prints the card, its count and nvidia-smi's power limit
and clocks, sets up and warms up, measures closed-loop calls of the
one-shot path for ``--seconds``, [profiles one more call with ``--trace
1``,] checks the window's answers against the plain reference, and prints
one JSON object as the last line of standard output (the end-to-end
metrics with ``--trace 0``, the per-layer ones with ``--trace 1``) and
the compared numbers with their limits as the last lines of standard
error. Every kernel and cache it builds stays inside the checkout.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# fixed cache directories inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    import torch
    from perfbench.harness import execute
    from perfbench.spec import benchmark, load_cell
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 3
    cell = load_cell(args.workload)
    chips = {w["name"]: w["chips"] for w in benchmark()["workloads"]}
    if torch.cuda.device_count() < chips[args.workload]:
        log(f"{args.workload} needs {chips[args.workload]} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(f"card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} present; nvidia-smi name, power.limit, "
        f"clocks.sm, clocks.max.sm: {smi.stdout.strip()}")
    # one host thread for torch's own CPU work: no idle pool spinning
    # beside the thread that issues the kernels
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, log=log)
    line["device"]["power_limit"] = smi.stdout.strip().split(",")[1].strip() \
        if smi.returncode == 0 else "unknown"
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
