#!/usr/bin/env python3
"""The readings the check's limits are set from, at a cell's own size, in
one process: for each seed, the weights from the seed, one call of the
timed path (the cell's batch, lengths and decode steps), then the check's
numbers against the plain reference (the program's readings: the lower
end of each limit); for the first ``--control`` seeds also the control,
the reference computed with fp8 operands (the precision below the
configuration's bf16) put in the program's place (the upper end); for the
first ``--witness`` seeds the reference with bf16 products in the same
place (a second witness of what bf16 alone does to each number). Each
request also reads what ``evict_gap`` would be for an Alg. 3 that evicts,
in every layer, the second-lowest or the highest full page instead of the
lowest (the reference with that fault put in the program's place; one
that evicts none reads 1 by the number's definition).

    python3 perfbench/control.py --workload nemo12b.longdoc \\
        --seeds 101 102 103 --control 3 --rows 2 --out control.jsonl

Needs a CUDA card. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def _decode_victims(res, rec, row: int) -> float:
    """The share of layers whose evicted page was the decode's own first
    page."""
    n, page = int(rec.call.lengths[row]), rec.pre.pos[0].shape[-1]
    dec = set(range(n, n + page))
    hits = [not dec & rec.post.live(li, row)
            for li in range(len(res.layers))]
    return sum(hits) / len(hits)


def _evict_faults(res, rec, row: int, ccfg: dict) -> dict:
    """evict_gap of an Alg. 3 that evicts, in every layer, the second-lowest
    (``evict_second``) or the highest (``evict_top``) full page, replayed
    from the program's pages after its prefill."""
    from perfbench.check import evict_choices
    n, T = int(rec.call.lengths[row]), rec.steps
    ch = [evict_choices(lay.start, lay.scores.tolist(), n, T, ccfg)
          for lay in res.layers]
    ch = [c for c in ch if len(c) > 1]
    if not ch:
        return {}
    return {"evict_second": max(c[1] for c in ch),
            "evict_top": max(c[-1] for c in ch)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0,
                    help="seeds that also run the bf16 witness")
    ap.add_argument("--rows", type=int, default=None,
                    help="requests of the check's sample read per seed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from perfbench import harness, traffic as traffic_mod
    from perfbench.check import control_reading, program_numbers
    from perfbench.spec import load_cell, reference
    from repro_torch.kernels.build import build_all
    build_all()
    cell = load_cell(args.workload)
    Reference = reference(cell.config, cell.here)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t = time.time()
        prog = harness.setup(cell, seed, "cuda")
        call = traffic_mod.make_call(cell.traffic, prog.cfg.vocab_size,
                                     seed, 0)
        rec = harness.run_call(prog, call, cell.traffic["decode_steps"])
        picks = traffic_mod.check_sample(cell.traffic, seed,
                                         [call])[:args.rows]
        ref = Reference(prog.params, cell.config)
        ctl = Reference(prog.params, cell.config, "fp8") \
            if i < args.control else None
        wit = Reference(prog.params, cell.config, "bf16") \
            if i < args.witness else None
        for _, row in picks:
            ccfg = cell.config["cache"]
            t1 = time.time()
            numbers, res = program_numbers(ref, rec, row, ccfg)
            item = {"workload": cell.name, "seed": seed, "row": row,
                    "n": int(call.lengths[row]), "ttft_s": rec.ttft,
                    "ref_s": time.time() - t1, "program": numbers,
                    "victim_is_decode_page": _decode_victims(res, rec, row),
                    "faults": _evict_faults(res, rec, row, ccfg)}
            del res
            if ctl is not None:
                t1 = time.time()
                item["control"] = control_reading(ref, ctl, rec, row, ccfg)
                item["control_s"] = time.time() - t1
            if wit is not None:
                item["witness"] = control_reading(ref, wit, rec, row, ccfg)
            print(json.dumps(item), flush=True)
            if out:
                out.write(json.dumps(item) + "\n")
                out.flush()
        del prog, rec, ref, ctl, wit
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.time() - t:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
