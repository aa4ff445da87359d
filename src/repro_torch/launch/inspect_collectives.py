"""The collectives of one step of the torch port: op, group, dtype and
bytes (the JAX package's ``repro.launch.inspect_collectives``).

Two modes:

**Dry run** (``--shape``): the step of ``launch.dryrun`` on the meta
device over a fake production grid, its largest collectives by bytes
(every functional collective the step issues, DTensor's included):

    PYTHONPATH=src python -m repro_torch.launch.inspect_collectives \\
        --arch mixtral-8x7b --shape train_4k --top 15

**Serving** (``--serve-tp N``): the reduced engine at ``reduced(tp=max(N,
2))`` (f32 pool, page 4, budget 32, max batch 2, chunk 2 pages) runs one
mixed and one decode-only step on the CPU as rank 0 of a fake process
group of world size N, and every collective its ``TPGroup`` issues is
printed as ``op group=N dtype[shape]``, with totals. The fake group's
all-reduce does not reduce: the mode inventories the collectives, it does
not compute. ``--json FILE`` writes the JAX package's layout:

    PYTHONPATH=src python -m repro_torch.launch.inspect_collectives \\
        --arch gemma3-27b --serve-tp 4 --json collectives.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.launch import analysis


def serving_records(arch: str, tp: int, policy: str, budget: int,
                    page: int) -> dict:
    """{"mixed", "decode"}: the collectives (analysis records) one mixed and
    one decode-only engine step issue at tensor-parallel degree ``tp``, as
    rank 0 of a fake group (initialised here unless one of size ``tp``
    is)."""
    import torch.distributed as dist

    from repro_torch.configs import CacheConfig, get_arch
    from repro_torch.launch import mesh
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import Engine, SamplingParams

    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=tp)
    records: list = []

    class Recording(mesh.TPGroup):
        def _note(self, t):
            records.append(("all-reduce", list(range(self.size)),
                            str(t.dtype).replace("torch.", ""),
                            tuple(t.shape), t.numel() * t.element_size()))

        def all_reduce_sum(self, t):
            self._note(t)
            return super().all_reduce_sum(t)

        def all_reduce_mean(self, t):
            self._note(t)
            return super().all_reduce_mean(t)

    group = Recording(rank=0, size=tp, device=torch.device("cpu"))
    cfg = get_arch(arch).reduced(tp=max(tp, 2))
    ccfg = CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                       dtype="float32")
    eng = Engine(cfg, init_model(cfg, seed=0, device="cpu"), cache_cfg=ccfg,
                 max_batch=2, max_prompt_len=4 * page, max_new_tokens=4,
                 sampling=SamplingParams(greedy=True), chunk_size=2 * page,
                 seed=0, device="cpu", obs=ObsConfig(), tp_group=group)
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.submit(rng.integers(0, cfg.vocab_size, 2 * page, dtype=np.int32))
    out = {}
    for name in ("mixed", "decode"):
        del records[:]
        eng.step()
        out[name] = list(records)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="dry-run mode: production-grid shape name")
    ap.add_argument("--serve-tp", type=int, default=0, metavar="N",
                    help="serving mode: the engine's steps at tp=N and "
                         "their collectives")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--layout", default="2d", choices=("2d", "ep"))
    ap.add_argument("--policy", default=None)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--page", type=int, default=None)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the collective set here")
    args = ap.parse_args(argv)
    if bool(args.shape) == bool(args.serve_tp):
        ap.error("exactly one of --shape (dry run) or --serve-tp (serving) "
                 "is required")

    if args.serve_tp:
        pol = args.policy or "paged_eviction"
        recs = serving_records(args.arch, args.serve_tp, pol,
                               args.budget or 32, args.page or 4)
        print("== the fake group's all-reduce does not reduce: this lists "
              "the collectives, it computes nothing ==")
        out = {}
        for name, rec in recs.items():
            cs = analysis.collective_set(rec)
            out[name] = cs
            print(f"== serving step collectives: {args.arch} "
                  f"tp={args.serve_tp} x {pol} x {name} ==")
            for sig in cs["signatures"] or ["(none)"]:
                print(f"  {sig}")
            print(f"  totals: {cs['counts']} result_bytes="
                  f"{cs['result_bytes']}")
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"arch": args.arch, "tp": args.serve_tp,
                           "policy": pol, "programs": out}, f, indent=1,
                          sort_keys=True)
                f.write("\n")
            print(f"wrote {args.json}")
        return

    from repro_torch.launch.dryrun import default_policy, run_one
    pol = args.policy or default_policy(args.shape)
    r = run_one(args.arch, args.shape, args.mesh, pol, args.budget or 4096,
                args.page or 16, args.zero1, None, verbose=False,
                layout=args.layout)
    print(f"== top collectives: {args.arch} x {args.shape} x {args.mesh} "
          f"x {pol} ==")
    for b, op, g, ty in analysis.collective_lines(r["records"], args.top):
        print(f"  {b / 1e9:8.3f} GB  {op:16s} group={g:3d}  {ty}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": args.arch, "shape": args.shape,
                       "policy": pol,
                       "collectives": analysis.collective_set(r["records"])},
                      f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
