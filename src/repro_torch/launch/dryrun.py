"""The dry run of the torch port: every (arch x input shape x production
grid) combination the JAX package's dry run lowers, run as one eager step
on the ``meta`` device over a fake process group of the grid's size (256
or 512 ranks, in this one process), counted as it runs
(``launch.analysis``): FLOPs, bytes, collectives and per-rank memory, and
the H100 roofline terms derived from the counts. No tensor is allocated
and no card is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama-3.2-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

A step is the JAX package's ``build_lowerable`` program: a training step
(AdamW, optionally ZeRO-1) for ``train_4k``, ``forward_prefill`` for
``prefill_32k``, one ``decode_step`` against a cache covering the shape's
length for ``decode_32k`` / ``long_500k``, each with the activation
constraint of the grid; parameters placed by ``param_shardings``, caches
by ``cache_shardings``. Each run writes ``{tag}.json`` (the JAX tag and
``Roofline`` layout) under ``--out``.

The fake group comes from ``torch.testing._internal.distributed.fake_pg``;
without it the dry run raises, naming it: it never runs on fewer ranks
than its grid.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import asdict

import torch

from repro_torch.configs import (ARCHS, ASSIGNED_ARCHS, SHAPES, CacheConfig,
                                 get_arch, get_shape)
from repro_torch.core.policies import get_policy
from repro_torch.launch import analysis
from repro_torch.launch.mesh import Grid, production_grid_shape
from repro_torch.models.multimodal import input_specs
from repro_torch.models.transformer import (decode_step, forward_prefill,
                                            init_decode_caches, init_model)
from repro_torch.sharding import rules
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import leaves

ART_DIR = os.path.join("experiments", "dryrun_torch")


def default_policy(shape_name: str) -> str:
    """The JAX package's baseline per shape: the full cache for the
    prefill and 32k decode, the paper's budget-capped cache for 500k."""
    return {"train_4k": "full", "prefill_32k": "full",
            "decode_32k": "full", "long_500k": "paged_eviction"}[shape_name]


def make_cache_cfg(policy: str, budget: int, page: int,
                   cache_dtype: str = "bfloat16") -> CacheConfig:
    return CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                       slab_multiple=16, dtype=cache_dtype)


def fake_grid(shape: tuple, axes: tuple) -> Grid:
    """A grid of ``shape`` over a fake process group of its size in this
    process (rank 0), initialised here unless one of that size is. Its
    collectives move nothing. The mesh is typed "cuda" whether or not a
    card is present (nothing is placed on it: every tensor stays on
    meta), so that DTensor takes its card paths: its Shard -> Shard
    exchange is the all-to-all it issues on the card, not the all-gather
    it falls back to on a "cpu" mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = 1
    for n in shape:
        world *= n
    if not dist.is_initialized():
        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore
        except ImportError as e:
            raise RuntimeError(
                "the dry run needs torch.testing._internal.distributed."
                "fake_pg (a fake process group of the grid's size); this "
                "torch has none") from e
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if dist.get_world_size() != world:
        raise ValueError(f"grid {shape} needs {world} ranks; the process "
                         f"group has {dist.get_world_size()}")
    mesh = init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(axes))
    return Grid(shape=dict(zip(axes, shape)), mesh=mesh,
                device=torch.device("meta"))


def build_step(arch: str, shape_name: str, grid, policy_name: str,
               budget: int, page: int, zero1: bool,
               cache_dtype: str = "bfloat16", seq_parallel: bool = False,
               cfg=None, shape=None):
    """(fn, args): ``fn(*args)`` runs the combination's step on meta over
    ``grid`` (the JAX package's ``build_lowerable``). ``cfg`` / ``shape``
    override the registered ones (a cut configuration)."""
    cfg = cfg or get_arch(arch)
    shape = shape or get_shape(shape_name)
    B = shape.global_batch
    meta = init_model(cfg, device="meta")
    p_sh = rules.param_shardings(grid, cfg, meta)
    params = rules.distribute(grid, meta, p_sh)
    ac = rules.activation_constraint(grid, B, seq_parallel=seq_parallel)
    specs = input_specs(cfg, shape, for_decode=shape.kind == "decode")
    b = rules.batch_axes(grid, B)
    cond = specs["cond"]
    if cond is not None:
        cond = rules.place(grid, cond, (b, None, None))

    if shape.kind == "train":
        opt = init_adamw(meta)
        o_sh = rules.opt_shardings(grid, cfg, opt, p_sh, zero1=zero1)
        opt = opt._replace(mu=rules.distribute(grid, opt.mu, o_sh.mu),
                           nu=rules.distribute(grid, opt.nu, o_sh.nu))
        for t in leaves(params):
            t.requires_grad_(True)
        batch = {"tokens": specs["tokens"],
                 "targets": torch.zeros_like(specs["tokens"]),
                 "mask": torch.zeros((B, shape.seq_len), device="meta")}
        b_sh = rules.data_shardings(grid, batch)
        batch = {k: rules.place(grid, v, b_sh[k]) for k, v in batch.items()}
        step = make_train_step(cfg, AdamWConfig(), ac=ac)
        return (lambda p, o, bt, c: step(p, o, bt, cond=c)), \
            (params, opt, batch, cond)

    policy = get_policy(policy_name)
    ccfg = make_cache_cfg(policy_name, budget, page, cache_dtype)
    tokens = rules.place(grid, specs["tokens"],
                         (b,) + (None,) * (specs["tokens"].dim() - 1))
    if shape.kind == "prefill":
        def prefill(p, tok, c):
            return forward_prefill(p, cfg, tok, policy, ccfg, cond=c, ac=ac,
                                   total_seq_hint=shape.seq_len)
        return prefill, (params, tokens, cond)

    cache = init_decode_caches(cfg, B, shape.seq_len, policy, ccfg,
                               device="meta")
    cache = rules.place_cache(grid, cfg, cache, B)

    def decode(p, tok, c):
        return decode_step(p, cfg, tok, c, policy, ccfg, ac=ac)
    return decode, (params, tokens, cache)


def _tag(arch, shape_name, mesh_name, policy, zero1, cache_dtype,
         seq_parallel, layout) -> str:
    return (f"{arch}_{shape_name}_{mesh_name}_{policy}"
            + ("_zero1" if zero1 else "")
            + (f"_{cache_dtype}" if cache_dtype != "bfloat16" else "")
            + ("_sp" if seq_parallel else "")
            + (f"_{layout}" if layout != "2d" else ""))


def run_one(arch: str, shape_name: str, mesh_name: str, policy_name: str,
            budget: int, page: int, zero1: bool, out_dir: str | None,
            verbose: bool = True, cache_dtype: str = "bfloat16",
            seq_parallel: bool = False, layout: str = "2d", grid=None,
            cfg=None, shape=None) -> dict:
    """Count one combination's step and write ``{tag}.json`` under
    ``out_dir`` (None: nothing written). ``grid``: a grid to run over
    instead of the production one (``cfg`` / ``shape``: see
    :func:`build_step`). Returns the ``Roofline`` as a dict, with the
    step's collective records under "records"."""
    if grid is None:
        grid = fake_grid(*production_grid_shape(mesh_name == "multi",
                                                layout))
    chips = grid.size
    cfg = cfg or get_arch(arch)
    shape = shape or get_shape(shape_name)
    t0 = time.perf_counter()
    fn, args = build_step(arch, shape_name, grid, policy_name, budget, page,
                          zero1, cache_dtype, seq_parallel, cfg, shape)
    t_build = time.perf_counter() - t0
    t1 = time.perf_counter()
    with analysis.StepCounter(chips) as counter:
        out = fn(*args)
    seconds = time.perf_counter() - t1
    r = analysis.analyze(
        counter, arch=arch, shape=shape_name, mesh_name=mesh_name,
        policy=policy_name, kind=shape.kind, chips=chips,
        model_flops=analysis.model_flops_estimate(cfg, shape),
        seconds=seconds, argument_bytes=analysis.local_bytes(args),
        output_bytes=analysis.local_bytes(out),
        notes=f"budget={budget} page={page} zero1={zero1} "
              f"cache_dtype={cache_dtype} seq_parallel={seq_parallel} "
              f"layout={layout} build_s={t_build:.1f}")
    tag = _tag(arch, shape_name, mesh_name, policy_name, zero1, cache_dtype,
               seq_parallel, layout)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        analysis.save_roofline(os.path.join(out_dir, tag + ".json"), r)
    if verbose:
        print(f"[dryrun] {tag}: OK step={seconds:.1f}s "
              f"compute={r.compute_s:.3e}s memory={r.memory_s:.3e}s "
              f"collective={r.collective_s:.3e}s dominant={r.dominant} "
              f"useful={r.useful_flops_ratio:.2f} "
              f"mem={r.memory_analysis} "
              f"collectives={ {k: v[0] for k, v in r.collective_counts.items()} }",
              flush=True)
    return {**asdict(r), "records": counter.records}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--policy", default=None,
                    help="eviction policy (default: per-shape baseline)")
    ap.add_argument("--budget", type=int, default=4096)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer moments over data (ZeRO-1)")
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=("bfloat16", "float32", "int8"),
                    help="KV cache dtype (int8 = quantized cache)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-style sequence-parallel layer inputs")
    ap.add_argument("--layout", default="2d", choices=("2d", "ep"),
                    help="grid layout: 2d=(data,model); ep=(data,expert,tp) "
                         "expert-parallel MoE")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) for --mesh")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        combos = [(args.arch, args.shape)]
    grid = fake_grid(*production_grid_shape(args.mesh == "multi",
                                            args.layout))
    failures = []
    for a, s in combos:
        pol = args.policy or default_policy(s)
        try:
            run_one(a, s, args.mesh, pol, args.budget, args.page,
                    args.zero1, args.out, cache_dtype=args.cache_dtype,
                    seq_parallel=args.seq_parallel, layout=args.layout,
                    grid=grid)
        except Exception as e:  # noqa: BLE001 - reported per combination
            failures.append((a, s, repr(e)))
            print(f"[dryrun] {a} x {s} x {args.mesh} x {pol}: FAIL {e!r}",
                  flush=True)
    if failures:
        print(f"{len(failures)} dry-run failures: {failures}",
              file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
