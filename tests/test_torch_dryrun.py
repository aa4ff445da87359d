"""The dry run of the torch port, on the CPU: its rules, counters and CLI
against the JAX package's, and the sharded one-shot path against one
device.

- **Specs** (no devices): ``rules.cache_spec`` of every leaf of every
  arch's cache (bf16 and int8 pools, the recurrent states, the
  conditioning K/V; the 32k decode's batch of 128 and the 500k one's
  batch of 1) equals JAX's ``_cache_spec`` over an ``AbstractMesh`` at
  (16, 16), (2, 16, 16) and (16, 8, 2), without the repetition dimension
  and on the port's buffers (their trash row left out); likewise
  ``step_input_shardings``. ``input_specs`` gives JAX's shapes and dtypes.
- **FLOPs**: the counter's matmul FLOPs of the port's prefill, decode
  step and train step (reduced, f32, on meta) equal the sum of
  ``dot_general`` FLOPs over JAX's jaxpr of the same program, scan bodies
  times their length. Two programs differ, each by a fixed, named amount
  (see :data:`JAX_EXTRA`).
- **Regions**: on a fake (2, 2) grid the global FLOPs of the sharded
  prefill and decode equal the one-device count (llama: exactly; mixtral:
  plus the router, which each model rank runs on its rows).
- **Arguments**: ``argument_size_in_bytes`` is the sum of the local shard
  bytes the rules give.
- **Traffic**: the ring traffic of hand-made collectives equals the JAX
  package's ``parse_collectives`` on the same collectives in HLO text.
- ``inspect_collectives --serve-tp 2``: all-reduces only, as
  ``mesh.step_collectives`` counts them; ``dryrun --all`` exits non-zero
  when a combination fails.
- **Sharded one-shot parity**: one spawn of four gloo ranks at (data 2,
  model 2): reduced llama (f32 and int8 pools), mixtral, musicgen (its
  conditioning and codebooks), and mixtral at (data 1, expert 2, tp 2),
  the prefill of four right-padded prompts and four decode steps. On the
  port's weights, against one device: logits within 1e-5 relative,
  integer pool state bit-equal, a quarter of the pool on each rank. On
  JAX's weights and inputs, against JAX's own sharded ``forward_prefill``
  / ``decode_step`` with ``ac`` (a subprocess of 4 host devices, beside
  the ranks): logits within 1e-4, integer pool state bit-equal (an int8
  pool within its quantization step: see :data:`INT8_RTOL`).

Fake process groups are initialised in this process only inside
:func:`fake_group`, and destroyed after.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import warnings
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, CacheConfig, ShapeConfig,
                                 get_arch, get_shape)
from repro_torch.core.policies import get_policy
from repro_torch.launch import analysis, dryrun, mesh
from repro_torch.models.multimodal import input_specs
from repro_torch.models.transformer import (decode_step, forward_prefill,
                                            init_decode_caches, init_model)
from repro_torch.sharding import rules
from repro_torch.training import AdamWConfig, init_adamw, make_train_step
from repro_torch.training.tree import leaves

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "ep": ((16, 8, 2), ("data", "expert", "tp"))}
# (shape, cache dtype) of the caches whose specs are held to JAX's
CACHES = (("decode_32k", "bfloat16"), ("decode_32k", "int8"),
          ("long_500k", "bfloat16"))
FLOP_ARCHS = ("llama-3.2-1b", "mixtral-8x7b", "jamba-1.5-large-398b",
              "musicgen-medium")
B, S = 2, 128          # the FLOP cases' batch and prompt


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process (rank 0),
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ specs

def _jax_cache_specs(arch: str, shape_name: str, cache_dtype: str) -> dict:
    """{(JAX path, mesh name): (shape, spec)} of JAX's cache at the
    shape's batch and length, by its ``_cache_spec``."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import CacheConfig as JCacheConfig
    from repro.configs import get_arch as jget_arch
    from repro.core import get_policy as jget_policy
    from repro.models.transformer import init_decode_caches as jinit
    from repro.sharding import rules as jrules
    cfg, shape = jget_arch(arch), get_shape(shape_name)
    pol = dryrun.default_policy(shape_name)
    ccfg = JCacheConfig(page_size=16, cache_budget=4096, policy=pol,
                        slab_multiple=16, dtype=cache_dtype)
    cache = jax.eval_shape(partial(jinit, cfg, shape.global_batch,
                                   shape.seq_len, jget_policy(pol), ccfg))
    out = {}
    for name, (mshape, axes) in MESHES.items():
        am = AbstractMesh(mshape, axes)
        for p, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            path = jrules._path_str(p)
            spec = tuple(jrules._cache_spec(am, cfg, path, tuple(leaf.shape),
                                            shape.global_batch))
            out[path, name] = (tuple(leaf.shape),
                               spec + (None,) * (len(leaf.shape) - len(spec)))
    return out


def _jax_path(cfg, path: str) -> tuple[str, bool]:
    """The JAX path of a port cache leaf, and whether JAX stacks it."""
    parts = path.split("/")
    if parts[0] == "cur_pos":
        return "cur_pos", False
    kind, i, name = parts[0], int(parts[1]), parts[2]
    P, reps = cfg.pattern_period, cfg.full_pattern_reps
    slot = (["pattern", str(i % P)] if i < reps * P
            else ["tail", str(i - reps * P)])
    if kind == "cross":
        return "/".join(slot + ["xattn", name]), i < reps * P
    mixer = cfg.layer_specs()[i].mixer
    group = "kv" if mixer == "attn" else mixer
    return "/".join(slot + [group, rules._JAX_NAME.get(name, name)]), \
        i < reps * P


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_jax(arch):
    """Every cache leaf's spec equals JAX's at the three production grids,
    for bf16 and int8 pools and a batch that the data axes do not divide;
    the port's leaf is JAX's (its trash row aside)."""
    cfg = get_arch(arch)
    for shape_name, cdt in CACHES:
        shape = get_shape(shape_name)
        want = _jax_cache_specs(arch, shape_name, cdt)
        pol = dryrun.default_policy(shape_name)
        cache = init_decode_caches(
            cfg, shape.global_batch, shape.seq_len, get_policy(pol),
            dryrun.make_cache_cfg(pol, 4096, 16, cdt), device="meta")
        seen = set()
        for name, (mshape, axes) in MESHES.items():
            grid = mesh.abstract_grid(mshape, axes)
            specs = rules.cache_shardings(grid, cfg, cache,
                                          shape.global_batch)
            for path, leaf in rules._cache_leaves(cache):
                jpath, stacked = _jax_path(cfg, path)
                jshape, jspec = want[jpath, name]
                if stacked:
                    jshape, jspec = jshape[1:], jspec[1:]
                lshape = tuple(leaf.shape)
                if path.startswith("layers/") and \
                        path.rsplit("/", 1)[-1] in rules._JAX_NAME:
                    lshape = (lshape[0] - 1,) + lshape[1:]
                assert lshape == jshape, (shape_name, cdt, path, lshape,
                                          jshape)
                assert specs[path] == jspec, (shape_name, cdt, name, path,
                                              specs[path], jspec)
                for n, e in zip(lshape, specs[path]):
                    assert n % rules.axis_size(grid, *rules.axes_of(e)) == 0
                seen.add((jpath, name))
        assert seen == set(want), (shape_name, cdt,
                                   set(want) - seen)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_step_input_specs_match_jax(arch):
    from jax.sharding import AbstractMesh

    from repro.configs import get_arch as jget_arch
    from repro.sharding import rules as jrules
    for name, (mshape, axes) in MESHES.items():
        grid = mesh.abstract_grid(mshape, axes)
        for batch in (128, 1):
            got = rules.step_input_shardings(grid, get_arch(arch), batch,
                                             256)
            want = jrules.step_input_shardings(
                AbstractMesh(mshape, axes), jget_arch(arch), batch, 256)
            assert set(got) == set(want)
            for k, spec in want.items():
                assert got[k] == tuple(spec), (name, batch, k, got[k],
                                               tuple(spec))


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "musicgen-medium"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_match_jax(arch, shape_name):
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    from repro.models.multimodal import input_specs as jinput_specs
    decode = shape_name == "decode_32k"
    got = input_specs(get_arch(arch), get_shape(shape_name),
                      for_decode=decode)
    want = jinput_specs(jget_arch(arch), jget_shape(shape_name),
                        for_decode=decode)
    for k in ("tokens", "cond"):
        if want[k] is None:
            assert got[k] is None
            continue
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)


def test_shapes_and_registries_match_jax():
    import repro.configs as jconfigs
    import repro_torch.configs as configs
    assert list(configs.ASSIGNED_ARCHS) == list(jconfigs.ASSIGNED_ARCHS)
    assert list(configs.PAPER_ARCHS) == list(jconfigs.PAPER_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


# ------------------------------------------------------------ FLOPs

def _dot_flops(jaxpr) -> float:
    """The dot_general FLOPs of a jaxpr: scan bodies times their length,
    the largest branch of a cond, a while body once."""
    from repro.launch.analysis import _dot_flops as one
    total = 0.0
    for e in jaxpr.eqns:
        p = e.primitive.name
        if p == "dot_general":
            total += one(e)
        elif p == "cond":
            total += max(_dot_flops(b.jaxpr) for b in e.params["branches"])
        elif p == "scan":
            total += e.params["length"] * _dot_flops(e.params["jaxpr"].jaxpr)
        elif p == "while":
            total += _dot_flops(e.params["body_jaxpr"].jaxpr)
        else:
            for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if k in e.params:
                    cj = e.params[k]
                    total += _dot_flops(getattr(cj, "jaxpr", cj))
                    break
    return total


def _jax_flops(arch: str) -> dict:
    """JAX's dot_general FLOPs of the prefill, one decode step and one
    train step of the reduced f32 ``arch`` (B 2 x S 128, page 16, budget
    64)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import CacheConfig as JCacheConfig
    from repro.configs import get_arch as jget_arch
    from repro.core import get_policy as jget_policy
    from repro.models.transformer import decode_step as jdecode
    from repro.models.transformer import forward_prefill as jprefill
    from repro.models.transformer import init_decode_caches as jcaches
    from repro.models.transformer import init_model as jinit
    from repro.training import AdamWConfig as JAdamWConfig
    from repro.training import init_adamw as jadamw
    from repro.training import make_train_step as jstep
    cfg = dataclasses.replace(jget_arch(arch).reduced(), dtype="float32")
    ccfg = JCacheConfig(page_size=16, cache_budget=64, dtype="float32")
    pol = jget_policy("paged_eviction")
    params = jax.eval_shape(partial(jinit, cfg=cfg), jax.random.PRNGKey(0))
    K = cfg.num_codebooks
    tok = jax.ShapeDtypeStruct((B, K, S) if K > 1 else (B, S), jnp.int32)
    dtok = jax.ShapeDtypeStruct((B, K) if K > 1 else (B,), jnp.int32)
    cond = jax.ShapeDtypeStruct((B, cfg.cond_len, cfg.d_model),
                                jnp.float32) if cfg.cross_attention else None
    cache = jax.eval_shape(partial(jcaches, cfg, B, S, pol, ccfg))
    batch = {"tokens": tok, "targets": tok,
             "mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
    step = jstep(cfg, JAdamWConfig())
    progs = {
        "prefill": (lambda p, t, c: jprefill(p, cfg, t, pol, ccfg, cond=c),
                    (params, tok, cond)),
        "decode": (lambda p, t, ca: jdecode(p, cfg, t, ca, pol, ccfg),
                   (params, dtok, cache)),
        "train": (lambda p, o, b, c: step(p, o, b, cond=c),
                  (params, jax.eval_shape(jadamw, params), batch, cond)),
    }
    return {k: _dot_flops(jax.make_jaxpr(f)(*a).jaxpr)
            for k, (f, a) in progs.items()}


def _port_flops(arch: str) -> dict:
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    ccfg = CacheConfig(page_size=16, cache_budget=64, dtype="float32")
    pol = get_policy("paged_eviction")
    params = init_model(cfg, device="meta")
    K = cfg.num_codebooks
    z = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device="meta")
    tok = z(B, K, S) if K > 1 else z(B, S)
    dtok = z(B, K) if K > 1 else z(B)
    cond = torch.zeros((B, cfg.cond_len, cfg.d_model), device="meta") \
        if cfg.cross_attention else None
    out = {}
    with analysis.StepCounter(1) as c:
        forward_prefill(params, cfg, tok, pol, ccfg, cond=cond)
    out["prefill"] = c.flops
    cache = init_decode_caches(cfg, B, S, pol, ccfg, device="meta")
    with analysis.StepCounter(1) as c:
        decode_step(params, cfg, dtok, cache, pol, ccfg)
    out["decode"] = c.flops
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": tok, "targets": tok,
             "mask": torch.zeros((B, S), device="meta")}
    with analysis.StepCounter(1) as c:
        make_train_step(cfg, AdamWConfig())(params, init_adamw(params),
                                            batch, cond=cond)
    out["train"] = c.flops
    return out


def _cross_kv_flops(cfg) -> int:
    """The conditioning K/V projections of every cross-attention layer."""
    cfg = get_arch(cfg).reduced()
    width = cfg.num_kv_heads * cfg.resolved_head_dim
    per = 2 * 2 * B * cfg.cond_len * cfg.d_model * width
    return per * sum(s.mixer == "attn" for s in cfg.layer_specs())


def _in_proj_flops(arch) -> int:
    """One pass of mamba's input projection over the batch's tokens."""
    cfg = get_arch(arch).reduced()
    return 2 * B * S * cfg.d_model * 2 * cfg.mamba_d_inner


# JAX's jaxpr holds matmuls the port's program does not run: (arch,
# program) -> their FLOPs. musicgen's prefill projects each layer's
# conditioning K/V twice (once for its cross block, once for the cache;
# the port keeps the first); jamba's train step runs one more pass of a
# mamba input projection
JAX_EXTRA = {("musicgen-medium", "prefill"): _cross_kv_flops,
             ("jamba-1.5-large-398b", "train"): _in_proj_flops}


@pytest.fixture(scope="module")
def flops():
    return {a: (_jax_flops(a), _port_flops(a)) for a in FLOP_ARCHS}


@pytest.mark.parametrize("program", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_matmul_flops_match_jax(flops, arch, program):
    jax_f, port_f = flops[arch]
    extra = JAX_EXTRA.get((arch, program), lambda _: 0)(arch)
    assert port_f[program] + extra == jax_f[program], (
        arch, program, port_f[program], jax_f[program], extra)
    if arch == "llama-3.2-1b" and program == "prefill":
        assert port_f[program] == 638058496


# ------------------------------------------------------------ regions

def _grid_counts(arch: str, kind: str, tp: int = 1) -> dict:
    """The counted prefill or decode of the reduced f32 ``arch`` on one
    device and on a fake (2, 2) grid (B 4, S 128)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(tp=tp),
                              dtype="float32")
    shape = ShapeConfig("case", 128, 4, kind)
    one = {}
    with fake_group(4):
        grid = dryrun.fake_grid((2, 2), ("data", "model"))
        r = dryrun.run_one(arch, "prefill_32k", "single", "paged_eviction",
                           64, 16, False, None, verbose=False,
                           cache_dtype="float32", grid=grid, cfg=cfg,
                           shape=shape)
    pol = get_policy("paged_eviction")
    ccfg = dryrun.make_cache_cfg("paged_eviction", 64, 16, "float32")
    params = init_model(cfg, device="meta")
    with analysis.StepCounter(1) as c:
        if kind == "prefill":
            forward_prefill(params, cfg, torch.zeros(
                (4, 128), dtype=torch.int32, device="meta"), pol, ccfg,
                total_seq_hint=128)
        else:
            decode_step(params, cfg, torch.zeros((4,), dtype=torch.int32,
                                                 device="meta"),
                        init_decode_caches(cfg, 4, 128, pol, ccfg,
                                           device="meta"), pol, ccfg)
    one["flops"] = c.flops
    return {"grid": r, "one": one, "cfg": cfg}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch,tp", [("llama-3.2-1b", 1), ("qwen2.5-3b", 2),
                                     ("mixtral-8x7b", 1)])
def test_grid_flops_equal_one_device(arch, tp, kind):
    """The regions' local FLOPs times the ranks that run them, plus the
    DTensor operations' global FLOPs, equal the one-device count: the
    attention (KV heads whole, qwen's split) and the MLP split their work.
    mixtral's MoE regions run the router on every model rank's copy of
    its rows, and the decode's dense combine weighs each model rank's
    partial expert outputs (summed after the combine): the excess is the
    router, and in decode the combine, once more (two model ranks)."""
    r = _grid_counts(arch, kind, tp)
    got = r["grid"]["flops_per_device"] * r["grid"]["chips"]
    want = r["one"]["flops"]
    cfg = r["cfg"]
    extra = 0
    if cfg.num_experts:
        tokens = 4 * (128 if kind == "prefill" else 1)
        moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
        extra = moe * 2 * tokens * cfg.d_model * cfg.num_experts * (
            1 if kind == "prefill" else 2)
    assert got == want + extra, (arch, kind, got, want, extra)


def test_argument_bytes_are_the_rules_shards():
    """argument_size_in_bytes is the sum over every input leaf of its
    bytes over the product of the axes its spec splits it over."""
    r = _grid_counts("llama-3.2-1b", "decode")
    cfg = r["cfg"]
    grid = mesh.abstract_grid((2, 2), ("data", "model"))

    def split(spec):
        return rules.axis_size(grid, *[a for e in spec
                                       for a in rules.axes_of(e)])
    meta = init_model(cfg, device="meta")
    per_leaf = []
    rules._zip_tree(rules.param_shardings(grid, cfg, meta), meta,
                    lambda s, t: per_leaf.append(
                        t.numel() * t.element_size() // split(s)))
    want = sum(per_leaf)
    want += 4 * 4 // split(rules.data_shardings(
        grid, {"t": torch.zeros(4)})["t"])            # the (4,) int32 tokens
    whole = init_decode_caches(cfg, 4, 128, get_policy("paged_eviction"),
                               dryrun.make_cache_cfg("paged_eviction", 64,
                                                     16, "float32"),
                               device="meta")
    for path, spec in rules.cache_shardings(grid, cfg, whole, 4).items():
        leaf = dict(rules._cache_leaves(whole))[path]
        n = leaf.numel() * leaf.element_size()
        if path.rsplit("/", 1)[-1] in rules._JAX_NAME:
            n -= n // leaf.shape[0]           # the trash row is left out
        want += n // split(spec)
    assert r["grid"]["memory_analysis"]["argument_size_in_bytes"] == want


def test_temp_counts_only_the_storages_a_step_creates():
    """A view or an in-place update of an argument adds nothing to the
    temp (the argument is counted as such); a new tensor adds its
    bytes."""
    x = torch.zeros(64, 32)
    with analysis.StepCounter(1) as c:
        x.t()
        x[:8]
        x.add_(1)
    assert c.temp_bytes == 0
    with analysis.StepCounter(1) as c:
        y = (x + 1).t()
    assert c.temp_bytes == y.nbytes


def test_ring_traffic_matches_jax_parse_collectives():
    from repro.launch.analysis import parse_collectives
    recs = [("all-gather", list(range(16)), "float32", (16, 1024), 65536),
            ("all-reduce", list(range(0, 256, 16)), "bfloat16", (8, 128),
             2048),
            ("reduce-scatter", list(range(16)), "float32", (64,), 256),
            ("all-to-all", list(range(8)), "bfloat16", (8, 64), 1024)]
    hlo = "\n".join([
        "  %a = f32[16,1024]{1,0} all-gather(f32[1,1024]{1,0} %x), "
        "replica_groups=[16,16]<=[256]",
        "  %b = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %y), "
        "replica_groups=[16,16]<=[256]",
        "  %c = f32[64]{0} reduce-scatter(f32[1024]{0} %z), "
        "replica_groups=[16,16]<=[256]",
        "  %d = bf16[8,64]{1,0} all-to-all(bf16[8,64]{1,0} %w), "
        "replica_groups=[32,8]<=[256]"])
    want = parse_collectives(hlo)
    got = analysis.collective_stats(recs)
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.traffic_bytes == pytest.approx(want.traffic_bytes, rel=1e-12)
    # NVLink inside a node of 8, InfiniBand across
    assert analysis.intra_node(range(8)) and not analysis.intra_node(
        range(0, 256, 16))


def test_serve_tp_collectives_are_the_step_inventory():
    from repro_torch.launch.inspect_collectives import serving_records
    cfg = get_arch("qwen2.5-3b").reduced(tp=2)
    with fake_group(2):
        recs = serving_records("qwen2.5-3b", 2, "paged_eviction", 32, 4)
    for name, kw in (("mixed", dict(has_decode=False, has_prefill=True)),
                     ("decode", dict(has_decode=True, has_prefill=False))):
        cs = analysis.collective_set(recs[name])
        want = mesh.step_collectives(cfg, "paged_eviction",
                                     fused_scores=False, metrics=True, **kw)
        assert set(cs["counts"]) == {"all-reduce"}, cs
        assert cs["counts"]["all-reduce"] == sum(want.values()), (name, cs,
                                                                  want)
        assert all(s.startswith("all-reduce group=2 ")
                   for s in cs["signatures"])


def test_dryrun_all_exits_nonzero_on_a_failure(tmp_path):
    """``--all`` reports FAIL per combination and exits non-zero at the
    end: one combination runs (llama at long_500k), one cannot (an
    unknown shape)."""
    code = ("import sys; from repro_torch.launch import dryrun as d; "
            "d.ASSIGNED_ARCHS = {'llama-3.2-1b': None}; "
            "d.SHAPES = {'long_500k': None, 'no_such_shape': None}; "
            "d.default_policy = lambda s: 'paged_eviction'; "
            f"d.main(['--all', '--out', {str(tmp_path)!r}])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                       capture_output=True, timeout=600)
    assert p.returncode != 0, p.stdout + p.stderr
    assert "llama-3.2-1b_long_500k_single_paged_eviction: OK" in p.stdout
    assert "no_such_shape" in p.stdout and "FAIL" in p.stdout
    assert (tmp_path / "llama-3.2-1b_long_500k_single_paged_eviction.json"
            ).is_file()


# ------------------------------------------------------------ parity

GRID_2D = ((2, 2), ("data", "model"))
GRID_EP = ((1, 2, 2), ("data", "expert", "tp"))
PARITY = {"llama-f32": ("llama-3.2-1b", "float32", GRID_2D),
          "llama-int8": ("llama-3.2-1b", "int8", GRID_2D),
          "mixtral": ("mixtral-8x7b", "float32", GRID_2D),
          "mixtral-ep": ("mixtral-8x7b", "float32", GRID_EP),
          "musicgen": ("musicgen-medium", "float32", GRID_2D)}
PB, PS, STEPS = 4, 80, 4
LENS = (80, 64, 72, 70)
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")
JAX_ATOL = 1e-4        # the port against JAX in f32 (test_torch_oneshot's)
# an int8 pool against JAX: a K/V value whose f32 input lands on the other
# side of a rounding boundary in one program moves by one step (1/127 of
# its head's largest |value|), which moves the decode logits by up to that
# share of the largest; at most INT8_FLIPS of the payload may differ
INT8_RTOL, INT8_FLIPS = 1 / 127, 1e-2


def _ccfg_kw(cache_dtype: str) -> dict:
    return dict(page_size=8, cache_budget=32, dtype=cache_dtype)


def _inputs(arch: str) -> dict:
    """The parity runs' inputs, numpy, from a seed: four right-padded
    prompts of LENS tokens, the conditioning (or None) and the STEPS
    decode steps' tokens (fed, not drawn from the logits, so that every
    run decodes the same tokens)."""
    from repro_torch.models.multimodal import decode_token_shape, token_shape
    cfg = get_arch(arch).reduced()
    rng = np.random.default_rng(3)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, token_shape(
            cfg, PB, PS)).astype(np.int32),
        "valid": np.arange(PS)[None] < np.array(LENS)[:, None],
        "cond": rng.standard_normal((PB, cfg.cond_len, cfg.d_model)).astype(
            np.float32) if cfg.cross_attention else None,
        "feed": rng.integers(0, cfg.vocab_size, (STEPS,) + decode_token_shape(
            cfg, PB)).astype(np.int32)}


def _pool_state(layers: list) -> dict:
    """{layer/field: array} of the page pools among per-layer field dicts
    (``convert.layer_cache_to_numpy``'s)."""
    return {f"{i}/{f}": a for i, c in enumerate(layers) if "block_table" in c
            for f, a in c.items() if a is not None and f != "stats"}


def _oneshot(arch: str, cache_dtype: str, grid=None, jtree=None) -> dict:
    """The reduced arch's prefill of four right-padded prompts (with its
    conditioning, if any) and STEPS decode steps (on ``grid`` when given):
    every step's logits and the final pool state, whole. Without
    ``jtree``: the port's weights (seed 0), its ``make_inputs`` (seed 3)
    and greedy decoding. With ``jtree``: JAX's weights and
    :func:`_inputs`."""
    from repro_torch.convert import cache_to_numpy, params_from_jax
    from repro_torch.models.multimodal import make_inputs
    cfg = get_arch(arch).reduced()
    ccfg = CacheConfig(**_ccfg_kw(cache_dtype))
    if jtree is None:
        params = init_model(cfg, seed=0, device="cpu")
        inp = make_inputs(torch.Generator().manual_seed(3), cfg, PB, PS,
                          "cpu")
        inp["valid"] = torch.arange(PS)[None] < torch.tensor(LENS)[:, None]
        inp["feed"] = None
    else:
        params = params_from_jax(jtree, cfg, device="cpu")
        inp = {k: None if v is None else torch.from_numpy(v)
               for k, v in _inputs(arch).items()}
    pol = get_policy(ccfg.policy)
    ac = None
    if grid is not None:
        params = rules.distribute(grid, params,
                                  rules.param_shardings(grid, cfg, params))
        ac = rules.activation_constraint(grid, PB)
    logits, cache = forward_prefill(params, cfg, inp["tokens"], pol, ccfg,
                                    valid=inp["valid"], cond=inp["cond"],
                                    total_seq_hint=PS + STEPS, ac=ac)
    out = {"logits": [rules.full(logits).numpy()]}
    for i in range(STEPS):
        tok = torch.argmax(rules.full(logits), -1).to(torch.int32) \
            if inp["feed"] is None else inp["feed"][i]
        logits, cache = decode_step(params, cfg, tok, cache, pol, ccfg,
                                    ac=ac)
        out["logits"].append(rules.full(logits).numpy())
    whole = cache_to_numpy(rules.whole_cache(cache))
    out["state"] = _pool_state(whole["layers"])
    out["cur_pos"] = whole["cur_pos"]
    out["pool_bytes"] = sum(out["state"][k].nbytes for k in out["state"]
                            if k.endswith(("/k", "/v")))
    if grid is not None:
        # the bytes each rank holds: a shard that is a view of a larger
        # buffer keeps all of it
        out["local_pool_bytes"] = sum(
            t.to_local().untyped_storage().nbytes()
            for c in cache.layers for t in (c.k_buf, c.v_buf))
    return out


def _parity_rank(group, jtrees):
    """Each case on its grid twice: on the port's weights and inputs
    (against one device) and on JAX's (against JAX), under ``case`` and
    ``case/jax``."""
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    grids = {g: mesh.make_grid(*g, device="cpu") for g in (GRID_2D, GRID_EP)}
    out = {}
    for case, (arch, dt, g) in PARITY.items():
        out[case] = _oneshot(arch, dt, grids[g])
        out[f"{case}/jax"] = _oneshot(arch, dt, grids[g], jtrees[arch])
    return out


def _jax_tree(arch: str) -> dict:
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models.transformer import init_model as jinit_model
    return jax.device_get(jinit_model(jax.random.PRNGKey(0),
                                      jget_arch(arch).reduced()))


def _jax_main(trees_path: str, out_path: str) -> None:
    """JAX's own sharded one-shot path on each case: 4 host devices on a
    mesh of ``Auto`` axes, the parameters placed by its
    ``param_shardings``, ``forward_prefill(ac=)`` and STEPS
    ``decode_step(ac=)`` over the cache placed by its ``cache_shardings``;
    every step's logits and the final pool state."""
    import pickle

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import CacheConfig as JCacheConfig
    from repro.configs import get_arch as jget_arch
    from repro.core.policies import get_policy as jget_policy
    from repro.models import transformer as jtf
    from repro.sharding import rules as jrules
    from repro_torch.convert import jax_cache_layers, layer_cache_to_numpy
    with open(trees_path, "rb") as f:
        trees = pickle.load(f)
    res = {}
    for case, (arch, dt, (shape, axes)) in PARITY.items():
        cfg = jget_arch(arch).reduced()
        ccfg = JCacheConfig(**_ccfg_kw(dt))
        pol = jget_policy(ccfg.policy)
        m = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(
            axes))
        ac = jrules.activation_constraint(m, PB)
        params = jax.tree.map(jnp.asarray, trees[arch])
        params = jax.device_put(params, jrules.param_shardings(m, cfg,
                                                                params))
        inp = _inputs(arch)
        prefill = jax.jit(lambda p, t, v, c: jtf.forward_prefill(
            p, cfg, t, pol, ccfg, cond=c, valid=v, ac=ac,
            total_seq_hint=PS + STEPS))
        logits, cache = prefill(params, inp["tokens"], inp["valid"],
                                inp["cond"])
        c_sh = jrules.cache_shardings(m, cfg, cache, PB)
        cache = jax.device_put(cache, c_sh)
        decode = jax.jit(lambda p, t, c: jtf.decode_step(
            p, cfg, t, c, pol, ccfg, ac=ac), out_shardings=(None, c_sh))
        out = {"logits": [np.asarray(logits)]}
        for tok in inp["feed"]:
            logits, cache = decode(params, jnp.asarray(tok), cache)
            out["logits"].append(np.asarray(logits))
        cache = jax.device_get(cache)
        out["state"] = _pool_state([layer_cache_to_numpy(c) for c in
                                    jax_cache_layers(cache,
                                                     cfg.pattern_period)])
        out["cur_pos"] = np.asarray(cache.cur_pos)
        res[case] = out
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """(each rank's grid runs, the one-device runs, JAX's sharded runs);
    JAX in a subprocess beside the four gloo ranks."""
    import pickle
    tmp = tmp_path_factory.mktemp("parity")
    jtrees = {a: _jax_tree(a) for a in {a for a, _, _ in PARITY.values()}}
    with open(tmp / "trees.pkl", "wb") as f:
        pickle.dump(jtrees, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    code = (f"import test_torch_dryrun as t; t._jax_main("
            f"{str(tmp / 'trees.pkl')!r}, {str(tmp / 'jax.pkl')!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        ranks = mesh.run_ranks(_parity_rank, 4, jtrees, device="cpu")
        one = {case: _oneshot(arch, dt)
               for case, (arch, dt, _) in PARITY.items()}
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        with open(tmp / "jax.pkl", "rb") as f:
            jax_res = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return ranks, one, jax_res


@pytest.mark.parametrize("case", list(PARITY))
def test_sharded_oneshot_equals_one_device(parity, case):
    """Every rank's logits within 1e-5 (relative to the largest) of one
    device's at the prefill and each decode step; the integer pool state
    (and an int8 pool's payload) bit-equal; each rank holds a quarter of
    the pool."""
    ranks, one, _ = parity
    want = one[case]
    for rank, r in enumerate(ranks):
        got = r[case]
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            err = float(np.abs(g - w).max() / np.abs(w).max())
            assert err <= 1e-5, (case, rank, i, err)
        np.testing.assert_array_equal(got["cur_pos"], want["cur_pos"])
        for k, w in want["state"].items():
            if k.endswith(INT_FIELDS) or w.dtype == np.int8:
                assert np.array_equal(got["state"][k], w), (case, rank, k)
        assert got["local_pool_bytes"] * 4 == want["pool_bytes"], (
            case, rank, got["local_pool_bytes"], want["pool_bytes"])


@pytest.mark.parametrize("case", list(PARITY))
def test_sharded_oneshot_equals_jax(parity, case):
    """Every rank's sharded run against JAX's own sharded
    ``forward_prefill(ac=)`` / ``decode_step(ac=)`` on the same weights,
    inputs and grid: logits within JAX_ATOL at the prefill and each step,
    the integer pool state bit-equal, K/V and scores within JAX_ATOL. An
    int8 pool: its payload within one step (at most INT8_FLIPS of it
    differing), its scales within JAX_ATOL, its decode logits within
    INT8_RTOL of the largest."""
    ranks, _, jax_res = parity
    want = jax_res[case]
    int8 = PARITY[case][1] == "int8"
    for rank, r in enumerate(ranks):
        got = r[f"{case}/jax"]
        assert len(got["logits"]) == len(want["logits"]) == STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            if int8 and i:
                err = float(np.abs(g - w).max() / np.abs(w).max())
                assert err <= INT8_RTOL, (case, rank, i, err)
                continue
            np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL,
                                       err_msg=f"{case} rank {rank} {i}")
        np.testing.assert_array_equal(got["cur_pos"], want["cur_pos"])
        assert set(got["state"]) == set(want["state"]), case
        for k, w in want["state"].items():
            g = got["state"][k]
            if k.endswith(INT_FIELDS):
                np.testing.assert_array_equal(g, w, err_msg=f"{case} {k}")
            elif w.dtype == np.int8:
                d = np.abs(g.astype(int) - w.astype(int))
                assert d.max() <= 1 and d.mean() <= INT8_FLIPS, (
                    case, k, d.max(), d.mean())
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL,
                                           err_msg=f"{case} {k}")
