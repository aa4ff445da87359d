"""The one-shot path's spans (``repro_torch.obs.trace.annotation``) on the
CPU, on the reduced mistral-nemo-12b (dense) and mixtral-8x7b (MoE)
families:

- under a CPU profiler, one ``prefill`` holds L of each per-layer stage
  and one ``prefill.logits``; each ``decode.step`` holds L ``decode.qkv``,
  ``decode.append``, ``decode.evict``, ``decode.mlp``, 2 L ``decode.attn``
  (the attention between the write and the eviction, then ``wo``, which
  runs after the eviction) and one ``decode.logits``; the ``moe.*``
  stages sit inside ``prefill.mlp``, on mixtral only; the same tree over
  a fake (2, 2) grid, where the spans sit on the grid's own branches;
- with no profiler a span runs no aten op: a prefill and decode steps run
  the same ops, in order, and give the same logits, as with every span a
  plain nullcontext;
- the training path names no prefill or decode stage.
"""
import collections
import contextlib
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import CacheConfig, ShapeConfig, get_arch
from repro_torch.core import decode as decode_mod
from repro_torch.core.policies import get_policy
from repro_torch.launch import dryrun
from repro_torch.models import grid_oneshot, moe
from repro_torch.models import transformer as T
from repro_torch.obs import trace as otrace

ARCHS = ("mistral-nemo-12b", "mixtral-8x7b")
PREFIX = ("prefill", "decode", "moe")
STEPS = 3
LAYER_PREFILL = ("prefill.attn", "prefill.mlp", "prefill.compress")
LAYER_DECODE = ("decode.qkv", "decode.append", "decode.evict", "decode.mlp")
MOE = ("moe.dispatch", "moe.experts", "moe.combine")


def _setup(arch):
    cfg = get_arch(arch).reduced()
    params = T.init_model(cfg, seed=0, device="cpu")
    ccfg = CacheConfig(page_size=8, cache_budget=64,
                       policy="paged_eviction", dtype="float32")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 160), generator=gen,
                           dtype=torch.int32)
    valid = torch.ones_like(tokens, dtype=torch.bool)
    valid[1, 130:] = False
    return cfg, params, ccfg, get_policy(ccfg.policy), tokens, valid


def _run(arch):
    """A prefill past the budget and STEPS decode steps -> the logits."""
    cfg, params, ccfg, pol, tokens, valid = _setup(arch)
    logits, cache = T.forward_prefill(params, cfg, tokens, pol, ccfg,
                                      valid=valid, total_seq_hint=170)
    out = [logits]
    tok = logits.argmax(-1)
    for _ in range(STEPS):
        logits, cache = T.decode_step(params, cfg, tok, cache, pol, ccfg,
                                      decode_splits=2, fused_scores=True)
        out.append(logits)
        tok = logits.argmax(-1)
    return out


def _spans(prof) -> list:
    """(name, start ns, end ns) of the program's spans, outer first."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().split(".")[0] in PREFIX),
                  key=lambda t: (t[1], -t[2]))


def _inside(spans, outer) -> collections.Counter:
    _, s, e = outer
    return collections.Counter(n for n, a, b in spans
                               if s <= a and b <= e and (n, a, b) != outer)


def _check_prefill(spans, L, moe_layers):
    pre = [t for t in spans if t[0] == "prefill"]
    assert len(pre) == 1
    inner = _inside(spans, pre[0])
    want = {n: L for n in LAYER_PREFILL}
    want["prefill.logits"] = 1
    want.update({n: moe_layers for n in MOE if moe_layers})
    assert inner == want
    for t in spans:
        if t[0] in MOE:          # an MoE stage inside the layer's MLP half
            assert any(o[0] == "prefill.mlp" and o[1] <= t[1] and
                       t[2] <= o[2] for o in spans)


def _check_decode(spans, L, steps):
    dec = [t for t in spans if t[0] == "decode.step"]
    assert len(dec) == steps
    for step in dec:
        want = {n: L for n in LAYER_DECODE}
        want.update({"decode.attn": 2 * L, "decode.logits": 1})
        assert _inside(spans, step) == want
        inner = [t for t in spans if step[1] <= t[1] and t[2] <= step[2]]
        # per layer: qkv, append, attention, evict, wo, mlp, in that order
        order = [n for n, _, _ in inner[1:-1]]
        assert order == ["decode.qkv", "decode.append", "decode.attn",
                         "decode.evict", "decode.attn", "decode.mlp"] * L


@pytest.mark.parametrize("arch", ARCHS)
def test_span_tree(arch):
    cfg = get_arch(arch).reduced()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(arch)
    spans = _spans(prof)
    L = cfg.num_layers
    moe_layers = sum(s.mlp == "moe" for s in cfg.layer_specs())
    assert (moe_layers > 0) == (arch == "mixtral-8x7b")
    _check_prefill(spans, L, moe_layers)
    _check_decode(spans, L, STEPS)
    assert {n for n, _, _ in spans} <= set(
        ("prefill", "prefill.logits", "decode.step", "decode.attn",
         "decode.logits") + LAYER_PREFILL + LAYER_DECODE + MOE)


class _Ops(TorchDispatchMode):
    """Record the aten ops run under the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_run_no_op_without_a_profiler(arch, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert otrace.annotation("decode.step") is otrace.annotation("x")
    with _Ops() as spanned:
        got = _run(arch)
    for mod in (T, decode_mod, moe, grid_oneshot):
        monkeypatch.setattr(mod, "annotation",
                            lambda name: contextlib.nullcontext())
    with _Ops() as plain:
        want = _run(arch)
    assert len(spanned.ops) > 1000
    assert spanned.ops == plain.ops
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@contextlib.contextmanager
def _fake_group(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("grid_shape,axes", [
    ((2, 2), ("data", "model")), ((1, 2, 2), ("data", "expert", "tp"))])
def test_span_tree_over_a_grid(grid_shape, axes):
    """mixtral's one-shot prefill and a decode step over a fake grid on
    meta: the (data, model) region and the expert-parallel one."""
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                              dtype="float32")
    L = cfg.num_layers
    with _fake_group(4):
        grid = dryrun.fake_grid(grid_shape, axes)
        for kind in ("prefill", "decode"):
            fn, args = dryrun.build_step(
                "mixtral-8x7b", "prefill_32k", grid, "paged_eviction", 64,
                16, False, "float32", cfg=cfg,
                shape=ShapeConfig("case", 128, 4, kind))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fn(*args)
            spans = _spans(prof)
            if kind == "prefill":
                _check_prefill(spans, L, L)
            else:
                _check_decode(spans, L, 1)


def test_training_names_no_oneshot_stage():
    cfg = get_arch("mistral-nemo-12b").reduced()
    params = T.init_model(cfg, seed=0, device="cpu")
    tokens = torch.zeros((2, 32), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.forward_train(params, cfg, tokens, remat=False)
    assert _spans(prof) == []
