"""Tensor-parallel serving of the torch port, on the CPU: gloo ranks (one
spawned process each, joined through a FileStore in a temporary directory,
short timeouts), against the port at tp = 1, the JAX engine at tp = 1 and
the JAX engine's own ``Engine(tp=2)``.

The serving cases run the JAX TP suite's workload (tests/test_tp_serving.py:
the same reduced(tp=4) config at every degree, shared-prefix churn with
adoption, forks, eviction and slot reuse): gemma3-27b under paged_eviction,
streaming_llm and full on f32 and int8 pools, mixtral-8x7b (MoE), and, held
to the port's tp = 1 only, paged_eviction with the fused page scores,
keydiff and inverse_key_l2. Every case runs once per degree: one spawn of 2
ranks and one of 4 run them all. The JAX engine runs in subprocesses (one
CPU device each for tp = 1, two for its tp = 2), started first so that
their compiles overlap the port's runs.

Held at every step: greedy tokens, the devstats vector, the replicated
integer pool state (``pos``, ``block_table``, ``ref_count``, ``cur_page``,
``cur_off``: every eviction victim) equal, f32 page scores within 1e-6,
the ranks' metadata equal to each other and F1-F4 on each; each rank's
collectives against ``mesh.step_collectives`` (all-reduces only); at the
end each rank's K/V within 1e-5 of its slice of the tp = 1 pool.

This module imports no JAX at its top: the spawned ranks import it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from collections import Counter
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, CacheConfig, ModelConfig, get_arch
from repro_torch.convert import params_from_jax, shard_cache_from_jax
from repro_torch.core.policies import get_policy
from repro_torch.launch import mesh
from repro_torch.models.transformer import (init_decode_caches, init_model,
                                            paged_layers)
from repro_torch.obs import ObsConfig
from repro_torch.serving import Engine, SamplingParams
from repro_torch.serving import engine as engine_mod
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = timedelta(seconds=60)      # a mismatched collective fails fast
META = ("pos", "score", "block_table", "ref_count", "cur_page", "cur_off")
INT_META = ("pos", "block_table", "ref_count", "cur_page", "cur_off")
# name -> (arch, policy, pool dtype, fused page scores)
CASES = {
    "paged_eviction-f32": ("gemma3-27b", "paged_eviction", "float32", False),
    "paged_eviction-int8": ("gemma3-27b", "paged_eviction", "int8", False),
    "streaming_llm-f32": ("gemma3-27b", "streaming_llm", "float32", False),
    "streaming_llm-int8": ("gemma3-27b", "streaming_llm", "int8", False),
    "full-f32": ("gemma3-27b", "full", "float32", False),
    "full-int8": ("gemma3-27b", "full", "int8", False),
    "mixtral-f32": ("mixtral-8x7b", "paged_eviction", "float32", False),
    "fused-f32": ("gemma3-27b", "paged_eviction", "float32", True),
    "keydiff-f32": ("gemma3-27b", "keydiff", "float32", False),
    "inverse_key_l2-f32": ("gemma3-27b", "inverse_key_l2", "float32", False),
}
JAX_CASES = list(CASES)[:7]          # the JAX engine takes no fused scores
                                     # without its Pallas kernels
PORT_ONLY = list(CASES)[7:]          # tp 2 only
JAX_TP2 = ["paged_eviction-f32", "paged_eviction-int8"]
ENGINE = dict(max_batch=3, max_prompt_len=40, max_new_tokens=8,
              chunk_size=16, seed=0)
TPS = (2, 4)


def _cfg(arch: str) -> ModelConfig:
    """Every degree serves the same reduced(tp=4) config, as in JAX."""
    return get_arch(arch).reduced(tp=4)


def _ccfg(case: str) -> CacheConfig:
    _, policy, dtype, _ = CASES[case]
    return CacheConfig(page_size=4, cache_budget=24, policy=policy,
                       dtype=dtype)


def _prompts(vocab: int, seed: int = 0, n_reqs: int = 6) -> list:
    """The JAX suite's ``_submit_churn``: a 16-token shared prefix, tails
    of 8 + i tokens, more requests than slots."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16)
    return [np.concatenate([shared, rng.integers(0, vocab, size=8 + i)])
            .astype(np.int32) for i in range(n_reqs)]


def _meta(layers) -> list:
    return [{f: getattr(c, f).cpu().numpy().copy() for f in META}
            for c in layers]


def _serve(eng, group=None) -> dict:
    """Serve the churn to completion, recording per step the devstats,
    the pool metadata, whether a forward step ran with decode / prefill
    rows, and this rank's collectives by kind."""
    flags = []
    real = engine_mod.forward_step

    def spy(*args, **kw):
        flags.append((bool(kw["decode_mask"].any()),
                      bool(kw["prefill_mask"].any())))
        return real(*args, **kw)

    engine_mod.forward_step = spy
    try:
        for p in _prompts(eng.cfg.vocab_size):
            eng.submit(p)
        steps, more = [], True
        while more:
            before = Counter(group.counts) if group else Counter()
            ran = len(flags)
            more = eng.step()
            assert len(steps) < 300, "engine did not finish"
            after = Counter(group.counts) if group else Counter()
            ran = flags[ran] if len(flags) > ran else None
            steps.append({"ran": ran, "stats": eng.last_stats.copy()
                          if ran is not None else np.zeros_like(
                              eng.last_stats),
                          "meta": _meta(paged_layers(eng.cache.layers)),
                          "coll": dict(after - before)})
    finally:
        engine_mod.forward_step = real
    pools = paged_layers(eng.cache.layers)
    return {"tokens": {r.request_id: list(r.output_tokens)
                       for r in eng.scheduler.finished},
            "steps": steps, "pool_bytes": eng.pool_bytes(),
            "pages_evicted": eng.stats.pages_evicted,
            "kv": [{f: getattr(c, f).numpy().copy()
                    for f in ("k", "v", "k_scale", "v_scale")
                    if getattr(c, f) is not None} for c in pools]}


def _port_engine(case: str, jparams: dict, group=None):
    arch, _, _, fused = CASES[case]
    cfg = _cfg(arch)
    return Engine(cfg, params_from_jax(jparams, cfg, device="cpu"),
                  cache_cfg=_ccfg(case), sampling=SamplingParams(greedy=True),
                  fused_scores=fused, device="cpu", tp_group=group, **ENGINE)


def _rank_cases(group, cases: list, jparams: dict) -> dict:
    """One rank: every case through the tp engine, with the raw
    ``torch.distributed`` calls counted by name beside the group's."""
    torch.set_num_threads(1)            # tiny shapes: threads cost more
    raw = Counter()
    names = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "all_to_all_single", "reduce", "gather",
             "scatter", "barrier")
    real = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            raw[name] += 1
            return real[name](*args, **kw)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    try:
        out = {c: _serve(_port_engine(c, jparams[CASES[c][0]], group), group)
               for c in cases}
    finally:
        for n in names:
            setattr(dist, n, real[n])
    out["raw"] = dict(raw)
    out["counts"] = dict(group.counts)
    out["backend"] = dist.get_backend()
    return out


# ------------------------------------------------- the JAX engine (subprocess)

def _jax_main(cases: list, tp: int, params: str, out: str) -> None:
    """Serve ``cases`` on the JAX engine at ``tp`` (the weights pickled at
    ``params``) and pickle, per case, what :func:`_serve` records (the
    collectives aside)."""
    import jax

    from repro.configs import CacheConfig as JCacheConfig
    from repro.configs import get_arch as jget_arch
    from repro.core import devstats as jdevstats
    from repro.serving import Engine as JEngine
    from repro.serving import SamplingParams as JSamplingParams
    from repro_torch.convert import jax_cache_layers

    with open(params, "rb") as f:
        jparams = pickle.load(f)
    res = {}
    for case in cases:
        arch = CASES[case][0]
        jcfg = jget_arch(arch).reduced(tp=4)
        eng = JEngine(jcfg, jparams[arch],
                      cache_cfg=JCacheConfig(**dataclasses.asdict(
                          _ccfg(case))),
                      sampling=JSamplingParams(greedy=True), tp=tp, **ENGINE)
        for p in _prompts(jcfg.vocab_size):
            eng.submit(p)
        reg = eng.obs.registry
        prev = np.zeros(jdevstats.NSTATS, np.int64)
        steps, more = [], True
        while more:
            more = eng.step()
            cum = np.array([reg.counter(f"pool.{n}").value
                            for n in jdevstats.STAT_NAMES])
            layers = jax_cache_layers(jax.device_get(eng.cache),
                                      jcfg.pattern_period)
            steps.append({"stats": cum - prev, "meta": [
                {f: np.asarray(getattr(c, f)) for f in META}
                for c in layers]})
            prev = cum
        res[case] = {"tokens": {r.request_id: list(r.output_tokens)
                                for r in eng.scheduler.finished},
                     "steps": steps, "pool_bytes": eng.pool_bytes(),
                     "cache": jax.device_get(eng.cache)}
        eng.close()
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _jax_params(arch: str) -> dict:
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models.transformer import init_model as jinit_model
    return jax.device_get(jinit_model(jax.random.PRNGKey(0),
                                      jget_arch(arch).reduced(tp=4)))


def _start_jax(cases: list, tp: int, params: Path, out: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    if tp > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={tp}"
    code = (f"import test_torch_tp as t; t._jax_main({cases!r}, {tp}, "
            f"{str(params)!r}, {str(out)!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX engine at tp 1 (and tp 2 for JAX_TP2), the
    port at tp 1 in this process, the port's ranks at tp 2 and 4."""
    tmp = tmp_path_factory.mktemp("tp")
    jparams = {a: _jax_params(a) for a in ("gemma3-27b", "mixtral-8x7b")}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(jparams, f)
    groups = [(JAX_CASES[0:2], 1), (JAX_CASES[2:4], 1), (JAX_CASES[4:7], 1),
              (JAX_TP2, 2)]
    procs = [(tmp / f"jax{i}.pkl", _start_jax(c, tp, tmp / "params.pkl",
                                              tmp / f"jax{i}.pkl"))
             for i, (c, tp) in enumerate(groups)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # tiny shapes: threads cost more
    try:
        port1 = {c: _serve(_port_engine(c, jparams[CASES[c][0]]))
                 for c in CASES}
        ranks = {tp: mesh.run_ranks(
            _rank_cases, tp, JAX_CASES + (PORT_ONLY if tp == 2 else []),
            jparams, device="cpu", timeout=TIMEOUT) for tp in TPS}
        jax1, jax2 = {}, {}
        for (path, p), (_, tp) in zip(procs, groups):
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, log[-4000:]
            with open(path, "rb") as f:
                (jax2 if tp == 2 else jax1).update(pickle.load(f))
    finally:
        torch.set_num_threads(threads)
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"jparams": jparams, "port1": port1, "ranks": ranks,
            "jax1": jax1, "jax2": jax2}


# ----------------------------------------------------------------- helpers

def _assert_pool_invariants(md: dict, ctx: str) -> None:
    """F1-F4 (tests/test_pool_invariants.py) over one rank's metadata."""
    ref, bt, pos = md["ref_count"], md["block_table"], md["pos"]
    mapped = bt[bt >= 0]
    for b in range(bt.shape[0]):                  # F3: no double mapping
        row = bt[b][bt[b] >= 0]
        assert len(row) == len(set(row.tolist())), (ctx, b, "double-mapped")
    np.testing.assert_array_equal(np.bincount(mapped, minlength=len(ref)),
                                  ref, err_msg=f"{ctx}: refcounts")   # F2
    assert (ref >= 0).all(), (ctx, "refcount underflow")
    assert int((ref > 0).sum()) == len(set(mapped.tolist())), (
        ctx, "conservation")                                           # F1
    assert (pos[ref == 0] == -1).all(), (ctx, "free page holds tokens")  # F4


# (rtol, atol) of the page scores: f32 within 1e-6. On an int8 pool, an
# element whose scaled value lies within an f32 rounding of a half step
# quantizes either way under tp's other summation order: one step, 1/127 of
# its head's absmax. The attention over it, and so the next layers' keys,
# scales and scores, then move by a fraction of that step (up to 1.3e-4
# relative seen): there the int8 values are held within one step, and the
# scales and scores within one step relative (1/127).
STEP8 = 1 / 127
SCORE_TOL = {"float32": (0, 1e-6), "int8": (STEP8, 0)}


def _split(got: dict, want: dict):
    """(step, layer) of the first step whose integer pool state differs
    between two runs, or None."""
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        for li, (gm, wm) in enumerate(zip(g["meta"], w["meta"])):
            if any(not np.array_equal(gm[f], wm[f]) for f in INT_META):
                return i, li
    return None


def _tie_gap(got: dict, want: dict, step: int, layer: int):
    """The scores of the tokens that two runs evicted differently at
    (step, layer), each from the run that kept it -> (their spread, the
    f32 spacing at their magnitude)."""
    gm, wm = got["steps"][step]["meta"][layer], \
        want["steps"][step]["meta"][layer]
    sc = np.concatenate([gm["score"][(gm["pos"] >= 0) & (wm["pos"] < 0)],
                         wm["score"][(wm["pos"] >= 0) & (gm["pos"] < 0)]])
    assert len(sc), (step, layer)
    return float(sc.max() - sc.min()), float(np.spacing(np.abs(sc).max()))


def _assert_same_run(got: dict, want: dict, what: str, dtype: str) -> None:
    """Tokens, per-step devstats and integer metadata equal, scores within
    ``SCORE_TOL``."""
    assert _split(got, want) is None, f"{what}: pool state split at " \
        f"(step, layer) {_split(got, want)}"
    assert got["tokens"] == want["tokens"], what
    assert len(got["steps"]) == len(want["steps"]), what
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        np.testing.assert_array_equal(g["stats"], w["stats"],
                                      err_msg=f"{what}: devstats, step {i}")
        for li, (gm, wm) in enumerate(zip(g["meta"], w["meta"])):
            rtol, atol = SCORE_TOL[dtype]
            np.testing.assert_allclose(
                gm["score"], wm["score"], rtol=rtol, atol=atol,
                err_msg=f"{what}: step {i} layer {li} score")


def _assert_kv_slice(kv: dict, full: dict, rank: int, tp: int,
                     what: str) -> None:
    """One rank's K/V (and int8 scales) against its slice of a whole
    pool's: f32 within 1e-5, int8 values within one step and scales within
    one step relative (SCORE_TOL's note)."""
    for f, a in kv.items():
        n = full[f].shape[2] // tp
        want = full[f][:, :, rank * n:(rank + 1) * n]
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1, (what, f, d.max())
        elif f.endswith("scale"):
            np.testing.assert_allclose(a, want, rtol=STEP8, atol=0,
                                       err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(a, want, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {f}")


def _case_params():
    return [pytest.param(c, tp, id=f"{c}-tp{tp}") for tp in TPS
            for c in JAX_CASES + (PORT_ONLY if tp == 2 else [])]


# ----------------------------------------------------------------- parity

@pytest.mark.parametrize("case,tp", _case_params())
def test_tp_matches_port_tp1(runs, case, tp):
    """Every rank serves exactly what the port does at tp 1; the ranks'
    metadata agree bit for bit after every step and hold F1-F4; each
    rank's K/V (and int8 scales) are its slice of the tp-1 pool.
    inverse_key_l2 ranks by -mean_h ||K||, which ties wherever a token id
    repeats (ROADMAP fault 4), and everywhere under gemma3's qk-norm
    (every key's norm is sqrt(hd)): there the runs may split only at a tie
    (the scores of the tokens evicted differently within 4 ulp), and the
    gap is printed."""
    _, policy, dtype, _ = CASES[case]
    ref = runs["port1"][case]
    per_rank = [r[case] for r in runs["ranks"][tp]]
    for rank, got in enumerate(per_rank):
        for i, (g, r0) in enumerate(zip(got["steps"], per_rank[0]["steps"])):
            for li, (gm, m0) in enumerate(zip(g["meta"], r0["meta"])):
                for f in META:
                    np.testing.assert_array_equal(
                        gm[f], m0[f],
                        err_msg=f"rank {rank} step {i} layer {li} {f}")
                _assert_pool_invariants(gm, f"rank {rank} step {i} "
                                            f"layer {li}")
        split = _split(got, ref)
        if policy == "inverse_key_l2" and split is not None:
            gap, ulp = _tie_gap(got, ref, *split)
            print(f"{case} tp{tp} rank {rank}: split at (step, layer) "
                  f"{split}, score gap {gap:.3g} ({gap / ulp:.0f} ulp)")
            assert gap <= 4 * ulp, (split, gap, ulp)
            continue
        _assert_same_run(got, ref, f"{case} tp{tp} rank {rank}", dtype)
        for li, (kv, kv1) in enumerate(zip(got["kv"], ref["kv"])):
            _assert_kv_slice(kv, kv1, rank, tp, f"rank {rank} layer {li}")
    if policy == "paged_eviction":
        assert ref["pages_evicted"] > 0, "the workload never evicted a page"


@pytest.mark.parametrize("case,tp", [p for p in _case_params()
                                     if p.values[0] in JAX_CASES])
def test_tp_matches_jax_tp1(runs, case, tp):
    """Rank 0 at tp 2 and 4 serves what the JAX engine does at tp 1:
    tokens, devstats, victims and integer pool state at every step, page
    scores within 1e-6."""
    _assert_same_run(runs["ranks"][tp][0][case], runs["jax1"][case],
                     f"{case} tp{tp} vs JAX tp1", CASES[case][2])


@pytest.mark.parametrize("case", JAX_TP2)
def test_tp2_matches_jax_engine_tp2(runs, case):
    """The port's tp-2 ranks against the JAX engine's own ``Engine(tp=2)``
    (two host devices): tokens, devstats and metadata at every step, the
    ``pool_bytes`` keys; each rank's K/V its slice of JAX's final pool."""
    want = runs["jax2"][case]
    cfg = _cfg(CASES[case][0])
    for rank, r in enumerate(runs["ranks"][2]):
        got = r[case]
        _assert_same_run(got, want, f"{case} rank {rank} vs JAX tp2",
                         CASES[case][2])
        assert got["pool_bytes"].keys() == want["pool_bytes"].keys()
        assert got["pool_bytes"]["devices"] == want["pool_bytes"]["devices"]
        mine = shard_cache_from_jax(want["cache"], cfg, rank, 2,
                                    device="cpu")
        for li, (kv, c) in enumerate(zip(got["kv"], paged_layers(
                mine.layers))):
            _assert_kv_slice(kv, {f: getattr(c, f).numpy() for f in kv},
                             0, 1, f"rank {rank} layer {li}")


@pytest.mark.parametrize("tp", TPS)
def test_tp_ranks_take_gloo_on_the_cpu(runs, tp):
    """``make_tp_group`` picks the backend from the device: gloo for CPU
    ranks."""
    assert [r["backend"] for r in runs["ranks"][tp]] == ["gloo"] * tp


@pytest.mark.parametrize("tp", TPS)
def test_tp_collective_inventory(runs, tp):
    """A tp step issues all-reduces only, as many of each kind as
    ``mesh.step_collectives`` counts from the step's rows (the JAX
    package's ``inspect_collectives --serve-tp`` inventory); a step with
    no forward issues none."""
    for r in runs["ranks"][tp]:
        assert set(r["raw"]) == {"all_reduce"}, r["raw"]
        assert r["raw"]["all_reduce"] == sum(r["counts"].values())
        for case, (arch, policy, _, fused) in CASES.items():
            if case not in r:
                continue
            for i, s in enumerate(r[case]["steps"]):
                want = Counter() if s["ran"] is None else \
                    mesh.step_collectives(
                        _cfg(arch), policy, has_decode=s["ran"][0],
                        has_prefill=s["ran"][1], fused_scores=fused,
                        metrics=True)
                assert Counter(s["coll"]) == want, (case, i, s["ran"])


@pytest.mark.parametrize("tp", TPS)
def test_tp_pool_bytes(runs, tp):
    """Each rank holds total/tp of the pool payload (within one page of
    every layer's pool), over ``tp`` devices; the total is tp 1's."""
    page = 4
    for r in runs["ranks"][tp]:
        pb = r["paged_eviction-f32"]["pool_bytes"]
        pb1 = runs["port1"]["paged_eviction-f32"]["pool_bytes"]
        cfg = _cfg("gemma3-27b")
        one_page = 2 * page * cfg.num_kv_heads * cfg.resolved_head_dim * 4 \
            * cfg.num_layers
        assert pb["devices"] == tp and pb1["devices"] == 1
        assert pb["payload_total"] == pb1["payload_total"]
        assert pb["per_device_max"] <= pb["payload_total"] / tp + one_page
        assert pb["per_device_max"] == pb1["per_device_max"] // tp


# ------------------------------------------------------------ tp 1, errors

def test_tp1_issues_no_collective(runs, monkeypatch):
    """At tp 1 the engine creates no group and issues no collective."""
    calls = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda *a, **k: calls.append(a))
    eng = _port_engine("paged_eviction-f32", runs["jparams"]["gemma3-27b"])
    assert eng.tp_group is None and eng.policy.tp_group is None
    _serve(eng)
    assert calls == [] and not dist.is_initialized()


def test_tp_needs_a_group_of_its_size():
    """The degree is the group's size: a group of size 1 is tp 1 (no
    collective); at tp 2 each rank holds half the heads, and a step
    without a process group of that world size raises: no fallback."""
    cfg = _cfg("gemma3-27b")
    params = init_model(cfg, device="cpu")
    kw = dict(cache_cfg=CacheConfig(page_size=4, cache_budget=32,
                                    dtype="float32"), device="cpu", **ENGINE)
    eng = Engine(cfg, params, tp_group=mesh.TPGroup(0, 1, "cpu"), **kw)
    assert eng.tp == 1 and eng.tp_group is None
    eng = Engine(cfg, params, tp_group=mesh.TPGroup(1, 2, "cpu"), **kw)
    assert eng.tp == 2 and eng.pool_bytes()["devices"] == 2
    assert eng.params["layers"][0]["attn"]["wq"].shape[1] == \
        params["layers"][0]["attn"]["wq"].shape[1] // 2
    eng.submit(np.arange(1, 9, dtype=np.int32))
    assert not dist.is_initialized()
    with pytest.raises((ValueError, RuntimeError), match="process group"):
        eng.step()


def test_make_tp_group_names_what_is_missing(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="missing MASTER_ADDR, MASTER_PORT, "
                                         "RANK, WORLD_SIZE"):
        mesh.make_tp_group(2, device="cpu")
    for v, x in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1"),
                 ("RANK", "0"), ("WORLD_SIZE", "3")):
        monkeypatch.setenv(v, x)
    with pytest.raises(ValueError, match="WORLD_SIZE is 3"):
        mesh.make_tp_group(2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        mesh.make_tp_group(2, device="cpu", store=object())


def test_validate_tp_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        rules.validate_tp(get_arch("gemma3-27b").reduced(), 4)   # KV 2
    rules.validate_tp(get_arch("gemma3-27b").reduced(tp=4), 4)


def test_validate_tp_rejects_non_attn_mixers():
    for arch in ("jamba-1.5-large-398b", "xlstm-1.3b"):
        with pytest.raises(ValueError, match="attention mixers"):
            rules.validate_tp(get_arch(arch).reduced(tp=4), 4)


def test_validate_tp_rejects_cross_attention():
    with pytest.raises(ValueError, match="cross-attention"):
        rules.validate_tp(get_arch("musicgen-medium").reduced(tp=4), 4)


def test_tp_rejects_regret_taps():
    cfg = _cfg("gemma3-27b")
    with pytest.raises(ValueError, match="regret"):
        Engine(cfg, init_model(cfg, device="cpu"),
               cache_cfg=CacheConfig(page_size=4, cache_budget=32,
                                     dtype="float32"),
               device="cpu", tp_group=mesh.TPGroup(0, 2, "cpu"),
               obs=ObsConfig(regret_every=2), **ENGINE)


def test_reduced_tp_widens_heads():
    for name in ("gemma3-27b", "mixtral-8x7b", "qwen2.5-3b"):
        cfg = get_arch(name).reduced(tp=4)
        assert cfg.num_kv_heads % 4 == 0 and cfg.num_heads % 4 == 0
        assert cfg.num_heads % cfg.num_kv_heads == 0


# ------------------------------------------------------------------- specs

def _jax_paths(tree) -> list:
    """(key path, PartitionSpec) of every leaf of a JAX spec tree."""
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]


def _model_dim(spec, off: int):
    dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    assert len(dims) <= 1
    return dims[0] - off if dims else None


def _key_names(kp) -> list:
    return [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
            for k in kp]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_specs_match_jax(arch, tp):
    """Per parameter and cache leaf, the port's split dimension is the
    "model" position of JAX's ``tp_param_specs`` / ``tp_cache_specs``
    (less the stacking dimension of its pattern slots), on each family's
    reduced(tp) config."""
    import jax

    from repro.configs import CacheConfig as JCacheConfig
    from repro.configs import get_arch as jget_arch
    from repro.core.policies import get_policy as jget_policy
    from repro.models.transformer import init_decode_caches as jinit_caches
    from repro.models.transformer import init_model as jinit_model
    from repro.sharding import rules as jrules

    jcfg = jget_arch(arch).reduced(tp=tp)
    cfg = get_arch(arch).reduced(tp=tp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    period, reps = cfg.pattern_period, cfg.full_pattern_reps

    def port_layer(names) -> tuple:
        """JAX key names -> (port layer index or None, rest, offset)."""
        if names[0] == "pattern":
            return names[1], names[2:], 1
        if names[0] == "tail":
            return str(reps * period + int(names[1])), names[2:], 0
        return None, names, 0

    jparams = jax.eval_shape(lambda k: jinit_model(k, jcfg),
                             jax.random.PRNGKey(0))
    mine = rules.tp_param_specs(init_model(cfg, device="cpu"))
    seen = 0
    for kp, spec in _jax_paths(jrules.tp_param_specs(jparams)):
        slot, rest, off = port_layer(_key_names(kp))
        want = _model_dim(spec, off)
        layers = range(int(slot), reps * period, period) if off else \
            [slot] if slot is not None else [None]
        for layer in layers:
            node = mine if layer is None else mine["layers"][int(layer)]
            for k in rest:
                node = node[int(k)] if isinstance(node, list) else node[k]
            assert node == want, (arch, tp, layer, rest, node, want)
            seen += 1
    assert seen == len(jax.tree_util.tree_leaves(
        mine, is_leaf=lambda x: x is None))

    ccfg = dict(page_size=4, cache_budget=32, policy="paged_eviction",
                dtype="int8")
    jcache = jax.eval_shape(lambda: jinit_caches(
        jcfg, 2, 48, jget_policy("paged_eviction"), JCacheConfig(**ccfg)))
    cache = init_decode_caches(cfg, 2, 48, get_policy("paged_eviction"),
                               CacheConfig(**ccfg), device="cpu")
    specs = rules.tp_cache_specs(cache)
    port_field = {"k": "k_buf", "v": "v_buf", "k_scale": "k_scale_buf",
                  "v_scale": "v_scale_buf", "pos": "pos_buf",
                  "score": "score_buf"}
    for kp, spec in _jax_paths(jrules.tp_cache_specs(jcache)):
        names = _key_names(kp)
        if names == ["cur_pos"]:
            assert specs["cur_pos"] == _model_dim(spec, 0)
            continue
        slot, rest, off = port_layer(names)
        field, kind = rest[-1], "cross" if rest[0] == "xattn" else "layers"
        field = port_field.get(field, field) if kind == "layers" else field
        layers = range(int(slot), reps * period, period) if off else [slot]
        for layer in layers:
            path = f"{kind}/{layer}/{field}"
            assert specs.pop(path) == _model_dim(spec, off), (arch, tp, path)
    # what JAX's init does not hold (stats off; musicgen's conditioning
    # K/V, made by its prefill) is whole
    assert all(d is None for d in specs.values()), specs


def test_shard_params_and_cache_are_contiguous_slices():
    """``shard_params`` copies each rank's slice of the split leaves and
    hands the replicated ones on; ``shard_cache`` splits only the pools'
    KV heads, copying the metadata; the slices concatenate back."""
    cfg = _cfg("mixtral-8x7b")
    params = init_model(cfg, device="cpu")
    specs = rules.tp_param_specs(params)
    shards = [rules.shard_params(params, r, 2) for r in range(2)]
    lp, sp = params["layers"][0], [s["layers"][0] for s in shards]
    for block, name in (("attn", "wq"), ("attn", "wo"), ("moe", "w_gate"),
                        ("moe", "w_down")):
        dim = specs["layers"][0][block][name]
        parts = [s[block][name] for s in sp]
        assert all(p.is_contiguous() for p in parts)
        torch.testing.assert_close(torch.cat(parts, dim), lp[block][name],
                                   rtol=0, atol=0)
    assert sp[0]["moe"]["router"] is lp["moe"]["router"]
    assert shards[1]["embed"] is params["embed"]
    cache = init_decode_caches(cfg, 2, 48, get_policy("paged_eviction"),
                               CacheConfig(page_size=4, cache_budget=32,
                                           dtype="int8"), device="cpu")
    c0, c1 = (rules.shard_cache(cache, r, 2).layers[0] for r in range(2))
    full = cache.layers[0]
    for f in ("k_buf", "v_buf", "k_scale_buf", "v_scale_buf"):
        assert getattr(c0, f).shape[2] == getattr(full, f).shape[2] // 2
        torch.testing.assert_close(
            torch.cat([getattr(c0, f), getattr(c1, f)], 2), getattr(full, f))
    assert c0.block_table.data_ptr() != full.block_table.data_ptr()
    torch.testing.assert_close(c0.block_table, full.block_table)


def test_shard_params_moves_only_the_slice():
    """With ``device``, ``shard_params`` puts every leaf of the rank's
    shard there (the split ones at their slice's shape) and leaves the
    full weights where they were: the engine takes host weights so."""
    cfg = _cfg("mixtral-8x7b")
    params = init_model(cfg, device="cpu")
    host = rules.shard_params(params, 1, 2)
    moved = rules.shard_params(params, 1, 2, device="meta")
    def flat(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for t in items for x in flat(t)]

    assert all(x.device.type == "meta" for x in flat(moved))
    assert all(x.device.type == "cpu" for x in flat(params))
    assert [x.shape for x in flat(moved)] == [x.shape for x in flat(host)]
    assert all(x.is_contiguous() for x in flat(moved))


# -------------------------------------------------------------- serve CLI

def test_serve_cli_tp2_gloo():
    """``serve.py --reduced --tp 2 --device cpu``: two spawned ranks over
    gloo; rank 0's pool-bytes line shows 2 devices holding half
    the payload each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--reduced", "--tp", "2", "--device", "cpu", "--budget", "32", "--page", "8", "--requests",
         "4", "--max-batch", "2", "--prompt-len", "40", "--new-tokens", "4",
         "--shared-prefix", "16"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("tp=2: pool payload")]
    assert len(lines) == 1, proc.stdout          # rank 0 prints it, alone
    words = lines[0].split()
    total, per_dev = float(words[3]), float(words[6])
    assert "across 2 devices" in lines[0]
    assert per_dev == pytest.approx(total / 2, abs=0.01)   # 2 decimals
    assert proc.stdout.count("finished 4 requests") == 1
