"""The torch port's serving engine against the JAX Engine, on the CPU.

Same random-init weights (the JAX tree handed over as numpy), same prompts
(half share a prefix), greedy sampling, prefix sharing on. Every step must
emit the same tokens and the same devstats vector, and the final integer
pool state of every layer must be bit-equal. Two pairings: the port's
stored-score eviction against the JAX jnp path, and its fused kernel
scores against the JAX Pallas kernels (interpret mode). The paper's
baselines (StreamingLLM, InverseKeyL2, KeyDiff) run the same comparison;
they rank tokens, so the fused page scores must change nothing.

Also: the sampler, and the hygiene checks (importing the port pulls in
neither JAX nor the JAX package; an Engine without a device refuses to run
without CUDA).
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.models.transformer import init_model as jinit_model
from repro.serving import Engine as JEngine
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (jax_cache_layers, layer_cache_to_numpy,
                                 params_from_jax)
from repro_torch.core import devstats
from repro_torch.serving import Engine

INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")


def _configs(name):
    """(JAX config, port config): a reduced family config, or a hand-made
    2-layer one with KV=2, G=2 (reduced() gives KV=1, which hides layout
    bugs)."""
    if name == "kv2":
        jcfg = dataclasses.replace(jget_arch("llama-3.2-1b").reduced(),
                                   num_heads=4, num_kv_heads=2)
    else:
        jcfg = jget_arch(name).reduced()
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        length = int(rng.integers(20, 48))
        head = shared if i % 2 == 0 else rng.integers(0, vocab, 16)
        out.append(np.concatenate(
            [head, rng.integers(0, vocab, length - 16)]).astype(np.int32))
    return out


def _engine_pair(arch, fused, policy, prompts=None, budget=32,
                 on_step=None, **engine_kw):
    """Serve the same prompts (default ``_prompts``) on the JAX Engine and
    the port's, step by step, calling ``on_step(je, te)`` after each;
    checks per-step devstats, tokens, final integer pool state and pool
    stats. Returns (JAX engine, port engine)."""
    jcfg, tcfg = _configs(arch)
    jparams = jinit_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg,
                              device="cpu")
    ck = dict(page_size=8, cache_budget=budget, policy=policy,
              dtype="float32")
    common = dict(dict(max_batch=3, max_prompt_len=48, max_new_tokens=8,
                       chunk_size=16), **engine_kw)
    je = JEngine(jcfg, jparams, cache_cfg=JCacheConfig(**ck),
                 use_pallas=fused, **common)
    te = Engine(tcfg, tparams, cache_cfg=CacheConfig(**ck),
                fused_scores=fused, device="cpu", **common)
    assert te.fused_scores == je.fused_scores == fused
    for p in prompts or _prompts(jcfg.vocab_size):
        je.submit(p)
        te.submit(p)
    reg = je.obs.registry
    prev = np.zeros(devstats.NSTATS, np.int64)
    for step in range(200):
        j_more, t_more = je.step(), te.step()
        cum = np.array([reg.counter(f"pool.{n}").value
                        for n in devstats.STAT_NAMES])
        np.testing.assert_array_equal(te.last_stats, cum - prev,
                                      err_msg=f"devstats, step {step}")
        prev = cum
        assert j_more == t_more
        if on_step is not None:
            on_step(je, te)
        if not j_more:
            break
    assert not j_more, "engines did not finish"
    j_done = {r.request_id: r.output_tokens for r in je.scheduler.finished}
    t_done = {r.request_id: r.output_tokens for r in te.scheduler.finished}
    assert t_done == j_done
    j_layers = jax_cache_layers(jax.device_get(je.cache), jcfg.pattern_period)
    for i, (jl, tl) in enumerate(zip(j_layers, te.cache.layers)):
        jn, tn = layer_cache_to_numpy(jl), layer_cache_to_numpy(tl)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(tn[f], jn[f],
                                          err_msg=f"layer {i} {f}")
    assert te.pool_stats() == je.pool_stats()
    return je, te


@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("arch", ["llama-3.2-1b", "kv2"])
def test_engine_matches_jax(arch, fused):
    je, te = _engine_pair(arch, fused, "paged_eviction")
    assert te.stats.pages_evicted == je.stats.pages_evicted > 0
    assert te.stats.shared_prefix_hits == je.stats.shared_prefix_hits > 0


@pytest.mark.parametrize("policy,fused", [("inverse_key_l2", False),
                                          ("keydiff", True)])
def test_engine_baseline_matches_jax(policy, fused):
    """The reduced llama-3.2-1b served under the unstructured baselines
    (page 8, budget 32, prefix sharing on): token evictions, and a page
    eviction only where a rollover is forced; where token holes break a
    shared prefix, both adopt the same fewer pages. StreamingLLM's run is
    test_engine_shared_prefix_overshoot_matches_jax."""
    je, te = _engine_pair("llama-3.2-1b", fused, policy)
    assert te.stats.tokens_evicted == je.stats.tokens_evicted > 0
    assert te.stats.pages_evicted == je.stats.pages_evicted == \
        te.stats.forced_evictions == je.stats.forced_evictions
    assert te.stats.shared_prefix_hits == je.stats.shared_prefix_hits


def test_engine_shared_prefix_overshoot_matches_jax():
    """The reduced llama-3.2-1b served under StreamingLLM, two of four
    requests sharing a 4-page prefix (page 8, budget 64): token eviction
    copies a shared page before it writes, one page per row per call, so
    the sharing rows hold more than budget + page for a while, run out of
    slots, and a forced rollover's victim (the page with the fewest tokens)
    takes a row's sinks. The port does this exactly as the JAX package
    does: every step's live tokens and missing sinks are the same on both
    (a row misses a sink once its newest position is past the sinks)."""
    rng = np.random.default_rng(0)
    vocab = jget_arch("llama-3.2-1b").reduced().vocab_size
    shared = rng.integers(0, vocab, 32)
    prompts = []
    for i in range(4):
        n = int(rng.integers(100, 160))
        head = shared if i % 2 == 0 else rng.integers(0, vocab, 32)
        prompts.append(np.concatenate(
            [head, rng.integers(0, vocab, n - 32)]).astype(np.int32))
    seen = {"jax": [], "port": []}

    def reading(layers):
        """(most live tokens in a row, (layer, row) pairs lacking a sink)"""
        most = lost = 0
        for c in layers:
            n = layer_cache_to_numpy(c)
            bt = n["block_table"]
            pv = np.where((bt >= 0)[..., None], n["pos"][np.maximum(bt, 0)],
                          -1).reshape(bt.shape[0], -1)
            sinks = np.stack([(pv == s).any(1) for s in range(4)]).all(0)
            most = max(most, int((pv >= 0).sum(1).max()))
            lost += int(((pv.max(1) >= 3) & ~sinks).sum())
        return most, lost

    def on_step(je, te):
        seen["jax"].append(reading(jax_cache_layers(
            jax.device_get(je.cache), je.cfg.pattern_period)))
        seen["port"].append(reading(te.cache.layers))

    je, te = _engine_pair("llama-3.2-1b", False, "streaming_llm",
                          prompts=prompts, budget=64, on_step=on_step,
                          max_batch=4, max_prompt_len=160)
    assert seen["port"] == seen["jax"]
    assert te.stats.tokens_evicted == je.stats.tokens_evicted > 0
    assert te.stats.shared_prefix_hits == je.stats.shared_prefix_hits > 0
    assert te.stats.pages_evicted == je.stats.pages_evicted == \
        te.stats.forced_evictions == je.stats.forced_evictions > 0
    assert max(m for m, _ in seen["port"]) > 64 + 8
    assert max(n for _, n in seen["port"]) > 0


def test_serve_cli_takes_the_five_policies(monkeypatch, capsys):
    """``--policy`` of the serving CLI takes every registered policy (a
    tiny CPU run under keydiff) and rejects any other name."""
    from repro_torch.launch import serve
    base = ["serve", "--arch", "llama-3.2-1b", "--reduced", "--budget", "16",
            "--page", "8", "--requests", "2", "--max-batch", "2",
            "--prompt-len", "24", "--new-tokens", "3", "--chunk", "8",
            "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", base + ["--policy", "keydiff"])
    serve.main()
    out = capsys.readouterr().out
    assert "policy=keydiff" in out and "finished 2 requests" in out
    monkeypatch.setattr(sys, "argv", base + ["--policy", "h2o"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "invalid choice: 'h2o'" in capsys.readouterr().err


@pytest.mark.parametrize("sharing", [True, False])
def test_dropped_engine_frees_its_cache_without_gc(sharing, tmp_path):
    """The scheduler's hooks (the prefix probe, the timeline's admission
    hook) hold their engine weakly: an engine with every obs hook on,
    dropped with the cycle collector off, frees its pools at once, and a
    live one still serves through both hooks."""
    import gc
    import weakref

    from repro_torch.models.transformer import init_model
    from repro_torch.obs import ObsConfig
    _, tcfg = _configs("kv2")
    params = init_model(tcfg, seed=0, device="cpu")
    eng = Engine(tcfg, params, cache_cfg=CacheConfig(
        page_size=8, cache_budget=32, dtype="float32"), device="cpu",
        max_batch=3, max_prompt_len=48, max_new_tokens=8, chunk_size=16,
        prefix_sharing=sharing, obs=ObsConfig(
            trace_path=str(tmp_path / "trace.jsonl"), timeline=True,
            lineage=True, regret_every=2))
    for p in _prompts(tcfg.vocab_size):
        eng.submit(p)
    assert len(eng.run()) == 4
    assert (eng.stats.shared_prefix_hits > 0) == sharing
    pool = weakref.ref(eng.cache.layers[0].k_buf)
    gc.disable()
    try:
        del eng
        assert pool() is None
    finally:
        gc.enable()


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.obs.regret\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**dataclasses.asdict(jget_arch("llama-3.2-1b")
                                           .reduced()))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, {}, cache_cfg=CacheConfig(page_size=8, cache_budget=32))


def test_sampler_greedy_and_filters():
    from repro.serving.sampler import sample_tokens as jsample
    from repro_torch.serving.sampler import filter_logits, sample_tokens
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 2.0, -1.0]], np.float32)
    # greedy: the first of the tied maxima, as in JAX
    got = sample_tokens(None, torch.from_numpy(logits), greedy=True)
    want = jsample(jax.random.PRNGKey(0), jnp.asarray(logits), greedy=True)
    assert int(got[0]) == int(want[0]) == 1
    # top-k keeps the k largest; top-p the smallest prefix of mass >= p
    kept = np.isfinite(filter_logits(torch.from_numpy(logits), top_k=3)
                       .numpy()[0])
    np.testing.assert_array_equal(kept, [0, 1, 1, 0, 1, 0])
    probs = np.exp(logits[0]) / np.exp(logits[0]).sum()
    order = np.argsort(-probs, kind="stable")
    need = int(np.searchsorted(np.cumsum(probs[order]), 0.8)) + 1
    kept = np.isfinite(filter_logits(torch.from_numpy(logits), top_p=0.8)
                       .numpy()[0])
    assert set(np.flatnonzero(kept)) == set(order[:need].tolist())
    # draws follow the filtered distribution
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(gen, torch.from_numpy(np.repeat(logits, 20000, 0)),
                          temperature=0.7, top_k=3, greedy=False).numpy()
    f = np.where(np.isfinite(filter_logits(torch.from_numpy(logits),
                                           temperature=0.7, top_k=3)
                             .numpy()[0]), logits[0] / 0.7, -np.inf)
    expect = np.exp(f - f.max()) / np.exp(f - f.max()).sum()
    freq = np.bincount(draws, minlength=logits.shape[1]) / draws.size
    np.testing.assert_allclose(freq, expect, atol=0.02)
