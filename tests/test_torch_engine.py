"""The torch port's serving engine against the JAX Engine, on the CPU.

Same random-init weights (the JAX tree handed over as numpy), same prompts
(half share a prefix), greedy sampling, prefix sharing on. Every step must
emit the same tokens and the same devstats vector, and the final integer
pool state of every layer must be bit-equal. Two pairings: the port's
stored-score eviction against the JAX jnp path, and its fused kernel
scores against the JAX Pallas kernels (interpret mode).

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


@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("arch", ["llama-3.2-1b", "kv2"])
def test_engine_matches_jax(arch, fused):
    jcfg, tcfg = _configs(arch)
    jparams = jinit_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg,
                              device="cpu")
    ck = dict(page_size=8, cache_budget=32, policy="paged_eviction",
              dtype="float32")
    common = dict(max_batch=3, max_prompt_len=48, max_new_tokens=8,
                  chunk_size=16)
    je = JEngine(jcfg, jparams, cache_cfg=JCacheConfig(**ck),
                 use_pallas=fused, **common)
    te = Engine(tcfg, tparams, cache_cfg=CacheConfig(**ck),
                fused_scores=fused, device="cpu", **common)
    assert te.fused_scores == je.fused_scores == fused
    for p in _prompts(jcfg.vocab_size):
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
        if not j_more:
            break
    assert not j_more, "engines did not finish"
    j_done = {r.request_id: r.output_tokens for r in je.scheduler.finished}
    t_done = {r.request_id: r.output_tokens for r in te.scheduler.finished}
    assert t_done == j_done
    assert te.stats.pages_evicted == je.stats.pages_evicted > 0
    assert te.stats.shared_prefix_hits == je.stats.shared_prefix_hits > 0
    j_layers = jax_cache_layers(jax.device_get(je.cache), jcfg.pattern_period)
    for i, (jl, tl) in enumerate(zip(j_layers, te.cache.layers)):
        jn, tn = layer_cache_to_numpy(jl), layer_cache_to_numpy(tl)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(tn[f], jn[f],
                                          err_msg=f"layer {i} {f}")
    assert te.pool_stats() == je.pool_stats()


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.kernels.build\n"
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
