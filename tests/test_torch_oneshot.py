"""The port's one-shot path (``forward_prefill`` + ``decode_step``, the
paper's own prefill -> Alg.2 compress -> Alg.3 decode experiment) against
the JAX package's, on the CPU.

Same weights (the JAX init tree as numpy; qwen's qkv biases made non-zero),
same right-padded prompts of ragged lengths, then 8 greedy decode steps fed
the JAX argmax. After the prefill and after every step: the logits within
1e-4, greedy tokens equal, every layer's integer cache state bit-equal and
K/V/scores within 1e-4. At S = 128 the prompt goes through the flash
kernel on both sides (the JAX Pallas kernel in interpret mode; decode
through the Pallas decode kernel, eviction ranked by the fused epilogue on
both); at S = 48 through the plain causal attention on both (decode through
the jnp reference on the JAX side, the stored scores on both). Every
policy takes a case: the paper's baselines compress the prompt token by
token (StreamingLLM keeping its sinks) and evict a token per decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.core.decode import decode_append as jdecode_append
from repro.core.policies import get_policy as jget_policy
from repro.core.prefill import compress_and_page as jcompress
from repro.models import transformer as jtf
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 jax_cache_layers, layer_cache_to_numpy,
                                 params_from_jax)
from repro_torch.core.decode import decode_append
from repro_torch.core.policies import get_policy
from repro_torch.core.prefill import compress_and_page
from repro_torch.models import transformer as ttf

B, STEPS = 3, 8
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")

_jprefill = jax.jit(jtf.forward_prefill, static_argnames=(
    "cfg", "policy", "ccfg", "total_seq_hint", "use_pallas"))
_jdecode = jax.jit(jtf.decode_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores"))


def _params(name, rng):
    jcfg = jget_arch(name).reduced()
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(1), jcfg))
    for slot in tree["pattern"]:
        for b in ("bq", "bk", "bv"):
            if b in slot["attn"]:
                slot["attn"][b] = rng.standard_normal(
                    slot["attn"][b].shape).astype(np.float32) * 0.1
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def _compare(jlogits, jcache, tlogits, tcache, period, ctx):
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, err_msg=f"{ctx}: logits")
    tn = cache_to_numpy(tcache)
    np.testing.assert_array_equal(tn["cur_pos"], np.asarray(jcache.cur_pos))
    jl = jax_cache_layers(jax.device_get(jcache), period)
    assert len(jl) == len(tn["layers"])
    for i, (j, t) in enumerate(zip(jl, tn["layers"])):
        jn = layer_cache_to_numpy(j)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(t[f], jn[f],
                                          err_msg=f"{ctx}: layer {i} {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(t[f], jn[f], atol=1e-4,
                                       err_msg=f"{ctx}: layer {i} {f}")


# each arch, policy and route twice, in four of the eight combinations (the
# interpret-mode kernels cost about 15 s a case on the CPU); the baselines
# once each
@pytest.mark.parametrize("arch,policy,S", [
    ("llama-3.2-1b", "paged_eviction", 128),
    ("qwen2.5-3b", "full", 128),
    ("llama-3.2-1b", "full", 48),
    ("qwen2.5-3b", "paged_eviction", 48),
    ("llama-3.2-1b", "streaming_llm", 48),
    ("qwen2.5-3b", "inverse_key_l2", 48),
    ("llama-3.2-1b", "keydiff", 128),
])
def test_oneshot_matches_jax(arch, policy, S):
    rng = np.random.default_rng(S)
    jcfg, jparams, tcfg, tparams = _params(arch, rng)
    kernels = S % 128 == 0
    ck = dict(page_size=8, cache_budget=32, policy=policy, dtype="float32")
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy(policy), get_policy(policy)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, S - 5, S - 19])               # right-padded, ragged
    valid = np.arange(S)[None, :] < lens[:, None]
    hint = S + STEPS
    jlogits, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens),
                                policy=jpol, ccfg=jccfg,
                                valid=jnp.asarray(valid), total_seq_hint=hint,
                                use_pallas=kernels)
    tlogits, tcache = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(tokens), tpol, tccfg,
        valid=torch.from_numpy(valid), total_seq_hint=hint)
    _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
             f"{arch} {policy} S {S} prefill")
    if policy != "full":
        assert int(tcache.layers[0].total_valid().max()) <= 32
    if policy == "streaming_llm":
        sinks = np.arange(tccfg.num_sink_tokens)
        assert all(np.isin(sinks, c.pos_view()[b].numpy()).all()
                   for c in tcache.layers for b in range(B))
    evicted = False
    for step in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlogits.argmax(-1).numpy(), tok,
                                      err_msg=f"greedy tokens, step {step}")
        jlogits, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                   policy=jpol, ccfg=jccfg,
                                   use_pallas=kernels, fused_scores=kernels)
        before = tcache.layers[0].pos_view()
        tlogits, tcache = ttf.decode_step(tparams, tcfg,
                                          torch.from_numpy(tok), tcache,
                                          tpol, tccfg, fused_scores=kernels)
        # a position that was live and is gone: a page or a token was
        # evicted (the rollover may remap a freed page at once, so the block
        # table can look unchanged)
        after = tcache.layers[0].pos_view()
        evicted |= any(bool(np.isin(before[b][before[b] >= 0],
                                    after[b][after[b] >= 0],
                                    invert=True).any()) for b in range(B))
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{arch} {policy} S {S} step {step}")
    np.testing.assert_array_equal(tlogits.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlogits, -1)))
    assert evicted == (policy != "full")


def test_compress_and_page_cap_and_ties():
    """The slab-capacity cap (a keep set larger than the slab: the full
    policy on a short hint) and tied scores (all-equal K/V norms, equal
    keys for the baselines, padding's -inf; StreamingLLM's +inf sinks): the
    selection, and so the cache, bit-equal to JAX's."""
    rng = np.random.default_rng(5)
    S, KV, hd = 40, 2, 8
    k = np.ones((B, S, KV, hd), np.float32)               # every score ties
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v[:, :, :, :] = np.abs(v[:, :1, :1, :1])              # per-row constant
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    valid = np.arange(S)[None, :] < np.array([[S], [S - 7], [21]])
    for policy, hint in (("paged_eviction", None), ("full", 16),
                         ("streaming_llm", None), ("inverse_key_l2", None),
                         ("keydiff", None)):
        ck = dict(page_size=8, cache_budget=16, policy=policy,
                  dtype="float32")
        jc = jcompress(*map(jnp.asarray, (k, v, pos, valid)),
                       jget_policy(policy), JCacheConfig(**ck),
                       seq_len_hint=hint)
        tc = compress_and_page(*map(torch.from_numpy, (k, v, pos, valid)),
                               get_policy(policy), CacheConfig(**ck),
                               seq_len_hint=hint)
        jn, tn = layer_cache_to_numpy(jc), layer_cache_to_numpy(tc)
        for f in ("k", "v", "pos", "score") + INT_FIELDS:
            np.testing.assert_array_equal(tn[f], jn[f],
                                          err_msg=f"{policy}: {f}")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_decode_append_matches_jax(dtype):
    """Alg.3 one token at a time (decode_append) on a compressed prompt
    cache: 20 steps, two page evictions per row; integer state, victims and
    the int8 values and scales bit-equal, K/V/scores within 1e-6."""
    rng = np.random.default_rng(8)
    S, KV, hd = 40, 2, 16
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    valid = np.ones((B, S), bool)
    ck = dict(page_size=8, cache_budget=16, policy="paged_eviction",
              dtype=dtype)
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy("paged_eviction"), get_policy("paged_eviction")
    cdt = dict(cache_dtype="int8") if dtype == "int8" else {}
    jc = jcompress(*map(jnp.asarray, (k, v, pos, valid)), jpol, jccfg,
                   seq_len_hint=S + 20, **cdt)
    tc = compress_and_page(*map(torch.from_numpy, (k, v, pos, valid)), tpol,
                           tccfg, seq_len_hint=S + 20, **cdt)
    evicted = 0
    for step in range(20):
        kt, vt = (rng.standard_normal((B, KV, hd)).astype(np.float32)
                  for _ in range(2))
        pt = np.full(B, S + step, np.int32)
        jo = jdecode_append(jc, *map(jnp.asarray, (kt, vt, pt)), jpol,
                            jccfg)
        to = decode_append(tc, *map(torch.from_numpy, (kt, vt, pt)), tpol,
                           tccfg)
        jc = jo.cache
        np.testing.assert_array_equal(to.pages_evicted.numpy(),
                                      np.asarray(jo.pages_evicted))
        np.testing.assert_array_equal(to.victim_page.numpy(),
                                      np.asarray(jo.victim_page))
        evicted += int(to.pages_evicted.sum())
        jn, tn = layer_cache_to_numpy(jc), layer_cache_to_numpy(to.cache)
        exact = INT_FIELDS + (("k", "v", "k_scale", "v_scale")
                              if dtype == "int8" else ())
        for f in exact:
            np.testing.assert_array_equal(tn[f], jn[f],
                                          err_msg=f"step {step}: {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(tn[f], jn[f], atol=1e-6,
                                       err_msg=f"step {step}: {f}")
    assert evicted == 2 * B


def test_cache_from_jax_prefill_roundtrip():
    """A JAX forward_prefill cache converts to a port ModelCache that
    decodes on: the next step equals JAX's."""
    rng = np.random.default_rng(7)
    jcfg, jparams, tcfg, tparams = _params("llama-3.2-1b", rng)
    ck = dict(page_size=8, cache_budget=16, policy="paged_eviction",
              dtype="float32")
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy("paged_eviction"), get_policy("paged_eviction")
    tokens = rng.integers(0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    jlogits, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens),
                                policy=jpol, ccfg=jccfg, total_seq_hint=32)
    tcache = cache_from_jax(jax.device_get(jcache), tcfg, device="cpu")
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    jlogits, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                               policy=jpol, ccfg=jccfg)
    tlogits, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                      tcache, tpol, tccfg)
    _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
             "converted cache")


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """Every public function of the port that makes tensors defaults to
    CUDA and raises without a card."""
    from repro_torch.convert import layer_cache_from_jax
    from repro_torch.core.paged_cache import init_layer_cache
    from repro_torch.kernels.ref import churned_pool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**dataclasses.asdict(jget_arch("llama-3.2-1b")
                                           .reduced()))
    ccfg = CacheConfig(page_size=8, cache_budget=16)
    calls = [
        lambda: init_layer_cache(2, 3, 8, 1, 16, torch.float32),
        lambda: ttf.init_model(cfg),
        lambda: ttf.init_decode_caches(cfg, 2, 32, get_policy(ccfg.policy),
                                       ccfg),
        lambda: params_from_jax({"pattern": [], "tail": []}, cfg),
        lambda: layer_cache_from_jax(None),
        lambda: cache_from_jax(None, cfg),
        lambda: churned_pool(2, 3, 8, 1, 16, torch.float32, 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
