"""The port's unified serving step against the JAX package's forward_step.

Same weights (the JAX init tree handed over as numpy; qwen's qkv biases
made non-zero), same token steps: chunked prefill on fresh rows, a mixed
step, decode-only steps, a prefix adoption. After every step the logits
of the live rows agree within 1e-4 and every layer's pool state is equal:
integer fields and devstats bit for bit, K/V/scores within 1e-4 (RoPE's
sin/cos differ in the last bits between XLA and torch). The configs:
reduced llama-3.2-1b and qwen2.5-3b, a KV 2 variant, and three whose head
dim is not d_model / H: mistral-nemo-12b's (hd 96), and llama's at hd 80
and 32 (the head dims the CUDA kernels take besides 64 and 128, through
their plain versions here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.core.policies import get_policy as jget_policy
from repro.models import transformer as jtf
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (cache_to_numpy,
                                 jax_cache_layers, layer_cache_to_numpy,
                                 params_from_jax)
from repro_torch.core import devstats
from repro_torch.core.policies import get_policy
from repro_torch.models import transformer as ttf

B, CHUNK = 3, 16
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off",
              "stats")

_jstep = jax.jit(jtf.forward_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores",
    "want_taps", "tp_axis"))


# reduced configs whose head dim is not d_model / H (256 / 4 = 64): the
# other head dims the CUDA kernels take, through their plain versions here
HEAD_DIMS = {"mistral-nemo-12b": ("mistral-nemo-12b", 96),
             "hd80": ("llama-3.2-1b", 80), "hd32": ("llama-3.2-1b", 32)}


def _configs(name):
    if name == "kv2":
        jcfg = dataclasses.replace(jget_arch("llama-3.2-1b").reduced(),
                                   num_heads=4, num_kv_heads=2)
    elif name in HEAD_DIMS:
        arch, hd = HEAD_DIMS[name]
        jcfg = dataclasses.replace(jget_arch(arch).reduced(), head_dim=hd)
    else:
        jcfg = jget_arch(name).reduced()
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, rng):
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(1), jcfg))
    for slot in tree["pattern"]:
        for b in ("bq", "bk", "bv"):
            if b in slot["attn"]:
                slot["attn"][b] = rng.standard_normal(
                    slot["attn"][b].shape).astype(np.float32) * 0.1
    return jax.tree.map(jnp.asarray, tree), tree


def _step(vocab, rng, T, n_tok, decode=(), reset=(), adopt=None):
    tokens = rng.integers(0, vocab, (B, T)).astype(np.int32)
    n = np.array(n_tok, np.int32)
    dm = np.isin(np.arange(B), decode)
    rm = np.isin(np.arange(B), reset)
    src = np.full(B, -1, np.int32)
    pages = np.zeros(B, np.int32)
    if adopt:
        row, s, k = adopt
        src[row], pages[row] = s, k
    return dict(tokens=tokens, n_tok=n, decode_mask=dm,
                prefill_mask=(n > 0) & ~dm, reset_mask=rm, share_src=src,
                share_pages=pages)


def _compare(jlogits, jcache, tlogits, tcache, n_tok, period, ctx):
    live = n_tok > 0
    np.testing.assert_allclose(tlogits.numpy()[live],
                               np.asarray(jlogits)[live], atol=1e-4,
                               err_msg=f"{ctx}: logits")
    jl = jax_cache_layers(jax.device_get(jcache), period)
    tn = cache_to_numpy(tcache)
    np.testing.assert_array_equal(tn["cur_pos"], np.asarray(jcache.cur_pos))
    for i, (j, t) in enumerate(zip(jl, tn["layers"])):
        jn = layer_cache_to_numpy(j)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(t[f], jn[f],
                                          err_msg=f"{ctx}: layer {i} {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(t[f], jn[f], atol=1e-4,
                                       err_msg=f"{ctx}: layer {i} {f}")


def test_mistral_nemo_resolves_as_in_jax():
    from repro_torch.configs import get_arch
    cfg = get_arch("mistral-nemo-12b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_arch("mistral-nemo-12b"))
    assert cfg.resolved_head_dim * cfg.num_heads != cfg.d_model
    cfg.validate()


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen2.5-3b", "kv2",
                                  "mistral-nemo-12b", "hd80", "hd32"])
def test_forward_step_matches_jax(arch):
    rng = np.random.default_rng(0)
    jcfg, tcfg = _configs(arch)
    jparams, tree = _params(jcfg, rng)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    ck = dict(page_size=8, cache_budget=24, policy="paged_eviction",
              dtype="float32")
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy("paged_eviction"), get_policy("paged_eviction")
    jcache = jtf.init_decode_caches(jcfg, B, 80, jpol, jccfg,
                                    chunk_tokens=CHUNK, track_stats=True)
    tcache = ttf.init_decode_caches(tcfg, B, 80, tpol, tccfg,
                                    chunk_tokens=CHUNK, track_stats=True,
                                    device="cpu")
    for j, t in zip(jax_cache_layers(jax.device_get(jcache),
                                     jcfg.pattern_period), tcache.layers):
        for f, want in layer_cache_to_numpy(j).items():
            np.testing.assert_array_equal(layer_cache_to_numpy(t)[f], want)
    V = jcfg.vocab_size
    plan = [
        _step(V, rng, CHUNK, [16, 16, 10], reset=[0, 1, 2]),
        None,                      # prefix adoption, planned from the pool
        _step(V, rng, CHUNK, [16, 16, 1], decode=[2]),
        _step(V, rng, CHUNK, [16, 5, 1], decode=[2]),
        _step(V, rng, 1, [1, 1, 1], decode=[0, 1, 2]),
        _step(V, rng, 1, [1, 1, 1], decode=[0, 1, 2]),
    ]
    for i, st in enumerate(plan):
        if st is None:
            n = int(jtf.intact_prefix_pages(jcache, 0))
            assert int(ttf.intact_prefix_pages(tcache, 0)) == n > 0
            st = _step(V, rng, CHUNK, [16, 16, 12], reset=[2],
                       adopt=(2, 0, n))
        jlogits, jcache = _jstep(jparams, jcfg, policy=jpol, ccfg=jccfg,
                                 cache=jcache,
                                 **{k: jnp.asarray(v) for k, v in st.items()})
        tlogits, tcache = ttf.forward_step(
            tparams, tcfg, policy=tpol, ccfg=tccfg, cache=tcache,
            **{k: torch.from_numpy(v) for k, v in st.items()})
        _compare(jlogits, jcache, tlogits, tcache, st["n_tok"],
                 jcfg.pattern_period, f"{arch} step {i}")


@pytest.mark.parametrize("policy,pool", [
    ("inverse_key_l2", "full"),      # token holes force rollovers mid-chunk
    ("full", "small"),               # a pool of B * P - 2 pages runs dry
])
def test_forward_step_pool_edges_match_jax(policy, pool, monkeypatch):
    """The chunked append at the pool's edges, against JAX's per-token
    scan. Under inverse_key_l2 rows keep every slot mapped with holes and
    force-evict a page in the middle of a chunk: the port's host plan of
    page boundaries (rollover_times) must stay exact. With the full policy
    in a pool of B * P - 2 pages the pool runs dry and rows force-evict to
    roll over; the port then checks every token index. After every step:
    integer fields and devstats bit-equal. Each row's tokens are distinct
    ids: a repeated id gives keys of equal norm up to RoPE's rounding,
    which differs between XLA and torch, so inverse_key_l2 could break such
    a tie either way."""
    from repro.core import paged_cache as jpc
    rng = np.random.default_rng(3)
    jcfg, tcfg = _configs("llama-3.2-1b")
    jparams, tree = _params(jcfg, rng)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    ck = dict(page_size=8, cache_budget=16, policy=policy, dtype="float32")
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy(policy), get_policy(policy)
    if pool == "small":
        def small(init):
            return lambda b, n, *a, **kw: init(b, n, *a,
                                               pool_pages=b * n - 2, **kw)
        monkeypatch.setattr(jpc, "init_layer_cache",
                            small(jpc.init_layer_cache))
        monkeypatch.setattr(ttf, "init_layer_cache",
                            small(ttf.init_layer_cache))
    jcache = jtf.init_decode_caches(jcfg, B, 64, jpol, jccfg,
                                    chunk_tokens=CHUNK, track_stats=True)
    tcache = ttf.init_decode_caches(tcfg, B, 64, tpol, tccfg,
                                    chunk_tokens=CHUNK, track_stats=True,
                                    device="cpu")
    c0 = tcache.layers[0]
    assert (c0.pool_pages < B * c0.num_pages) == (pool == "small")
    V = jcfg.vocab_size
    ids = [iter(rng.permutation(V)) for _ in range(B)]
    plan = [dict(n_tok=[16, 16, 16], reset=[0, 1, 2])] + \
        [dict(n_tok=[16, 16, 16])] * 4 + [dict(n_tok=[1, 1, 1],
                                             decode=[0, 1, 2])] * 2
    forced = []
    for i, kw in enumerate(plan):
        T = max(kw["n_tok"])
        st = _step(V, rng, T, **kw)
        st["tokens"] = np.array([[next(ids[b]) for _ in range(T)]
                                 for b in range(B)], np.int32)
        jlogits, jcache = _jstep(jparams, jcfg, policy=jpol, ccfg=jccfg,
                                 cache=jcache,
                                 **{k: jnp.asarray(v) for k, v in st.items()})
        tlogits, tcache = ttf.forward_step(
            tparams, tcfg, policy=tpol, ccfg=tccfg, cache=tcache,
            **{k: torch.from_numpy(v) for k, v in st.items()})
        _compare(jlogits, jcache, tlogits, tcache, st["n_tok"],
                 jcfg.pattern_period, f"{policy} {pool} pool, step {i}")
        if T > 1:
            forced.append(int(ttf.collect_step_stats(tcache)
                              [devstats.FORCED_EVICTIONS]))
    # a chunk of 16 rolls each row over at t = 0 and t = 8: more forced
    # rollovers in a step than rows times layers means some were mid-chunk
    assert max(forced) > B * len(tcache.layers), forced


def test_init_model_is_seeded_and_shaped():
    _, cfg = _configs("qwen2.5-3b")
    a = ttf.init_model(cfg, seed=3, device="cpu")
    b = ttf.init_model(cfg, seed=3, device="cpu")
    assert len(a["layers"]) == cfg.num_layers
    hd = cfg.resolved_head_dim
    assert a["layers"][0]["attn"]["wk"].shape == (cfg.d_model,
                                                  cfg.num_kv_heads * hd)
    assert "bq" in a["layers"][0]["attn"]
    assert torch.equal(a["embed"], b["embed"])
    for la, lb in zip(a["layers"], b["layers"]):
        for name, w in la["attn"].items():
            assert torch.equal(w, lb["attn"][name])
