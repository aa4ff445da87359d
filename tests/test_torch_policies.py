"""The port's eviction policies against the JAX package's.

Pool states are built by the JAX package (chunked appends with tie-heavy
scores: quarters, so page means and token ranks tie often and sum exactly)
and handed over to the port; each policy hook then runs on both, for all
five policies. The EvictionOutcome, victims included, and the whole cache
afterwards must be equal, with fused page scores or the stored-score
reduction, window 0 or not, protect_recent on or off, and all-inactive
masks (the JAX ``lax.cond`` skips, the port's gates). The token-level
policies ignore the fused scores and protect_recent: their cases must come
out the same either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.core import importance as jimp
from repro.core import paged_cache as jpc
from repro.core.policies import get_policy as jget_policy
from repro_torch.configs import CacheConfig
from repro_torch.convert import layer_cache_from_jax, layer_cache_to_numpy
from repro_torch.core import importance
from repro_torch.core.policies import POLICIES, get_policy

B, P, page, KV, hd, T = 4, 8, 4, 2, 8, 6
ALL = ["paged_eviction", "full", "streaming_llm", "inverse_key_l2", "keydiff"]


_STATES = {}


def _state(seed, steps=4):
    """A JAX pool after a few chunked appends with quarter scores (built
    once per seed and step count), and a generator for the hook's inputs."""
    key = (seed, steps)
    if key not in _STATES:
        _STATES[key] = _build_state(seed, steps)
    return _STATES[key], np.random.default_rng(seed + 100)


def _build_state(seed, steps):
    rng = np.random.default_rng(seed)
    c = jpc.init_layer_cache(B, P, page, KV, hd, jnp.float32,
                             track_stats=True)
    nxt = np.zeros(B, np.int32)
    for _ in range(steps):
        n = rng.integers(0, T + 1, B).astype(np.int32)
        t = np.arange(T, dtype=np.int32)
        pos = np.where(t[None] < n[:, None], nxt[:, None] + t, -1)
        c = jpc.append_chunk(
            c, jnp.asarray(rng.standard_normal((B, T, KV, hd), np.float32)),
            jnp.asarray(rng.standard_normal((B, T, KV, hd), np.float32)),
            jnp.asarray(pos.astype(np.int32)),
            jnp.asarray((rng.integers(1, 4, (B, T)) / 4).astype(np.float32)),
            jnp.asarray(n))
        nxt += n
    return c


def _page_scores(rng, fused):
    if not fused:
        return None, None
    ps = rng.integers(1, 3, (B, P)).astype(np.float32)
    ps[rng.random((B, P)) < 0.2] = np.inf
    return jnp.asarray(ps), torch.from_numpy(ps)


def _same_cache(jc, tc):
    jn, tn = layer_cache_to_numpy(jc), layer_cache_to_numpy(tc)
    for f, want in jn.items():
        np.testing.assert_array_equal(tn[f], want, err_msg=f)


@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("policy", ALL)
@pytest.mark.parametrize("seed", [0, 1])
def test_post_write_matches_jax(seed, policy, protect, fused):
    jc, rng = _state(seed)
    tc = layer_cache_from_jax(jc, device="cpu")
    ck = dict(page_size=page, cache_budget=8, policy=policy,
              protect_recent=protect, dtype="float32")
    active = rng.random(B) < 0.8
    jps, tps = _page_scores(rng, fused)
    jo = jget_policy(policy).post_write(jc, JCacheConfig(**ck),
                                        active=jnp.asarray(active),
                                        page_scores=jps)
    to = get_policy(policy).post_write(tc, CacheConfig(**ck),
                                       active=torch.from_numpy(active),
                                       page_scores=tps)
    for name in ("pages_evicted", "tokens_evicted", "forced_evictions",
                 "victim_page", "victim_score"):
        a, b = getattr(jo, name), getattr(to, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    _same_cache(jo.cache, to.cache)


@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("policy", ALL)
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_prefill_evict_matches_jax(seed, policy, protect, fused,
                                         window):
    jc, rng = _state(seed, steps=6)
    tc = layer_cache_from_jax(jc, device="cpu")
    ck = dict(page_size=page, cache_budget=8, policy=policy,
              protect_recent=protect, dtype="float32")
    jps, tps = _page_scores(rng, fused)
    # the JAX hook's body (its lax.cond runs it when any row is active)
    active = rng.random(B) < 0.6
    assert active.any()
    jc = jget_policy(policy)._chunk_evict_body(
        jc, JCacheConfig(**ck), jnp.asarray(active), window, jps)
    pol = get_policy(policy)
    pol.chunk_prefill_evict(tc, CacheConfig(**ck),
                            active=torch.from_numpy(active), window=window,
                            page_scores=tps)
    _same_cache(jc, tc)
    # no active row: the hook leaves the cache as it is
    pol.chunk_prefill_evict(tc, CacheConfig(**ck),
                            active=torch.zeros(B, dtype=torch.bool),
                            window=window, page_scores=tps)
    _same_cache(jc, tc)


@pytest.mark.parametrize("score", ["vk_ratio", "inverse_key_l2", "keydiff",
                                   "block_scores"])
def test_write_score_matches_jax(score):
    """The importance scores, f32: the paper's ratio within 1e-6 relative,
    the baselines' within 1e-6 absolute (KeyDiff with a zero key, so the
    1e-6 floor on the norm product is taken)."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 8, KV, hd), np.float32)
    v = rng.standard_normal((3, 8, KV, hd), np.float32)
    k[0, 3] = 0.0
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tol = dict(atol=1e-6)
    if score == "vk_ratio":
        got = importance.vk_ratio_score(tk, tv)
        want = jimp.vk_ratio_score(jk, jv)
        tol = dict(rtol=1e-6)
    elif score == "inverse_key_l2":
        got = importance.inverse_key_l2_score(tk)
        want = jimp.inverse_key_l2_score(jk)
    elif score == "keydiff":
        got = importance.keydiff_score(tk, tk.mean(1, keepdim=True))
        want = jimp.keydiff_score(jk, jk.mean(1, keepdims=True))
    else:
        ts = rng.integers(0, 8, (3, 16)).astype(np.float32) / 4
        valid = rng.random((3, 16)) < 0.6
        valid[1, :4] = False                       # an empty block: +inf
        got = importance.block_scores_from_token_scores(
            torch.from_numpy(ts), torch.from_numpy(valid), 4)
        want = jimp.block_scores_from_token_scores(jnp.asarray(ts),
                                                   jnp.asarray(valid), 4)
        assert np.isinf(np.asarray(want)[1, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_get_policy_knows_the_five():
    assert sorted(POLICIES) == sorted(ALL)
    for name in ALL:
        assert get_policy(name).name == name
    assert [get_policy(n).structured for n in ALL] == \
        [jget_policy(n).structured for n in ALL]
    with pytest.raises(KeyError, match="unknown policy"):
        get_policy("h2o")
