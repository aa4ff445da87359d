"""The port's examples (``repro_torch.examples``), each ``main`` at small
flags on the CPU.

``quickstart`` and ``eviction_comparison`` take the JAX package's weights,
prompt and K/V draws (the JAX scripts' seeds) and their integer cache
outcome (live tokens and tokens per page at every step, the block table
and the retained positions, eviction counts) is held to the JAX package's
functions called here with the same inputs. The other three are held to
their invariants: the budget bounds the live tokens, the generated
counts, the loss falls, the checkpoint restores equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax


def _jax_quickstart(steps: int):
    import jax
    import jax.numpy as jnp

    from repro.configs import CacheConfig, get_arch as jget_arch
    from repro.core import get_policy
    from repro.models import (decode_step, forward_prefill, init_model,
                              make_inputs)
    cfg = jget_arch("qwen2.5-3b").reduced()
    params = init_model(jax.random.PRNGKey(0), cfg)
    ccfg = CacheConfig(page_size=8, cache_budget=64,
                       policy="paged_eviction", dtype="float32")
    policy = get_policy(ccfg.policy)
    prompt = make_inputs(jax.random.PRNGKey(1), cfg, batch=1,
                         seq_len=96)["tokens"]
    logits, cache = forward_prefill(params, cfg, prompt, policy, ccfg,
                                    total_seq_hint=128)
    layer0 = lambda c: jax.tree.map(lambda a: a[0], c.pattern[0].kv)  # noqa
    out = {"live_after_prefill": int(layer0(cache).total_valid()[0]),
           "steps": [], "tokens": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, tok, cache, policy, ccfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["tokens"].append(int(tok[0]))
        kv = layer0(cache)
        out["steps"].append({"live": int(kv.total_valid()[0]),
                             "tokens_per_page":
                             np.asarray(kv.tokens_per_page())[0].tolist()})
    kv = layer0(cache)
    out["block_table"] = np.asarray(kv.block_table)
    out["pos"] = np.asarray(kv.pos)
    return jax.device_get(params), np.asarray(prompt), out


def test_quickstart_matches_jax():
    from repro_torch.examples import quickstart
    steps = 20
    jparams, prompt, want = _jax_quickstart(steps)
    cfg = get_arch("qwen2.5-3b").reduced()
    got = quickstart.main(["--device", "cpu", "--steps", str(steps)],
                          params=params_from_jax(jparams, cfg, device="cpu"),
                          prompt=torch.from_numpy(prompt))
    assert got["finite"]
    assert got["live_after_prefill"] == want["live_after_prefill"] == 64
    assert got["steps"] == want["steps"]
    assert got["tokens"] == want["tokens"]
    np.testing.assert_array_equal(got["block_table"], want["block_table"])
    np.testing.assert_array_equal(got["pos"], want["pos"])
    # the block-structure invariant: every page but the working one full
    for st in got["steps"]:
        assert st["live"] <= got["budget"] + got["page"]


def _jax_traces(steps: int):
    """The JAX script's draws (split per step into k1, k2) and each
    policy's cache after them."""
    import jax
    import jax.numpy as jnp

    from repro.configs import CacheConfig
    from repro.core import decode_append, get_policy, init_layer_cache
    from repro_torch.examples.eviction_comparison import (B, BUDGET, HD,
                                                          KV, PAGE, POLICIES)
    rng = jax.random.PRNGKey(0)
    draws = []
    for _ in range(steps):
        rng, k1, k2 = jax.random.split(rng, 3)
        draws.append([np.asarray(jax.random.normal(k1, (B, KV, HD))),
                      np.asarray(jax.random.normal(k2, (B, KV, HD)))])
    out = {}
    for name in POLICIES:
        pol = get_policy(name)
        cfg = CacheConfig(page_size=PAGE, cache_budget=BUDGET, policy=name,
                          dtype="float32")
        cache = init_layer_cache(B, pol.slab_pages(cfg, steps), PAGE, KV, HD,
                                 jnp.float32)
        ev = 0
        for t, (k, v) in enumerate(draws):
            o = decode_append(cache, jnp.asarray(k), jnp.asarray(v),
                              jnp.full((B,), t), pol, cfg)
            cache = o.cache
            ev += int(o.pages_evicted.any()) + int(o.tokens_evicted.any())
        out[name] = {"live": int(cache.total_valid()[0]), "eviction_ops": ev,
                     "block_table": np.asarray(cache.block_table),
                     "pos": np.asarray(cache.pos)}
    return np.asarray(draws, dtype=np.float32), out


def test_eviction_comparison_matches_jax():
    from repro_torch.examples import eviction_comparison
    draws, want = _jax_traces(eviction_comparison.STEPS)
    got = eviction_comparison.main(["--device", "cpu"],
                                   kv=torch.from_numpy(draws))
    for name, w in want.items():
        g = got[name]
        assert (g["live"], g["eviction_ops"]) == (w["live"],
                                                  w["eviction_ops"]), name
        np.testing.assert_array_equal(g["block_table"], w["block_table"],
                                      err_msg=name)
        np.testing.assert_array_equal(g["pos"], w["pos"], err_msg=name)
    assert got["paged_eviction"]["fragmented"] == 0
    assert got["inverse_key_l2"]["fragmented"] > 0


def test_long_context_decode_holds_the_budget():
    from repro_torch.examples import long_context_decode
    got = long_context_decode.main(["--device", "cpu", "--steps", "40"])
    assert got["finite"]
    (cp,) = got["checkpoints"]
    assert cp["position"] == 96 + 40
    assert cp["live"] <= got["budget"] + got["page"]
    assert cp["oldest"] >= 0


@pytest.mark.parametrize("policy", ["paged_eviction", "streaming_llm"])
def test_serve_batch_finishes_every_request(policy):
    from repro_torch.examples import serve_batch
    got = serve_batch.main(["--device", "cpu", "--requests", "3",
                            "--new-tokens", "6", "--policy", policy])
    assert got["requests"] == 3
    assert got["generated"] == [6, 6, 6]
    # a row holds at most the budget plus one chunk between chunk ends
    assert 0 < got["max_live"] <= got["budget"] + got["chunk"]


def test_train_small_trains_restores_and_serves():
    from repro_torch.examples import train_small
    got = train_small.main(["--device", "cpu", "--steps", "6", "--batch",
                            "2", "--seq", "32"])
    assert all(np.isfinite(got["losses"]))
    assert got["losses"][-1] < got["losses"][0]
    assert got["saved_step"] == 6 and got["restored_equal"]
    assert len(got["generated"]) == 16


def test_examples_default_to_cuda():
    """Without --device an example asks for the card (and raises here)."""
    from repro_torch.examples import quickstart
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
