"""int8 KV pools of the port against the JAX package's, on the CPU.

- The quantizer and every int8 write path (``write_prompt_pages``,
  ``write_token``, ``append_chunk``, and ``fork_page``'s copy) on the same
  numpy inputs: int8 values, scales and the integer pool state bit-equal.
- The int8 decode kernel's plain version against the Pallas
  ``paged_attention_kernel_int8`` (interpret mode), at the shapes of
  tests/test_quantized_cache.py and on churned pools: outputs within 3e-5,
  norm tiles within 1e-5.
- The chunked prefill on an int8 cache: ``paged_prefill_int8_plain`` and
  ``ops.paged_prefill_attention`` (which take the int8 values and scales;
  on the card the kernel reads them natively) against the JAX package's
  ``paged_prefill_attention`` (its Pallas kernel in interpret mode over the
  dequantized pool) on a churned cache: outputs within 1e-4, page scores
  within 1e-6.
- The serving engine on an int8 pool against the JAX ``Engine``: greedy
  tokens and every step's devstats equal. Both sides rank evictions the
  same way (stored scores, or both the fused epilogue): on int8 pools the
  epilogue scores dequantized tiles while the stored scores predate the
  quantization, so the two can pick different victims.
- The one-shot path (``forward_prefill`` + ``decode_step``) on an int8
  pool: integer state bit-equal, logits within 1e-4, greedy tokens equal.
- ``pool_bytes``: an int8 pool is under 0.54 of a bf16 one at hd 128.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.core import paged_cache as jpc
from repro.core.policies import get_policy as jget_policy
from repro.kernels import ops as jops
from repro.kernels.paged_attention import paged_attention_kernel_int8
from repro.models import transformer as jtf
from repro.serving import Engine as JEngine
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (jax_cache_layers, layer_cache_from_jax,
                                 layer_cache_to_numpy, params_from_jax)
from repro_torch.core import devstats
from repro_torch.core import paged_cache as tpc
from repro_torch.core.policies import get_policy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_prefill import paged_prefill_int8_plain
from repro_torch.kernels.paged_attention import (combine_splits, dequantize,
                                                 paged_attention_int8_plain)
from repro_torch.models import transformer as ttf
from repro_torch.serving import Engine

INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")


def _same(jc, tc, ctx, fields=None):
    jn, tn = layer_cache_to_numpy(jc), layer_cache_to_numpy(tc)
    for f in fields or jn:
        if jn[f] is None:
            assert tn[f] is None, (ctx, f)
        else:
            np.testing.assert_array_equal(tn[f], jn[f], err_msg=f"{ctx}: {f}")


def test_quantize_absmax_bit_equal():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 2, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: scale 0
    jq, js = jpc.quantize_absmax(jnp.asarray(x))
    tq, ts = tpc.quantize_absmax(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("n_pages", [2, 3])          # 3 == the whole table
def test_write_prompt_pages_bit_equal(dtype, n_pages):
    B, P, page, KV, hd = 2, 3, 4, 2, 16
    C = n_pages * page
    rng = np.random.default_rng(n_pages)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    pos[1, -3:] = -1                                   # padding
    score = rng.standard_normal((B, C)).astype(np.float32)
    jc = jpc.write_prompt_pages(
        jpc.init_layer_cache(B, P, page, KV, hd,
                             "int8" if dtype == "int8" else jnp.float32),
        *map(jnp.asarray, (k, v, pos, score)))
    tc = tpc.init_layer_cache(B, P, page, KV, hd,
                              "int8" if dtype == "int8" else torch.float32,
                              device="cpu")
    tpc.write_prompt_pages(tc, *map(torch.from_numpy, (k, v, pos, score)))
    assert tc.quantized == (dtype == "int8")
    _same(jc, tc, f"{dtype} {n_pages} pages")
    for got, want in zip(tpc.to_contiguous(tc), jpc.to_contiguous(jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_writes_and_fork_bit_equal():
    """write_token, append_chunk (with rollovers), then a prefix adoption
    and a copy-on-write fork: every field, scales included, bit-equal."""
    B, P, page, KV, hd, T = 3, 6, 4, 2, 8, 7
    rng = np.random.default_rng(1)
    jc = jpc.init_layer_cache(B, P, page, KV, hd, "int8", track_stats=True)
    tc = tpc.init_layer_cache(B, P, page, KV, hd, "int8", track_stats=True,
                              device="cpu")
    nxt = np.zeros(B, np.int32)
    for step in range(4):
        k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
        v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
        n = rng.integers(0, T + 1, B).astype(np.int32)
        t = np.arange(T)[None, :]
        pos = np.where(t < n[:, None], nxt[:, None] + t, -1).astype(np.int32)
        score = rng.standard_normal((B, T)).astype(np.float32)
        jc = jpc.append_chunk(jc, *map(jnp.asarray, (k, v, pos, score, n)))
        times = tpc.rollover_times(tc.cur_off.numpy(),
                                   tc.head_mapped().numpy(), n, page)
        tpc.append_chunk(tc, *map(torch.from_numpy, (k, v, pos, score, n)),
                         times=times)
        nxt += n
        _same(jc, tc, f"append {step}")
        kt = rng.standard_normal((B, KV, hd)).astype(np.float32)
        act = rng.random(B) < 0.7
        full = np.asarray(jc.cur_off) >= page
        act &= ~full                       # write_token needs room
        args = (kt, kt * 0.5, nxt.copy(), np.ones(B, np.float32))
        jc = jpc.write_token(jc, *map(jnp.asarray, args),
                             active=jnp.asarray(act))
        tpc.write_token(tc, *map(torch.from_numpy, args),
                        active=torch.from_numpy(act))
        nxt += act
        _same(jc, tc, f"write_token {step}")
    # row 2 adopts row 0's first page, then forks it (scales copied)
    en = np.array([False, False, True])
    src = np.array([-1, -1, 0], np.int32)
    npg = np.array([0, 0, 1], np.int32)
    jc = jpc.release_rows(jc, jnp.asarray(en))
    jc = jpc.adopt_prefix(jc, jnp.asarray(src), jnp.asarray(npg),
                          enable=jnp.asarray(en))
    tpc.release_rows(tc, torch.from_numpy(en))
    tpc.adopt_prefix(tc, torch.from_numpy(src), torch.from_numpy(npg),
                     enable=torch.from_numpy(en))
    slot = np.zeros(B, np.int32)
    jc, jforked = jpc.fork_page(jc, jnp.asarray(slot), enable=jnp.asarray(en))
    _, tforked = tpc.fork_page(tc, torch.from_numpy(slot),
                               enable=torch.from_numpy(en))
    assert bool(tforked[2]) and bool(jforked[2])
    _same(jc, tc, "fork")


def _jax_pool(t):
    """(N, page, KV, ...) torch -> the Pallas kernels' (KV, N, page, ...)."""
    return jnp.asarray(np.moveaxis(t.numpy(), 2, 0))


@pytest.mark.parametrize("cur_val,window", [(47, 0), (30, 0), (47, 16)])
def test_int8_decode_plain_matches_pallas(cur_val, window):
    """The shapes of test_quantized_cache.py: B 2, 3 pages of 16, KV 2,
    G 2, hd 128, the pool written by write_prompt_pages."""
    B, P, page, KV, hd, G = 2, 3, 16, 2, 128, 2
    rng = np.random.default_rng(cur_val + window)
    kk = rng.standard_normal((B, 48, KV, hd)).astype(np.float32)
    vv = rng.standard_normal((B, 48, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(48, dtype=np.int32), (B, 1))
    c = tpc.init_layer_cache(B, P, page, KV, hd, "int8", device="cpu")
    tpc.write_prompt_pages(c, torch.from_numpy(kk), torch.from_numpy(vv),
                           torch.from_numpy(pos), torch.ones(B, 48))
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    cur = np.full(B, cur_val, np.int32)
    acc, m, l, _ = paged_attention_int8_plain(
        torch.from_numpy(q), c.k, c.v, c.k_scale, c.v_scale, c.pos,
        c.block_table, torch.from_numpy(cur), window=window)
    want = paged_attention_kernel_int8(
        jnp.asarray(q), _jax_pool(c.k), _jax_pool(c.v), _jax_pool(c.k_scale),
        _jax_pool(c.v_scale), jnp.asarray(c.pos.numpy()),
        jnp.asarray(c.block_table.numpy()), jnp.asarray(cur), window=window)
    np.testing.assert_allclose(combine_splits(acc, m, l).numpy(),
                               np.asarray(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("splits", [1, 3])
def test_int8_decode_plain_matches_pallas_churned(splits):
    k, v, ks, vs, pos, bt, cur = ref.churned_pool(3, 7, 8, 2, 16, torch.int8,
                                                  seed=splits, device="cpu")
    q = torch.randn((3, 2, 2, 16), generator=torch.Generator().manual_seed(0))
    acc, m, l, norms = paged_attention_int8_plain(
        q, k, v, ks, vs, pos, bt, cur, window=20, num_splits=splits,
        return_scores=True)
    jout, jnorms = paged_attention_kernel_int8(
        jnp.asarray(q.numpy()), _jax_pool(k), _jax_pool(v), _jax_pool(ks),
        _jax_pool(vs), jnp.asarray(pos.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(cur.numpy()), window=20, num_splits=splits,
        return_scores=True)
    np.testing.assert_allclose(combine_splits(acc, m, l).numpy(),
                               np.asarray(jout), atol=3e-5, rtol=3e-5)
    for got, want in zip(norms, jnorms):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_dequantize_divides_exactly():
    """x * (s / 127) with s / 127 a true f32 division, as the JAX package's
    k_dequant and the int8 kernels compute it (on the card PyTorch would
    multiply by the reciprocal for a Python-number divisor)."""
    s = np.random.default_rng(0).uniform(0, 4, 1 << 16).astype(np.float32)
    ones = torch.ones((s.size, 1), dtype=torch.int8)
    got = dequantize(ones, torch.from_numpy(s))[:, 0].numpy()
    np.testing.assert_array_equal(got, s / np.float32(127.0))


@pytest.mark.parametrize("window", [0, 20])
def test_int8_prefill_matches_jax(window):
    """A churned int8 cache (3 rows of 7 slots of page 8, KV 2, G 2, hd 16:
    shared pages, unmapped slots, a partly filled page, a prefill row, a
    partial one, a decode row of padding queries); values, scales and q from
    one numpy seed."""
    B, P, page, KV, G, hd, T = 3, 7, 8, 2, 2, 16, 12
    _, _, _, _, pos, bt, cur = ref.churned_pool(B, P, page, KV, hd,
                                                torch.int8, seed=5,
                                                device="cpu")
    N = pos.shape[0]
    rng = np.random.default_rng(window)
    k8, v8 = (rng.integers(-127, 128, (N, page, KV, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.1, 4.0, (N, page, KV)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, T, KV * G, hd)).astype(np.float32)
    qp = ref.prefill_positions(cur, T)
    jc = jpc.PagedLayerCache(
        k=jnp.asarray(k8), v=jnp.asarray(v8), pos=jnp.asarray(pos.numpy()),
        score=jnp.full((N, page), -jnp.inf, jnp.float32),
        block_table=jnp.asarray(bt.numpy()),
        ref_count=jnp.ones((N,), jnp.int32),
        cur_page=jnp.zeros((B,), jnp.int32),
        cur_off=jnp.zeros((B,), jnp.int32),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tc = layer_cache_from_jax(jc, device="cpu")
    jout, jscores = jops.paged_prefill_attention(
        jnp.asarray(q), jc, q_pos=jnp.asarray(qp.numpy()), window=window,
        return_scores=True)
    out, scores = ops.paged_prefill_attention(
        torch.from_numpy(q), tc, q_pos=qp, window=window, return_scores=True)
    plain, norms = paged_prefill_int8_plain(
        torch.from_numpy(q), tc.k, tc.v, tc.k_scale, tc.v_scale, tc.pos,
        tc.block_table, qp, window=window, return_scores=True)
    assert torch.equal(out, plain)
    assert not out[B - 1].any(), "padding queries must output zeros"
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    jscores = np.asarray(jscores)
    np.testing.assert_array_equal(np.isinf(scores.numpy()),
                                  np.isinf(jscores))
    fin = np.isfinite(jscores)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(scores.numpy()[fin], jscores[fin], atol=1e-6,
                               rtol=0)


def _kv2():
    jcfg = dataclasses.replace(jget_arch("llama-3.2-1b").reduced(),
                               num_heads=4, num_kv_heads=2)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    return [np.concatenate([shared if i % 2 == 0
                            else rng.integers(0, vocab, 16),
                            rng.integers(0, vocab, int(rng.integers(4, 32)))])
            .astype(np.int32) for i in range(n)]


@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
def test_int8_engine_matches_jax(fused):
    jcfg, tcfg = _kv2()
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    ck = dict(page_size=8, cache_budget=32, policy="paged_eviction",
              dtype="int8")
    common = dict(max_batch=3, max_prompt_len=48, max_new_tokens=8,
                  chunk_size=16)
    je = JEngine(jcfg, jparams, cache_cfg=JCacheConfig(**ck),
                 use_pallas=fused, **common)
    te = Engine(tcfg, tparams, cache_cfg=CacheConfig(**ck),
                fused_scores=fused, device="cpu", **common)
    assert te.fused_scores == je.fused_scores == fused
    assert all(c.quantized for c in te.cache.layers)
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
    for i, (jl, tl) in enumerate(zip(
            jax_cache_layers(jax.device_get(je.cache), jcfg.pattern_period),
            te.cache.layers)):
        _same(jl, tl, f"layer {i}", INT_FIELDS)
    # the port's pools carry one trash row (values and scales) per layer
    N = te.cache.layers[0].pool_pages
    assert te.pool_bytes()["payload_total"] * N == \
        je.pool_bytes()["payload_total"] * (N + 1)


_jprefill = jax.jit(jtf.forward_prefill, static_argnames=(
    "cfg", "policy", "ccfg", "total_seq_hint", "use_pallas"))
_jdecode = jax.jit(jtf.decode_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores"))


def test_int8_oneshot_matches_jax():
    """forward_prefill + 6 decode_steps on an int8 pool (the JAX side
    through its int8 decode kernel in interpret mode, both ranking by the
    fused epilogue)."""
    jcfg, tcfg = _kv2()
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(2), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, device="cpu")
    ck = dict(page_size=8, cache_budget=24, policy="paged_eviction",
              dtype="int8")
    jccfg, tccfg = JCacheConfig(**ck), CacheConfig(**ck)
    jpol, tpol = jget_policy("paged_eviction"), get_policy("paged_eviction")
    rng = np.random.default_rng(3)
    B, S = 2, 40
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens), policy=jpol,
                           ccfg=jccfg, total_seq_hint=S + 6)
    tl, tcache = ttf.forward_prefill(tparams, tcfg, torch.from_numpy(tokens),
                                     tpol, tccfg, total_seq_hint=S + 6)
    for step in range(7):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"logits, step {step}")
        for i, (j, t) in enumerate(zip(
                jax_cache_layers(jax.device_get(jcache), jcfg.pattern_period),
                tcache.layers)):
            _same(j, t, f"step {step} layer {i}", INT_FIELDS)
            jn, tn = layer_cache_to_numpy(j), layer_cache_to_numpy(t)
            for f in ("k", "v"):          # one int8 step at most (RoPE bits)
                assert np.abs(tn[f].astype(int) - jn[f].astype(int)).max() \
                    <= 1, (step, i, f)
            for f in ("k_scale", "v_scale", "score"):
                np.testing.assert_allclose(tn[f], jn[f], atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step == 6:
            break
        jl, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                              policy=jpol, ccfg=jccfg, use_pallas=True,
                              fused_scores=True)
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                     tcache, tpol, tccfg, fused_scores=True)
    assert int(tcache.layers[0].total_valid().max()) <= 24 + 8


def test_int8_pool_bytes_under_054_of_bf16():
    def engine(dtype):
        cfg = dataclasses.replace(_kv2()[1], head_dim=128)
        return Engine(cfg, ttf.init_model(cfg, seed=0, device="cpu"),
                      cache_cfg=CacheConfig(page_size=16, cache_budget=64,
                                            dtype=dtype),
                      max_batch=2, max_prompt_len=64, max_new_tokens=8,
                      device="cpu")
    b8 = engine("int8").pool_bytes()["payload_total"]
    b16 = engine("bfloat16").pool_bytes()["payload_total"]
    assert b8 / b16 < 0.54, (b8, b16)
    c8 = tpc.init_layer_cache(2, 4, 16, 2, 128, "int8", device="cpu")
    assert (c8.k.dtype, c8.k_scale.shape) == (torch.int8, (8, 16, 2))
