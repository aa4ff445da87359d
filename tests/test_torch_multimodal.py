"""The port's musicgen (cross-attention to static conditioning, four
parallel codebooks) against the JAX package, on the CPU, on the reduced
musicgen-medium (f32, 2 layers, d 256, 4 heads = 4 KV heads, cond_len 8,
K 4, vocab 512).

Same weights, same inputs, from one numpy seed: the weights are drawn with
numpy in the layout of the JAX package's ``init_model`` tree (norm scales
and biases away from 1 and 0) and handed to the port by
``params_from_jax``; token ids and the conditioning are numpy too.

- ``make_cross_cache`` and ``cross_attention_forward`` within 1e-4;
- ``embed_tokens`` / ``lm_logits`` with codebooks (a (K, V, D) table
  indexed codebook by codebook, not on its first axis);
- ``forward_train(cond)``: logits, loss and every leaf's gradient
  (``xattn``'s nonzero), and one AdamW step;
- the one-shot path: ``forward_prefill(cond)`` of two prompts of 150 and 97
  tokens right-padded to 152, then 4 ``decode_step``s fed the JAX
  package's greedy tokens per codebook, under paged_eviction at budgets 32
  and 128: logits within 1e-4, greedy tokens equal, every layer's integer
  pool state bit for bit (the same victims), K/V/scores and the cross
  caches within 1e-4; and under ``full``, teacher-forced decode against
  ``forward_train`` (as the JAX package's tests/test_equivalence.py);
- ``forward_step`` with cross caches from ``make_cross_cache`` over mixed
  and decode steps, the same checks with devstats;
- ``convert``: a JAX ``ModelCache`` with ``xattn`` crosses to the port's
  ``cross``; the (K, V, D) embed / lm_head and the xattn / norm_x leaves
  cross as they are;
- the serving engine and ``launch/serve.py`` refuse codebooks;
  ``launch/train.py`` trains musicgen with its conditioning.

Token ids are drawn without repeats within a row and codebook, so that no
two keys of a row tie on their norms (ROADMAP Queue 3, fault 4).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.core.policies import get_policy as jget_policy
from repro.models import attention as jattn
from repro.models import multimodal as jmm
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro.training.train_step import loss_fn as jloss_fn
from repro_torch.configs import CacheConfig, ModelConfig, get_arch
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 jax_cache_cross, jax_cache_layers,
                                 layer_cache_to_numpy, params_from_jax)
from repro_torch.core import devstats
from repro_torch.core.policies import get_policy
from repro_torch.models import attention as tattn
from repro_torch.models import multimodal as tmm
from repro_torch.models import transformer as ttf
from repro_torch.serving import Engine
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import (batch_to_device, train_step,
                                             value_and_grad)
from repro_torch.training.tree import key_of, leaves, leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
ARCH = "musicgen-medium"
B, CHUNK, PAGE = 2, 64, 8
LENS = (150, 97)
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")
TOL = dict(atol=1e-5, rtol=1e-4)
T = torch.from_numpy

_jstep = jax.jit(jtf.forward_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores",
    "want_taps", "tp_axis"))
_jprefill = jax.jit(jtf.forward_prefill, static_argnames=(
    "cfg", "policy", "ccfg", "total_seq_hint", "use_pallas"))
_jdecode = jax.jit(jtf.decode_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores"))


def _numpy_tree(jcfg, rng):
    """A tree in the layout of the JAX package's ``init_model`` (shapes by
    ``jax.eval_shape``), drawn with numpy: matrices (..., in, out) normal /
    sqrt(in), embeddings normal * 0.02, norm scales 1 + 0.1 normal, biases
    0.1 normal."""
    def fill(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1 + 0.1 * x
        if name == "bias":
            return 0.1 * x
        if name in ("embed", "lm_head"):
            return 0.02 * x
        return x / np.sqrt(s.shape[-2], dtype=np.float32)
    shapes = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def _model():
    """(jcfg, tcfg, JAX params, numpy tree, port params on the CPU)."""
    jcfg = jget_arch(ARCH).reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = _numpy_tree(jcfg, np.random.default_rng(20))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree,
            params_from_jax(tree, tcfg, device="cpu"))


def _tokens(rng, K, vocab, S):
    """(B, K, S) int32 ids, no repeat within a row and codebook."""
    return np.stack([np.stack([rng.permutation(vocab)[:S] for _ in range(K)])
                     for _ in range(B)]).astype(np.int32)


def _cond(rng, cfg, batch=B):
    return rng.standard_normal((batch, cfg.cond_len, cfg.d_model)) \
        .astype(np.float32)


def _cache_cfgs(budget, policy="paged_eviction"):
    ck = dict(page_size=PAGE, cache_budget=budget, policy=policy,
              dtype="float32")
    return (JCacheConfig(**ck), CacheConfig(**ck), jget_policy(policy),
            get_policy(policy))


def _compare(jlogits, jcache, tlogits, tcache, period, ctx, stats=True):
    want, got = np.asarray(jlogits), tlogits.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"{ctx}: logits")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{ctx}: greedy tokens")
    tn = cache_to_numpy(tcache)
    np.testing.assert_array_equal(tn["cur_pos"], np.asarray(jcache.cur_pos))
    jc = jax.device_get(jcache)
    jl = jax_cache_layers(jc, period)
    assert len(jl) == len(tn["layers"])
    for i, (j, t) in enumerate(zip(jl, tn["layers"])):
        jn = layer_cache_to_numpy(j)
        for f in INT_FIELDS + (("stats",) if stats else ()):
            np.testing.assert_array_equal(t[f], jn[f],
                                          err_msg=f"{ctx}: layer {i} {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(t[f], jn[f], atol=1e-4,
                                       err_msg=f"{ctx}: layer {i} {f}")
    jx = jax_cache_cross(jc, period)
    assert all(x is not None for x in jx)
    for i, (j, t) in enumerate(zip(jx, tn["cross"])):
        for f in ("k", "v"):
            np.testing.assert_allclose(t[f], np.asarray(getattr(j, f)),
                                       atol=1e-4,
                                       err_msg=f"{ctx}: layer {i} cross {f}")


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_inputs_match_jax_shapes():
    jcfg, tcfg = _model()[:2]
    for b, s in ((1, 1), (3, 17)):
        assert tmm.token_shape(tcfg, b, s) == jmm.token_shape(jcfg, b, s)
        assert tmm.decode_token_shape(tcfg, b) == \
            jmm.decode_token_shape(jcfg, b)
    text = get_arch("llama-3.2-1b")
    assert tmm.token_shape(text, 2, 5) == (2, 5)
    assert tmm.decode_token_shape(text, 2) == (2,)
    gen = torch.Generator().manual_seed(0)
    got = tmm.make_inputs(gen, tcfg, 3, 11, device="cpu")
    want = jmm.make_inputs(jax.random.PRNGKey(0), jcfg, 3, 11)
    assert got["tokens"].shape == want["tokens"].shape
    assert got["tokens"].dtype == torch.int32
    assert 0 <= int(got["tokens"].min()) and \
        int(got["tokens"].max()) < tcfg.vocab_size
    assert got["cond"].shape == want["cond"].shape
    assert got["cond"].dtype == torch.float32
    assert tmm.make_inputs(gen, text.reduced(), 1, 4, "cpu")["cond"] is None


def test_cross_attention_matches_jax():
    """make_cross_cache and cross_attention_forward on layer 0's xattn
    block, within 1e-4; in bf16 the output keeps the activations' dtype."""
    jcfg, tcfg, _, tree, _ = _model()
    rng = np.random.default_rng(1)
    p = {k: np.asarray(v[0]) for k, v in tree["pattern"][0]["xattn"].items()}
    x = rng.standard_normal((B, 13, jcfg.d_model)).astype(np.float32)
    cond = _cond(rng, jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    jc = jattn.make_cross_cache(jp, jcfg, jnp.asarray(cond))
    tc = tattn.make_cross_cache(tp, tcfg, T(cond))
    for f in ("k", "v"):
        assert getattr(tc, f).shape == (B, jcfg.cond_len, jcfg.num_kv_heads,
                                        jcfg.resolved_head_dim)
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-4)
    got = tattn.cross_attention_forward(tp, tcfg, T(x), tc)
    want = jattn.cross_attention_forward(jp, jcfg, jnp.asarray(x), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the conditioning matters: another one gives another output
    other = tattn.make_cross_cache(tp, tcfg, T(_cond(rng, jcfg)))
    assert float((tattn.cross_attention_forward(tp, tcfg, T(x), other)
                  - got).abs().max()) > 1e-3
    bf = {k: v.bfloat16() for k, v in tp.items()}
    out = tattn.cross_attention_forward(
        bf, tcfg, T(x).bfloat16(),
        tattn.make_cross_cache(bf, tcfg, T(cond).bfloat16()))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=0.05)


def test_codebook_embed_and_logits_match_jax():
    """(B, K, S) and (B, K) tokens through the (K, V, D) tables, summed
    over K; logits (..., K, V). A lookup on the table's first axis
    (``embed[tokens]``) gives another result."""
    jcfg, tcfg, jparams, _, tparams = _model()
    rng = np.random.default_rng(2)
    K = jcfg.num_codebooks
    assert tparams["embed"].shape == (K, jcfg.vocab_size, jcfg.d_model)
    assert tparams["lm_head"].shape == tparams["embed"].shape
    for shape in ((B, K, 9), (B, K)):
        tok = rng.integers(0, jcfg.vocab_size, shape).astype(np.int32)
        got = ttf.embed_tokens(tparams, tcfg, T(tok))
        want = jtf.embed_tokens(jparams, jcfg, jnp.asarray(tok))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    wrong = tparams["embed"].sum(0)[T(tok).long()].sum(1)
    assert float((wrong - got).abs().max()) > 1e-3
    for shape in ((B, 5, jcfg.d_model), (B, jcfg.d_model)):
        h = rng.standard_normal(shape).astype(np.float32)
        got = ttf.lm_logits(tparams, tcfg, T(h))
        want = jtf.lm_logits(jparams, jcfg, jnp.asarray(h))
        assert got.shape == want.shape == shape[:-1] + (K, jcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=5)


@functools.cache
def _jax_train():
    """loss_fn's value, parts and gradient with cond, and one AdamW step,
    in one JAX program, on lm_batch (B 2, K 4, S 48) and a numpy cond."""
    jcfg, _, jparams, _, _ = _model()
    dcfg = tdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=48,
                            batch_size=B, seed=3)
    batch = tdata.lm_batch(dcfg, 0, num_codebooks=jcfg.num_codebooks)
    cond = _cond(np.random.default_rng(3), jcfg)

    @jax.jit
    def jrun(p, b, c):
        (loss, parts), g = jax.value_and_grad(jloss_fn, has_aux=True)(
            p, jcfg, b, cond=c)
        logits, _ = jtf.forward_train(p, jcfg, b["tokens"], cond=c)
        new, _, m = jopt.adamw_update(p, g, jopt.init_adamw(p),
                                      jopt.AdamWConfig(**OPT))
        return loss, parts, g, logits, new, m

    out = jrun(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
               jnp.asarray(cond))
    return batch, cond, jax.device_get(out)


def _port_params(grad=True):
    _, tcfg, _, tree, _ = _model()
    tp = params_from_jax(tree, tcfg, device="cpu")
    for p in leaves(tp):
        p.requires_grad_(grad)
    return tp


def test_forward_train_with_cond_matches_jax():
    """Logits (B, S, K, V), loss and every leaf's gradient (atol 1e-5 +
    rtol 1e-4); the cross-attention weights get a gradient in every layer;
    without cond the cross-attention blocks are skipped, as in JAX."""
    jcfg, tcfg, jparams, _, _ = _model()
    batch, cond, (jl, jparts, jg, jlogits, _, _) = _jax_train()
    tp = _port_params()
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        logits, aux = ttf.forward_train(tp, tcfg, tb["tokens"], cond=T(cond))
        plain, _ = ttf.forward_train(tp, tcfg, tb["tokens"])
    assert logits.shape == (B, 48, jcfg.num_codebooks, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    want_plain, _ = jtf.forward_train(jparams, jcfg,
                                      jnp.asarray(batch["tokens"]))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_plain), **TOL)
    assert float((plain - logits).abs().max()) > 1e-3
    (tl, parts), tg = value_and_grad(tp, tcfg, tb, cond=T(cond))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=1e-6)
    grads = params_from_jax(jg, tcfg, device="cpu")
    names = [key_of(p) for p, _ in leaves_with_path(tg)]
    assert any("/xattn/" in n for n in names) and \
        any("/norm_x/" in n for n in names)
    for (path, a), b in zip(leaves_with_path(tg), leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"grad {key_of(path)}", **TOL)
    for lp in tg["layers"]:
        for block in ("attn", "xattn"):
            for name in ("wq", "wk", "wv", "wo"):
                assert float(lp[block][name].abs().max()) > 0, (block, name)


def test_train_step_with_cond_matches_jax():
    """One train_step with cond: loss, lr and grad norm within 1e-5
    relative; parameters within TOL where |g| > 1e-3, within one step of
    lr elsewhere (the first AdamW update's sign is not determined where
    |g| is within the gradients' tolerance of 0)."""
    _, tcfg, _, _, _ = _model()
    batch, cond, (jl, _, jg, _, jnew, jm) = _jax_train()
    tp = _port_params()
    new, _, m = train_step(tp, topt.init_adamw(tp),
                           batch_to_device(batch, "cpu"), cfg=tcfg,
                           opt_cfg=topt.AdamWConfig(**OPT), cond=T(cond))
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm.get(k, jl)),
                                   rtol=1e-5, err_msg=k)
    want = params_from_jax(jnew, tcfg, device="cpu")
    grads = params_from_jax(jg, tcfg, device="cpu")
    lr = float(m["lr"])
    for (path, a), b, g in zip(leaves_with_path(new), leaves(want),
                               leaves(grads)):
        a, b, sure = a.detach().numpy(), b.numpy(), g.abs().numpy() > 1e-3
        np.testing.assert_allclose(a[sure], b[sure], err_msg=key_of(path),
                                   **TOL)
        assert np.abs(a - b).max() <= lr * (1 + 1e-4), key_of(path)


def test_train_cli_trains_musicgen(tmp_path):
    """launch/train.py on the reduced musicgen: (B, K, S) batches and one
    conditioning for the run, on the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
         "--warmup", "1", "--device", "cpu"], capture_output=True,
        text=True, timeout=120, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "done: 2 steps" in out.stdout
    assert out.stdout.count("loss=") == 2


# ---------------------------------------------------------------------------
# one-shot path and the unified step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [32, 128])
def test_oneshot_with_cond_matches_jax(budget):
    jcfg, tcfg, jparams, _, tparams = _model()
    jccfg, tccfg, jpol, tpol = _cache_cfgs(budget)
    rng = np.random.default_rng(budget + 1)
    S, steps = 152, 4
    tokens = _tokens(rng, jcfg.num_codebooks, jcfg.vocab_size, S)
    cond = _cond(rng, jcfg)
    valid = np.arange(S)[None, :] < np.array(LENS)[:, None]
    hint = S + steps
    jlogits, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens),
                                policy=jpol, ccfg=jccfg,
                                cond=jnp.asarray(cond),
                                valid=jnp.asarray(valid), total_seq_hint=hint)
    tlogits, tcache = ttf.forward_prefill(
        tparams, tcfg, T(tokens), tpol, tccfg, valid=T(valid),
        total_seq_hint=hint, cond=T(cond))
    ctx = f"budget {budget}"
    _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
             f"{ctx} prefill", stats=False)
    for c in tcache.layers:
        assert int(c.total_valid().max()) <= budget + PAGE
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)  # (B, K)
        jlogits, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                   policy=jpol, ccfg=jccfg)
        tlogits, tcache = ttf.decode_step(tparams, tcfg, T(tok), tcache,
                                          tpol, tccfg)
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{ctx} decode step {step}", stats=False)


def test_full_cache_decode_matches_forward_train():
    """Teacher-forced decode over a cache that evicts nothing, with the
    conditioning, gives forward_train's logits (as the JAX package's
    tests/test_equivalence.py holds its own, within 2e-3)."""
    _, tcfg, _, _, tparams = _model()
    rng = np.random.default_rng(4)
    S, steps = 32, 6
    tokens = T(_tokens(rng, tcfg.num_codebooks, tcfg.vocab_size, S + steps))
    cond = T(_cond(rng, tcfg))
    with torch.no_grad():
        want, _ = ttf.forward_train(tparams, tcfg, tokens, cond=cond,
                                    remat=False)
    ccfg = CacheConfig(page_size=PAGE, cache_budget=64, policy="full",
                       dtype="float32")
    pol = get_policy("full")
    lg, cache = ttf.forward_prefill(tparams, tcfg, tokens[..., :S], pol,
                                    ccfg, total_seq_hint=S + steps,
                                    cond=cond)
    np.testing.assert_allclose(lg.numpy(), want[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(steps - 1):
        lg, cache = ttf.decode_step(tparams, tcfg, tokens[..., S + t], cache,
                                    pol, ccfg)
        np.testing.assert_allclose(lg.numpy(), want[:, S + t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"decode step {t}")


def _plan(rng, K, vocab):
    """Steps of (tokens (B, K, T), n_tok, decode rows, reset rows): the two
    prompts in chunks of 64, then 4 decode steps, all at T 64."""
    prompts = [_tokens(rng, K, vocab, n)[0] for n in LENS]
    steps, done = [], [0, 0]
    for t in range(3):
        tok = np.zeros((B, K, CHUNK), np.int32)
        n_tok, dec = [], []
        for b in range(B):
            n = min(CHUNK, LENS[b] - done[b])
            if n <= 0:
                n = 1
                dec.append(b)
                tok[b, :, 0] = rng.integers(0, vocab, K)
            else:
                tok[b, :, :n] = prompts[b][:, done[b]:done[b] + n]
                done[b] += n
            n_tok.append(n)
        steps.append((tok, n_tok, dec, [0, 1] if t == 0 else []))
    for _ in range(4):
        steps.append((rng.integers(0, vocab, (B, K, CHUNK)).astype(np.int32),
                      [1, 1], [0, 1], []))
    return steps


def test_forward_step_with_cross_caches_matches_jax():
    """forward_step over mixed and decode steps with each layer's cross
    cache made from one conditioning by make_cross_cache on both sides
    (the JAX one stacked over the pattern's repetitions): logits (B, K, V),
    greedy tokens, integer pool state and devstats bit for bit, the cross
    caches unchanged."""
    jcfg, tcfg, jparams, _, tparams = _model()
    jccfg, tccfg, jpol, tpol = _cache_cfgs(32)
    seq = max(LENS) + 8
    rng = np.random.default_rng(6)
    cond = _cond(rng, jcfg)
    jcache = jtf.init_decode_caches(jcfg, B, seq, jpol, jccfg,
                                    chunk_tokens=CHUNK, track_stats=True)
    jx = jax.vmap(lambda p: jattn.make_cross_cache(p, jcfg, jnp.asarray(
        cond)))(jparams["pattern"][0]["xattn"])
    jcache = jcache._replace(pattern=[jcache.pattern[0]._replace(xattn=jx)])
    tcache = ttf.init_decode_caches(tcfg, B, seq, tpol, tccfg,
                                    chunk_tokens=CHUNK, track_stats=True,
                                    device="cpu")
    assert all(float(c.k.abs().max()) == 0 for c in tcache.cross)
    tcache.cross = [tattn.make_cross_cache(lp["xattn"], tcfg, T(cond))
                    for lp in tparams["layers"]]
    freed = 0
    plan = _plan(rng, jcfg.num_codebooks, jcfg.vocab_size)
    for i, (tok, n_tok, dec, reset) in enumerate(plan):
        n = np.array(n_tok, np.int32)
        dm = np.isin(np.arange(B), dec)
        st = dict(tokens=tok, n_tok=n, decode_mask=dm,
                  prefill_mask=(n > 0) & ~dm,
                  reset_mask=np.isin(np.arange(B), reset))
        jlogits, jcache = _jstep(jparams, jcfg, policy=jpol, ccfg=jccfg,
                                 cache=jcache,
                                 **{k: jnp.asarray(v) for k, v in st.items()})
        tlogits, tcache = ttf.forward_step(
            tparams, tcfg, policy=tpol, ccfg=tccfg, cache=tcache,
            **{k: T(v) for k, v in st.items()})
        assert tlogits.shape == (B, jcfg.num_codebooks, jcfg.vocab_size)
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"step {i}")
        freed += int(ttf.collect_step_stats(tcache)[devstats.PAGES_FREED])
    assert freed > 0


# ---------------------------------------------------------------------------
# convert, and what refuses codebooks
# ---------------------------------------------------------------------------

def test_cache_from_jax_carries_cross_caches():
    """A JAX ModelCache of forward_prefill(cond) crosses with each layer's
    ``xattn`` in ``cross`` (bit for bit), and back by cache_to_numpy; an
    empty JAX cache's zero xattn crosses too; a text model's cache has no
    cross cache."""
    jcfg, tcfg, jparams, _, _ = _model()
    jccfg, _, jpol, _ = _cache_cfgs(32)
    rng = np.random.default_rng(15)
    tokens = _tokens(rng, jcfg.num_codebooks, jcfg.vocab_size, 24)
    cond = _cond(rng, jcfg)
    _, jc = _jprefill(jparams, jcfg, jnp.asarray(tokens), policy=jpol,
                      ccfg=jccfg, cond=jnp.asarray(cond), total_seq_hint=32)
    jc = jax.device_get(jc)
    tc = cache_from_jax(jc, tcfg, device="cpu")
    jx = jax_cache_cross(jc, jcfg.pattern_period)
    assert len(tc.cross) == len(tc.layers) == jcfg.num_layers
    tn = cache_to_numpy(tc)
    for i, (t, j) in enumerate(zip(tc.cross, jx)):
        assert isinstance(t, tattn.StaticKVCache)
        for f in ("k", "v"):
            want = np.asarray(getattr(j, f))
            assert float(np.abs(want).max()) > 0
            np.testing.assert_array_equal(getattr(t, f).numpy(), want)
            np.testing.assert_array_equal(tn["cross"][i][f], want)
    for t, j in zip(tn["layers"], jax_cache_layers(jc, jcfg.pattern_period)):
        for f, a in layer_cache_to_numpy(j).items():
            if a is not None:
                np.testing.assert_array_equal(t[f], a, err_msg=f)
    empty = cache_from_jax(jax.device_get(jtf.init_decode_caches(
        jcfg, B, 32, jpol, jccfg)), tcfg, device="cpu")
    mine = ttf.init_decode_caches(tcfg, B, 32, get_policy("paged_eviction"),
                                  _cache_cfgs(32)[1], device="cpu")
    for a, b in zip(empty.cross, mine.cross):
        assert a.k.shape == b.k.shape and a.k.dtype == b.k.dtype
        assert not a.k.any() and not b.v.any()
    text = ModelConfig(**dataclasses.asdict(jget_arch("llama-3.2-1b")
                                            .reduced()))
    assert ttf.init_decode_caches(text, B, 32, get_policy("full"),
                                  _cache_cfgs(32)[1], device="cpu").cross \
        == [None] * text.num_layers


def test_params_from_jax_carries_codebooks_and_xattn():
    """The (K, V, D) embed / lm_head cross as they are (not unstacked as
    pattern leaves), each layer gets its own xattn / norm_x, and a bf16
    cast keeps no leaf f32 (musicgen has none); the port's init draws the
    same tree."""
    jcfg, tcfg, _, tree, tparams = _model()
    K, V, D = jcfg.num_codebooks, jcfg.vocab_size, jcfg.d_model
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(tparams[name].numpy(), tree[name])
        assert tparams[name].shape == (K, V, D)
    assert len(tparams["layers"]) == jcfg.num_layers
    for r, lp in enumerate(tparams["layers"]):
        for block in ("xattn", "norm_x"):
            for k, v in lp[block].items():
                np.testing.assert_array_equal(
                    v.numpy(), tree["pattern"][0][block][k][r])
        assert "bq" not in lp["xattn"] and "q_norm" not in lp["xattn"]
    bf = params_from_jax(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in leaves(bf))
    mine = ttf.init_model(tcfg, seed=0, device="cpu")
    assert {key_of(p): t.shape for p, t in leaves_with_path(mine)} == \
        {key_of(p): t.shape for p, t in leaves_with_path(tparams)}


def test_engine_and_serve_refuse_codebooks():
    """The engine refuses a codebook model, naming the one-shot API; so
    does launch/serve.py, with the JAX driver's message. A cross-attention
    model turns prefix sharing off."""
    _, tcfg, _, _, tparams = _model()
    ccfg = CacheConfig(page_size=PAGE, cache_budget=32, dtype="float32")
    with pytest.raises(NotImplementedError, match="forward_prefill"):
        Engine(tcfg, tparams, cache_cfg=ccfg, device="cpu")
    one = dataclasses.replace(tcfg, num_codebooks=1)
    p1 = ttf.init_model(one, seed=0, device="cpu")
    eng = Engine(one, p1, cache_cfg=ccfg, device="cpu", max_batch=2,
                 max_prompt_len=16, max_new_tokens=2)
    assert not eng._sharing_ok
    assert all(c is not None for c in eng.cache.cross)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, env=ENV)
    assert out.returncode != 0
    assert "serve driver targets text archs" in out.stderr
