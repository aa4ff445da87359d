"""The port's attention-only families against the JAX package, on the CPU:
stablelm-3b (LayerNorm, qkv bias), gemma3-27b (3 local layers of window 64
and 1 global; qk-norm, GeGLU), chameleon-34b (qk-norm, G 4), mixtral-8x7b
and mixtral-8x22b (MoE MLP, sliding window 64), each reduced.

Same weights, same inputs, from one numpy seed: the weights are drawn with
numpy in the layout of the JAX package's ``init_model`` tree (its shapes
from ``jax.eval_shape``; matrices scaled as its initialiser scales them,
every norm scale and bias, qk-norm scale and qkv bias away from 1 or 0 so
that each one matters) and handed to the port by ``params_from_jax``.

- ``forward_step``: two prompts of 150 and 97 tokens in chunks of 64, then
  decode: 3 mixed steps, then 4 decode steps, under paged_eviction at a
  budget below the window (32) and above it (128). The decode steps run at
  T 1, the engine's decode-only step, for the two windowed families at
  budget 32, and as rows of steps of T 64 otherwise (each T is a compile
  of the JAX step, its cost on the CPU). Logits within 1e-4,
  greedy tokens equal, every layer's integer pool state and devstats bit
  for bit (so the same victims), K/V/scores within 1e-4;
- the one-shot path: ``forward_prefill`` of the two prompts right-padded
  to 152 tokens, then 4 ``decode_step``s fed the JAX package's greedy
  token, the same checks at the same budgets;
- full-cache teacher-forced decode against ``forward_train``, as the JAX
  package's tests/test_equivalence.py holds its own (MoE at drop-free
  capacity), within its 2e-3;
- ``forward_train``'s logits and aux loss, ``loss_fn``'s gradient leaf by
  leaf (atol 1e-5 + rtol 1e-4, as tests/test_torch_training.py), and one
  ``train_step``'s loss and parameters;
- units: LayerNorm, qk-norm, tanh-GELU, soft-capped logits, the MoE
  dispatch (top-k with exact ties, rank, keep and slot bit for bit, tokens
  dropped) and its outputs, and the dense all-expert combine.

The config, init-layout and full-cache-decode tests also cover the
recurrent families (jamba-1.5-large, xlstm-1.3b), which
tests/test_torch_recurrent.py holds to the JAX package otherwise; the
config and init-layout tests musicgen-medium too (cross-attention,
codebooks), which tests/test_torch_multimodal.py holds to it otherwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CacheConfig as JCacheConfig
from repro.configs import get_arch as jget_arch
from repro.core.policies import get_policy as jget_policy
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro.training.train_step import loss_fn as jloss_fn
from repro_torch.configs import CacheConfig, ModelConfig, get_arch
from repro_torch.convert import (cache_to_numpy, jax_cache_layers,
                                 layer_cache_to_numpy, params_from_jax)
from repro_torch.core import devstats
from repro_torch.core.policies import get_policy
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import (batch_to_device, train_step,
                                             value_and_grad)
from repro_torch.training.tree import key_of, leaves, leaves_with_path

ARCHS = ["stablelm-3b", "gemma3-27b", "chameleon-34b", "mixtral-8x7b",
         "mixtral-8x22b"]
ALL_ARCHS = ARCHS + ["jamba-1.5-large-398b", "xlstm-1.3b"]
# every family of the JAX package: the config and init-layout tests
LAYOUT_ARCHS = ALL_ARCHS + ["musicgen-medium"]
BUDGETS = [32, 128]          # below and above the reduced window of 64
B, CHUNK, PAGE = 2, 64, 8
LENS = (150, 97)
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")
TOL = dict(atol=1e-5, rtol=1e-4)

_jstep = jax.jit(jtf.forward_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores",
    "want_taps", "tp_axis"))
_jprefill = jax.jit(jtf.forward_prefill, static_argnames=(
    "cfg", "policy", "ccfg", "total_seq_hint", "use_pallas"))
_jdecode = jax.jit(jtf.decode_step, static_argnames=(
    "cfg", "policy", "ccfg", "use_pallas", "decode_splits", "fused_scores"))


def _numpy_tree(jcfg, rng):
    """A tree in the layout of the JAX package's ``init_model`` (shapes by
    ``jax.eval_shape``, nothing compiled), drawn with numpy: matrices
    (..., in, out) normal / sqrt(in), embeddings normal * 0.02, norm and
    qk-norm scales 1 + 0.1 normal, biases 0.1 normal."""
    def fill(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name in ("scale", "q_norm", "k_norm"):
            return 1 + 0.1 * x
        if name in ("bias", "bq", "bk", "bv"):
            return 0.1 * x
        if name in ("embed", "lm_head"):
            return 0.02 * x
        return x / np.sqrt(s.shape[-2], dtype=np.float32)
    shapes = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def _model(arch):
    """(jcfg, tcfg, JAX params, numpy tree, port params on the CPU), shared
    by every test of the arch."""
    jcfg = jget_arch(arch).reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = _numpy_tree(jcfg, np.random.default_rng(len(arch)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree,
            params_from_jax(tree, tcfg, device="cpu"))


def _cache_cfgs(budget, policy="paged_eviction"):
    ck = dict(page_size=PAGE, cache_budget=budget, policy=policy,
              dtype="float32")
    return (JCacheConfig(**ck), CacheConfig(**ck), jget_policy(policy),
            get_policy(policy))


def _compare(jlogits, jcache, tlogits, tcache, period, ctx, live=None,
             stats=True):
    live = np.ones(B, bool) if live is None else live
    want = np.asarray(jlogits)[live]
    got = tlogits.numpy()[live]
    np.testing.assert_allclose(got, want, atol=1e-4,
                               err_msg=f"{ctx}: logits")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{ctx}: greedy tokens")
    tn = cache_to_numpy(tcache)
    np.testing.assert_array_equal(tn["cur_pos"], np.asarray(jcache.cur_pos))
    jl = jax_cache_layers(jax.device_get(jcache), period)
    assert len(jl) == len(tn["layers"])
    for i, (j, t) in enumerate(zip(jl, tn["layers"])):
        jn = layer_cache_to_numpy(j)
        for f in INT_FIELDS + (("stats",) if stats else ()):
            np.testing.assert_array_equal(t[f], jn[f],
                                          err_msg=f"{ctx}: layer {i} {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(t[f], jn[f], atol=1e-4,
                                       err_msg=f"{ctx}: layer {i} {f}")


def test_configs_resolve_as_in_jax():
    for name in LAYOUT_ARCHS:
        cfg = get_arch(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_arch(name)), name
        cfg.validate()
        cfg.reduced().validate()
    # musicgen resolves as in JAX, with what the slice ported
    cfg = get_arch("musicgen-medium")
    assert cfg.cross_attention and cfg.num_codebooks == 4
    assert cfg.reduced().cond_len == 8 and cfg.reduced().num_kv_heads == \
        cfg.reduced().num_heads
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("musicgen-large")


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_init_model_matches_jax_layout(arch):
    """The port's seeded init has the JAX tree's leaves, shapes and dtypes
    at bf16 (the leaves the JAX tree holds in f32, such as the MoE router,
    mamba's A_log or the xLSTM gates, f32), and ``params_from_jax``'s bf16
    cast keeps those f32."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype="bfloat16")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                 jcfg))
    jf32 = {path[-1].key for path, s in
            jax.tree_util.tree_leaves_with_path(tree)
            if s.dtype == jnp.float32}
    assert ("router" in jf32) == bool(jcfg.num_experts)
    shapes = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    want = params_from_jax(shapes, tcfg, device="cpu", dtype=torch.bfloat16)
    got = ttf.init_model(tcfg, seed=3, device="cpu")
    again = ttf.init_model(tcfg, seed=3, device="cpu")
    wl = {key_of(p): t for p, t in leaves_with_path(want)}
    gl = {key_of(p): t for p, t in leaves_with_path(got)}
    assert gl.keys() == wl.keys()
    for k, t in gl.items():
        want_dt = torch.float32 if k.split("/")[-1] in jf32 else \
            torch.bfloat16
        assert t.shape == wl[k].shape and t.dtype == wl[k].dtype == want_dt, k
    for a, b in zip(leaves(got), leaves(again)):
        assert torch.equal(a, b)
    specs = jcfg.layer_specs()
    assert [("moe" in lp) for lp in got["layers"]] == \
        [s.mlp == "moe" for s in specs]
    assert [(s.mixer in lp, "mlp" in lp) for lp, s in
            zip(got["layers"], specs)] == \
        [(True, s.mlp == "dense") for s in specs]
    assert all(("bias" in lp["norm1"]) == (jcfg.norm == "layernorm")
               for lp in got["layers"])
    assert all(("q_norm" in lp["attn"]) == jcfg.qk_norm
               for lp in got["layers"] if "attn" in lp)


# ---------------------------------------------------------------------------
# serving step and one-shot path
# ---------------------------------------------------------------------------

def _plan(rng, vocab, decode_T):
    """Steps of (tokens (B, T), n_tok, decode rows, reset rows): the two
    prompts in chunks of 64, then 4 decode steps at T ``decode_T``."""
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    steps, done = [], [0, 0]
    for t in range(3):
        tok = np.zeros((B, CHUNK), np.int32)
        n_tok, dec = [], []
        for b in range(B):
            n = min(CHUNK, LENS[b] - done[b])
            if n <= 0:
                n = 1
                dec.append(b)
                tok[b, 0] = rng.integers(0, vocab)
            else:
                tok[b, :n] = prompts[b][done[b]:done[b] + n]
                done[b] += n
            n_tok.append(n)
        steps.append((tok, n_tok, dec, [0, 1] if t == 0 else []))
    for _ in range(4):
        steps.append((rng.integers(0, vocab, (B, decode_T))
                      .astype(np.int32), [1, 1], [0, 1], []))
    return steps


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_step_matches_jax(arch, budget):
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs(budget)
    seq = max(LENS) + 8
    jcache = jtf.init_decode_caches(jcfg, B, seq, jpol, jccfg,
                                    chunk_tokens=CHUNK, track_stats=True)
    tcache = ttf.init_decode_caches(tcfg, B, seq, tpol, tccfg,
                                    chunk_tokens=CHUNK, track_stats=True,
                                    device="cpu")
    rng = np.random.default_rng(budget)
    freed = 0
    t1 = budget == 32 and arch in ("gemma3-27b", "mixtral-8x7b")
    plan = _plan(rng, jcfg.vocab_size, 1 if t1 else CHUNK)
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
            **{k: torch.from_numpy(v) for k, v in st.items()})
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{arch} budget {budget} step {i}")
        freed += int(ttf.collect_step_stats(tcache)[devstats.PAGES_FREED])
    assert freed > 0          # the budget or the window dropped pages


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_oneshot_matches_jax(arch, budget):
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs(budget)
    rng = np.random.default_rng(budget + 1)
    S, steps = 152, 4
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.array(LENS)[:, None]
    hint = S + steps
    jlogits, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens),
                                policy=jpol, ccfg=jccfg,
                                valid=jnp.asarray(valid), total_seq_hint=hint)
    tlogits, tcache = ttf.forward_prefill(
        tparams, tcfg, torch.from_numpy(tokens), tpol, tccfg,
        valid=torch.from_numpy(valid), total_seq_hint=hint)
    ctx = f"{arch} budget {budget}"
    _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
             f"{ctx} prefill", stats=False)
    for c, spec in zip(tcache.layers, tcfg.layer_specs()):
        assert int(c.total_valid().max()) <= budget + PAGE
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                   policy=jpol, ccfg=jccfg)
        tlogits, tcache = ttf.decode_step(tparams, tcfg,
                                          torch.from_numpy(tok), tcache,
                                          tpol, tccfg)
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{ctx} decode step {step}", stats=False)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_cache_decode_matches_contiguous(arch):
    """Teacher-forced decode over a cache that evicts nothing gives the
    contiguous training forward's logits (MoE layers at drop-free
    capacity: the decode combine drops no token; a recurrent layer's
    decode steps continue its prefill's state, the training forward scans
    the whole sequence: mamba in windows of 1, mLSTM in one chunk of
    38)."""
    _, tcfg, _, _, tparams = _model(arch)
    if tcfg.num_experts:
        tcfg = dataclasses.replace(tcfg,
                                   moe_capacity_factor=float(tcfg.num_experts))
    rng = np.random.default_rng(4)
    S, T = 32, 6
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, S + T))
                              .astype(np.int32))
    with torch.no_grad():
        want, _ = ttf.forward_train(tparams, tcfg, tokens, remat=False)
    ccfg = CacheConfig(page_size=PAGE, cache_budget=64, policy="full",
                       dtype="float32")
    pol = get_policy("full")
    lg, cache = ttf.forward_prefill(tparams, tcfg, tokens[:, :S], pol, ccfg,
                                    total_seq_hint=S + T)
    np.testing.assert_allclose(lg.numpy(), want[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(T - 1):
        lg, cache = ttf.decode_step(tparams, tcfg, tokens[:, S + t], cache,
                                    pol, ccfg)
        np.testing.assert_allclose(lg.numpy(), want[:, S + t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{arch}: decode step {t}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_jax(arch):
    """loss_fn's loss, cross-entropy and aux loss and its gradient leaf by
    leaf, then one train_step (the same value and gradient, then AdamW, as
    the JAX package's train_step) in one JAX program. The first AdamW
    update is lr * g / (|g| + eps): where |g| is within the gradients' own
    tolerance of 0 its sign is not determined, so parameters are held
    within TOL where |g| > 1e-3 and within one step of lr elsewhere."""
    jcfg, tcfg, jparams, tree, _ = _model(arch)
    dcfg = tdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=48,
                            batch_size=B, seed=3)
    batch = tdata.lm_batch(dcfg, 0)
    ocfg = topt.AdamWConfig(**OPT)

    @jax.jit
    def jrun(p, b):
        (loss, parts), g = jax.value_and_grad(jloss_fn, has_aux=True)(
            p, jcfg, b)
        new, _, m = jopt.adamw_update(p, g, jopt.init_adamw(p),
                                      jopt.AdamWConfig(**OPT))
        return loss, parts, g, new, m

    jl, jparts, jg, jnew, jm = jrun(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(tree, tcfg, device="cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    tb = batch_to_device(batch, "cpu")
    (tl, parts), tg = value_and_grad(tp, tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    assert (float(parts["aux"]) > 0) == bool(tcfg.num_experts)
    grads = params_from_jax(jax.device_get(jg), tcfg, device="cpu")
    for (path, a), b in zip(leaves_with_path(tg), leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{arch} grad {key_of(path)}",
                                   **TOL)
    new, _, m = train_step(tp, topt.init_adamw(tp), tb, cfg=tcfg,
                           opt_cfg=ocfg)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm.get(k, jl)),
                                   rtol=1e-5, err_msg=k)
    want = params_from_jax(jax.device_get(jnew), tcfg, device="cpu")
    lr = float(m["lr"])
    for (path, a), b, g in zip(leaves_with_path(new), leaves(want),
                               leaves(grads)):
        a, b, sure = a.detach().numpy(), b.numpy(), g.abs().numpy() > 1e-3
        what = f"{arch} step {key_of(path)}"
        np.testing.assert_allclose(a[sure], b[sure], err_msg=what, **TOL)
        assert np.abs(a - b).max() <= lr * (1 + 1e-4), what


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_norms_activation_soft_cap_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    T = torch.from_numpy
    ln = dict(scale=scale, bias=bias)
    for p in (ln, dict(scale=scale)):
        np.testing.assert_allclose(
            tcommon.apply_norm({k: T(v) for k, v in p.items()}, T(x)).numpy(),
            np.asarray(jcommon.apply_norm(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))),
            atol=1e-5, rtol=1e-5)
    # the population variance: unbiased would be off by 64 / 63
    want = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-6) * scale + bias
    np.testing.assert_allclose(
        tcommon.apply_norm({k: T(v) for k, v in ln.items()}, T(x)).numpy(),
        want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tcommon.rms_head_norm(T(x), T(scale)).numpy(),
        np.asarray(jcommon.rms_head_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=1e-5)
    for name in ("silu", "gelu"):
        np.testing.assert_allclose(
            tcommon.activation(name)(T(x)).numpy(),
            np.asarray(jcommon.activation(name)(jnp.asarray(x))),
            atol=1e-5, rtol=1e-5, err_msg=name)
    # tanh-GELU, not the erf form (they differ by ~1e-4 near |x| = 2)
    erf = torch.nn.functional.gelu(T(x)).numpy()
    assert np.abs(tcommon.activation("gelu")(T(x)).numpy() - erf).max() > 1e-5
    for cap in (0.0, 5.0):
        np.testing.assert_allclose(
            tcommon.soft_cap(T(x * 4), cap).numpy(),
            np.asarray(jcommon.soft_cap(jnp.asarray(x * 4), cap)),
            atol=1e-5, rtol=1e-5)
    # lm_logits applies the config's cap
    jcfg, tcfg, jparams, _, tparams = _model("gemma3-27b")
    jcfg, tcfg = (dataclasses.replace(c, logit_soft_cap=0.3)
                  for c in (jcfg, tcfg))
    h = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    got = ttf.lm_logits(tparams, tcfg, T(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtf.lm_logits(
        jparams, jcfg, jnp.asarray(h))), atol=1e-5, rtol=1e-5)
    # the uncapped logits reach ~0.5: the cap bites
    assert 0.25 < np.abs(got).max() <= 0.3


def _moe_inputs(arch="mixtral-8x7b", S=40):
    """The reduced arch's first MoE layer, its router's expert 2 made a
    copy of expert 1 (every token's probabilities then tie exactly), and
    (B, S, D) inputs."""
    jcfg, tcfg, _, tree, _ = _model(arch)
    p = {k: np.array(v[0]) for k, v in tree["pattern"][0]["moe"].items()}
    p["router"][:, 2] = p["router"][:, 1]
    x = np.random.default_rng(7).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()}, x)


def test_moe_dispatch_and_forward_match_jax():
    """Routing and the capacity dispatch bit for bit at a capacity of 8 (of
    a fair share of 20: tokens drop), top-k ties broken toward the lower
    expert as jax.lax.top_k does; outputs and stats within 1e-5."""
    jcfg, tcfg, jp, tp, x = _moe_inputs()
    E, K, cap = jcfg.num_experts, jcfg.num_experts_per_tok, 8
    # the JAX package's routing and dispatch (moe.py's _moe_block)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jtop_p, jtop_e = jax.lax.top_k(probs, K)
    jflat = jtop_e.reshape(B, -1)
    jrank = jmoe._rank_in_expert(jflat, E)
    jkeep = jrank < cap
    jdst = jnp.where(jkeep, jflat * cap + jrank, E * cap)
    tprobs, ttop_p, ttop_e = tmoe.route(tp, tcfg, torch.from_numpy(x))
    assert bool((tprobs[..., 1] == tprobs[..., 2]).all())
    # experts 1 and 2 tie on every token: JAX picks 2 only beside 1
    has = [(np.asarray(jtop_e) == e).any(-1) for e in (1, 2)]
    assert has[0].any() and not (has[1] & ~has[0]).any()
    np.testing.assert_array_equal(ttop_e.numpy(), np.asarray(jtop_e))
    np.testing.assert_allclose(
        ttop_p.numpy(), np.asarray(jtop_p / jtop_p.sum(-1, keepdims=True)),
        atol=1e-6)
    rank, keep, dst = tmoe.dispatch(ttop_e.reshape(B, -1), E, cap)
    for name, t, j in (("rank", rank, jrank), ("keep", keep, jkeep),
                       ("dst", dst, jdst)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert not bool(keep.all())
    jout, jst = jmoe.moe_forward(jp, jcfg, jnp.asarray(x), capacity=cap)
    tout, tst = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x), capacity=cap)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    for name in ("load", "dropped", "aux_loss"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-6, err_msg=name)
    assert float(tst.dropped) > 0
    # the default capacity, rounded up to a multiple of 8 as in JAX
    for S in (1, 7, 40, 97, 150):
        assert tmoe.moe_capacity(tcfg, S) == jmoe.moe_capacity(jcfg, S)
    # an ``ac`` without a grid (the JAX package's Identity) leaves the
    # block as on one device
    pout, pst = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x),
                                 capacity=cap, ac=lambda a: a)
    assert torch.equal(pout, tout) and all(
        torch.equal(a, b) for a, b in zip(pst, tst))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_moe_decode_matches_jax(arch):
    """The dense all-expert combine over (N, D) tokens, with tied router
    probabilities; at drop-free capacity it computes what the dispatch
    does."""
    jcfg, tcfg, jp, tp, x = _moe_inputs(arch, S=24)
    flat = x.reshape(-1, jcfg.d_model)
    got = tmoe.moe_forward_decode(tp, tcfg, torch.from_numpy(flat))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmoe.moe_forward_decode(jp, jcfg,
                                                        jnp.asarray(flat))),
        atol=1e-5, rtol=1e-5)
    full, st = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x),
                                capacity=x.shape[1] * jcfg.num_experts_per_tok)
    assert float(st.dropped) == 0.0
    np.testing.assert_allclose(got.numpy(), full.reshape(flat.shape).numpy(),
                               atol=1e-5, rtol=1e-5)
