"""The port's recurrent mixers (mamba, mLSTM, sLSTM) and the two families
that use them, reduced jamba-1.5-large (attention + dense MLP, then 3 mamba
layers with MoE, dense, MoE) and xlstm-1.3b (3 mLSTM layers, 1 sLSTM), in
f32, against the JAX package on the CPU (its plain jnp route: the JAX
package has no Pallas kernel for a recurrent mixer).

Same weights, same inputs, from one numpy seed: the weights are drawn with
numpy in the layout of the JAX package's ``init_model`` tree (its shapes
from ``jax.eval_shape``, each recurrent parameter near its initialiser's
values: A_log about log(1..d_state), dt_bias the inverse softplus of a step
in [0.001, 0.1], the gate biases about -3 and +3) and handed to the port
by ``params_from_jax``. f32 outputs and recurrent states within atol 1e-4:

- the mixers alone: ``mamba_forward`` (windows of 64 and of 1),
  ``mamba_prefill``, ``mamba_decode_step``; ``mlstm_chunkwise`` at chunks
  8 and 16, with and without ``return_state``, from the empty state and
  from a carried one, and ``mlstm_decode_step``; ``slstm_forward`` and
  ``slstm_decode_step``;
- ``_scan_recurrent`` with ragged ``n_tok``, a reset row and an idle row;
- ``forward_step`` over chunked prefill (a slot reused by a new request)
  and decode: greedy tokens equal, jamba's attention pool state and
  devstats bit for bit, the recurrent states within 1e-4;
- the one-shot path, and fault 9 (the reference's design): a right-padded
  prompt runs its padding through the recurrence, so its state (and
  mamba's conv window) differ from the unpadded prompt's, as in JAX;
- ``forward_train``'s loss and gradients, and one AdamW step;
- the engine: prefix sharing off for both families (no adoption), pool
  counts over attention layers only; on an int8 pool the recurrent
  states stay in the model's dtype;
- ``convert``: caches round trip, the f32 leaves kept under a bf16 cast.
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
from repro.models import mamba as jmamba
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm
from repro.serving.engine import Engine as JEngine
from repro.training import optimizer as jopt
from repro.training.train_step import loss_fn as jloss_fn
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (cache_from_jax, cache_to_numpy,
                                 jax_cache_layers, layer_cache_to_numpy,
                                 params_from_jax)
from repro_torch.core.paged_cache import PagedLayerCache
from repro_torch.core.policies import get_policy
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txlstm
from repro_torch.models.mamba import MambaState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.obs import ObsConfig
from repro_torch.serving import Engine
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import (batch_to_device, train_step,
                                             value_and_grad)
from repro_torch.training.tree import key_of, leaves, leaves_with_path

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
ARCHS = [JAMBA, XLSTM]
B, CHUNK, PAGE, BUDGET = 2, 32, 8, 32
LENS = (70, 45)
INT_FIELDS = ("pos", "block_table", "ref_count", "cur_page", "cur_off")
ATOL = 1e-4
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
    ``jax.eval_shape``), drawn with numpy: matrices normal / sqrt(in),
    embeddings normal * 0.02, norm scales and D 1 + 0.1 normal, biases 0.1
    normal, and the recurrent parameters near their initialisers'
    values."""
    ds = jcfg.mamba_d_state
    D = jcfg.d_model

    def fill(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name in ("scale", "q_norm", "k_norm", "out_norm", "D"):
            return 1 + 0.1 * x
        if name in ("bias", "bq", "bk", "bv", "conv_b"):
            return 0.1 * x
        if name in ("embed", "lm_head"):
            return 0.02 * x
        if name == "conv_w":
            return 0.2 * x
        if name == "A_log":
            return np.log(np.arange(1, ds + 1, dtype=np.float32)) + 0.1 * x
        if name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), s.shape))
            return np.log(np.expm1(dt)).astype(np.float32)
        if name in ("b_igate", "b_fgate"):
            return (-3.0 if name == "b_igate" else 3.0) + 0.1 * x
        if name == "b_gates":
            base = np.concatenate([np.zeros(2 * D), np.full(D, 3.0),
                                   np.zeros(D)]).astype(np.float32)
            return base + 0.1 * x
        return x / np.sqrt(s.shape[-2], dtype=np.float32)
    shapes = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def _model(arch):
    """(jcfg, tcfg, JAX params, numpy tree, port params on the CPU)."""
    jcfg = jget_arch(arch).reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = _numpy_tree(jcfg, np.random.default_rng(len(arch) + 1))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree,
            params_from_jax(tree, tcfg, device="cpu"))


def _layer(arch, mixer):
    """The first ``mixer`` layer's params: (JAX, port)."""
    jcfg, tcfg, _, tree, tparams = _model(arch)
    i = next(i for i, s in enumerate(tcfg.layer_specs()) if s.mixer == mixer)
    p = {k: np.asarray(v[0]) for k, v in tree["pattern"][i][mixer].items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            tparams["layers"][i][mixer])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_state(got, want, what):
    """A port state against a JAX one, field by field (-inf where JAX has
    it)."""
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)),
                                   atol=ATOL, err_msg=f"{what}: {f.name}")


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 40])
def test_mamba_matches_jax(S):
    """S 64: mamba_forward in one window of 64 (recomputed in backward);
    S 40: windows of 1. Then the prefill's state and 3 decode steps."""
    jcfg, tcfg, *_ = _model(JAMBA)
    jp, tp = _layer(JAMBA, "mamba")
    x = _x((B, S, jcfg.d_model), S)
    _close(tmamba.mamba_forward(tp, tcfg, T(x)),
           jmamba.mamba_forward(jp, jcfg, jnp.asarray(x)), "mamba_forward")
    tout, tst = tmamba.mamba_prefill(tp, tcfg, T(x))
    jout, jst = jmamba.mamba_prefill(jp, jcfg, jnp.asarray(x))
    _close(tout, jout, "mamba_prefill")
    _close_state(tst, jst, "mamba_prefill state")
    assert tst.conv.dtype == torch.float32 and tst.ssm.dtype == torch.float32
    for t in range(3):
        xt = _x((B, jcfg.d_model), 100 + t)
        tout, tst = tmamba.mamba_decode_step(tp, tcfg, T(xt), tst)
        jout, jst = jmamba.mamba_decode_step(jp, jcfg, jnp.asarray(xt), jst)
        _close(tout, jout, f"mamba_decode_step {t}")
        _close_state(tst, jst, f"mamba_decode_step {t} state")


@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_matches_jax(chunk):
    """mlstm_chunkwise from the empty state with and without
    return_state, then from the carried state, then 3 decode steps; a
    length that is no multiple of the chunk raises, as JAX asserts."""
    jcfg, tcfg, *_ = _model(XLSTM)
    jp, tp = _layer(XLSTM, "mlstm")
    x = _x((B, 48, jcfg.d_model), chunk)
    x1, x2 = x[:, :32], x[:, 32:]
    want = jxlstm.mlstm_chunkwise(jp, jcfg, jnp.asarray(x1), chunk=chunk)
    _close(txlstm.mlstm_chunkwise(tp, tcfg, T(x1), chunk=chunk), want,
           "mlstm_chunkwise")
    tout, tst = txlstm.mlstm_chunkwise(tp, tcfg, T(x1), chunk=chunk,
                                       return_state=True)
    jout, jst = jxlstm.mlstm_chunkwise(jp, jcfg, jnp.asarray(x1),
                                       chunk=chunk, return_state=True)
    _close(tout, jout, "mlstm_chunkwise, return_state")
    _close_state(tst, jst, "mlstm_chunkwise state")
    tout, tst = txlstm.mlstm_chunkwise(tp, tcfg, T(x2), state=tst,
                                       chunk=chunk, return_state=True)
    jout, jst = jxlstm.mlstm_chunkwise(jp, jcfg, jnp.asarray(x2), state=jst,
                                       chunk=chunk, return_state=True)
    _close(tout, jout, "mlstm_chunkwise from a state")
    _close_state(tst, jst, "mlstm_chunkwise carried state")
    for t in range(3):
        xt = _x((B, jcfg.d_model), 200 + t)
        tout, tst = txlstm.mlstm_decode_step(tp, tcfg, T(xt), tst)
        jout, jst = jxlstm.mlstm_decode_step(jp, jcfg, jnp.asarray(xt), jst)
        _close(tout, jout, f"mlstm_decode_step {t}")
        _close_state(tst, jst, f"mlstm_decode_step {t} state")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        txlstm.mlstm_chunkwise(tp, tcfg, T(x[:, :chunk + 3]), chunk=chunk)
    with pytest.raises(AssertionError):
        jxlstm.mlstm_chunkwise(jp, jcfg, jnp.asarray(x[:, :chunk + 3]),
                               chunk=chunk)


def test_mlstm_decode_steps_match_chunkwise():
    """The recurrent step and the chunkwise form are one recurrence: 12
    decode steps from the empty state (its m at -inf) give the chunkwise
    outputs and state."""
    jcfg, tcfg, *_ = _model(XLSTM)
    _, tp = _layer(XLSTM, "mlstm")
    x = T(_x((B, 12, jcfg.d_model), 5))
    want, wst = txlstm.mlstm_chunkwise(tp, tcfg, x, chunk=4,
                                       return_state=True)
    st = txlstm.mlstm_init_state(tcfg, B, torch.float32, "cpu")
    assert bool(torch.isneginf(st.m).all())
    outs = []
    for t in range(12):
        out, st = txlstm.mlstm_decode_step(tp, tcfg, x[:, t], st)
        outs.append(out)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(),
                               atol=ATOL)
    for f in ("C", "n", "m", "conv"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   getattr(wst, f).numpy(), atol=ATOL,
                                   rtol=1e-5, err_msg=f)


def test_slstm_matches_jax():
    jcfg, tcfg, *_ = _model(XLSTM)
    jp, tp = _layer(XLSTM, "slstm")
    x = _x((B, 20, jcfg.d_model), 3)
    _close(txlstm.slstm_forward(tp, tcfg, T(x)),
           jxlstm.slstm_forward(jp, jcfg, jnp.asarray(x)), "slstm_forward")
    tout, tst = txlstm.slstm_forward(tp, tcfg, T(x[:, :12]),
                                     return_state=True)
    jout, jst = jxlstm.slstm_forward(jp, jcfg, jnp.asarray(x[:, :12]),
                                     return_state=True)
    _close(tout, jout, "slstm_forward, return_state")
    _close_state(tst, jst, "slstm_forward state")
    tout, tst = txlstm.slstm_forward(tp, tcfg, T(x[:, 12:]), state=tst,
                                     return_state=True)
    jout, jst = jxlstm.slstm_forward(jp, jcfg, jnp.asarray(x[:, 12:]),
                                     state=jst, return_state=True)
    _close(tout, jout, "slstm_forward from a state")
    _close_state(tst, jst, "slstm_forward carried state")
    for t in range(3):
        xt = _x((B, jcfg.d_model), 300 + t)
        tout, tst = txlstm.slstm_decode_step(tp, tcfg, T(xt), tst)
        jout, jst = jxlstm.slstm_decode_step(jp, jcfg, jnp.asarray(xt), jst)
        _close(tout, jout, f"slstm_decode_step {t}")
        _close_state(tst, jst, f"slstm_decode_step {t} state")


@pytest.mark.parametrize("arch,mixer", [(JAMBA, "mamba"), (XLSTM, "mlstm"),
                                        (XLSTM, "slstm")])
def test_scan_recurrent_matches_jax(arch, mixer):
    """A chunk of T 6 over 3 rows from a used state: row 0 takes 5 tokens
    (the sixth is not run), row 1 is reset and takes 2 (it then matches a
    run from the empty state), row 2 is idle (its state frozen, its
    outputs zero); then, from that state, 3 tokens on every row (no
    freeze)."""
    jcfg, tcfg, *_ = _model(arch)
    jp, tp = _layer(arch, mixer)
    spec = next(s for s in tcfg.layer_specs() if s.mixer == mixer)
    jstep = {"mamba": jmamba.mamba_decode_step,
             "mlstm": jxlstm.mlstm_decode_step,
             "slstm": jxlstm.slstm_decode_step}[mixer]
    Bs, Tn = 3, 6
    jinit = {"mamba": lambda: jmamba.mamba_init_state(jcfg, Bs, jnp.float32),
             "mlstm": lambda: jxlstm.mlstm_init_state(jcfg, Bs, jnp.float32),
             "slstm": lambda: jxlstm.slstm_init_state(jcfg, Bs)}[mixer]
    # a used state: 4 tokens from the empty one
    jst = jinit()
    for t in range(4):
        _, jst = jstep(jp, jcfg, jnp.asarray(_x((Bs, jcfg.d_model), t)), jst)
    tst = ttf.recurrent_init_state(tcfg, spec, Bs, torch.float32, "cpu")
    ttf._assign(tst, type(tst)(**{f.name: T(np.array(getattr(jst, f.name)))
                                  for f in dataclasses.fields(tst)}))
    before = {f.name: getattr(tst, f.name).clone()
              for f in dataclasses.fields(tst)}
    h = _x((Bs, Tn, jcfg.d_model), 9)
    n_tok, reset = np.array([5, 2, 0], np.int32), np.array([False, True,
                                                            False])
    jout, jnew = jtf._scan_recurrent(
        lambda h_t, st: jstep(jp, jcfg, h_t, st), jst, jinit(),
        jnp.asarray(h), jnp.asarray(n_tok), jnp.asarray(reset))
    tout = ttf._scan_recurrent(
        lambda h_t, st: ttf.RECURRENT_STEP[mixer](tp, tcfg, h_t, st), tst,
        ttf.recurrent_init_state(tcfg, spec, Bs, torch.float32, "cpu"),
        T(h), T(n_tok), T(reset), n_tok)
    _close(tout, jout, f"{mixer} _scan_recurrent outputs")
    _close_state(tst, jnew, f"{mixer} _scan_recurrent state (in place)")
    assert not tout[2].any() and not tout[1, 2:].any() and \
        not tout[0, 5:].any()
    for f, a in before.items():
        assert torch.equal(getattr(tst, f)[2], a[2]), f"idle row {f}"
    fresh = ttf.recurrent_init_state(tcfg, spec, 1, torch.float32, "cpu")
    for t in range(2):
        out, fresh = ttf.RECURRENT_STEP[mixer](tp, tcfg, T(h[1:2, t]), fresh)
        np.testing.assert_allclose(tout[1, t].numpy(), out[0].numpy(),
                                   atol=1e-5)
    for f in dataclasses.fields(fresh):
        np.testing.assert_allclose(getattr(tst, f.name)[1].numpy(),
                                   getattr(fresh, f.name)[0].numpy(),
                                   atol=1e-5, err_msg=f"reset row {f.name}")
    full = np.full(Bs, 3, np.int32)
    jout, jnew = jtf._scan_recurrent(
        lambda h_t, st: jstep(jp, jcfg, h_t, st), jnew, jinit(),
        jnp.asarray(h[:, :3]), jnp.asarray(full), jnp.zeros(Bs, bool))
    tout = ttf._scan_recurrent(
        lambda h_t, st: ttf.RECURRENT_STEP[mixer](tp, tcfg, h_t, st), tst,
        None, T(h[:, :3]), T(full), None, full)
    _close(tout, jout, f"{mixer} _scan_recurrent, every row live")
    _close_state(tst, jnew, f"{mixer} _scan_recurrent, every row live")


# ---------------------------------------------------------------------------
# serving step and one-shot path
# ---------------------------------------------------------------------------

def _cache_cfgs(budget=BUDGET, policy="paged_eviction"):
    ck = dict(page_size=PAGE, cache_budget=budget, policy=policy,
              dtype="float32")
    return (JCacheConfig(**ck), CacheConfig(**ck), jget_policy(policy),
            get_policy(policy))


def _compare(jlogits, jcache, tlogits, tcache, period, ctx, live=None,
             stats=True):
    """Logits and greedy tokens of the ``live`` rows, cur_pos; per layer the
    attention pool's integer state (and devstats) bit for bit and its K/V
    and scores within ATOL, a recurrent state within ATOL."""
    live = np.ones(tlogits.shape[0], bool) if live is None else live
    want = np.asarray(jlogits)[live]
    got = tlogits.numpy()[live]
    np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"{ctx}: logits")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{ctx}: greedy tokens")
    tn = cache_to_numpy(tcache)
    np.testing.assert_array_equal(tn["cur_pos"], np.asarray(jcache.cur_pos))
    jl = jax_cache_layers(jax.device_get(jcache), period)
    assert len(jl) == len(tn["layers"])
    for i, (j, t, c) in enumerate(zip(jl, tn["layers"], tcache.layers)):
        jn = layer_cache_to_numpy(j)
        assert jn.keys() == t.keys(), f"{ctx}: layer {i} kinds"
        if not isinstance(c, PagedLayerCache):
            for f in t:
                np.testing.assert_allclose(t[f], jn[f], atol=ATOL,
                                           err_msg=f"{ctx}: layer {i} {f}")
            continue
        for f in INT_FIELDS + (("stats",) if stats else ()):
            np.testing.assert_array_equal(t[f], jn[f],
                                          err_msg=f"{ctx}: layer {i} {f}")
        for f in ("k", "v", "score"):
            np.testing.assert_allclose(t[f], jn[f], atol=ATOL,
                                       err_msg=f"{ctx}: layer {i} {f}")


def _plan(rng, vocab):
    """Steps of (tokens (B, T), n_tok, decode rows, reset rows): the two
    prompts in chunks of 32 (row 1 finishes first and decodes beside row
    0's chunks), then 2 decode steps, then row 1 handed a new prompt of 20
    tokens (a reset over a used state) while row 0 decodes, then 2 decode
    steps."""
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
    decode = lambda: (rng.integers(0, vocab, (B, CHUNK)).astype(np.int32),
                      [1, 1], [0, 1], [])
    steps += [decode(), decode()]
    tok = rng.integers(0, vocab, (B, CHUNK)).astype(np.int32)
    steps.append((tok, [1, 20], [0], [1]))
    steps += [decode(), decode()]
    return steps


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_step_matches_jax(arch):
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs()
    seq = max(LENS) + 16
    jcache = jtf.init_decode_caches(jcfg, B, seq, jpol, jccfg,
                                    chunk_tokens=CHUNK, track_stats=True)
    tcache = ttf.init_decode_caches(tcfg, B, seq, tpol, tccfg,
                                    chunk_tokens=CHUNK, track_stats=True,
                                    device="cpu")
    rng = np.random.default_rng(11)
    evicted = 0
    for i, (tok, n_tok, dec, reset) in enumerate(_plan(rng, jcfg.vocab_size)):
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
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{arch} step {i}")
        stats = ttf.collect_step_stats(tcache)
        assert (stats is None) == (arch == XLSTM)
        if stats is not None:
            evicted += int(stats[0])
    assert arch == XLSTM or evicted > 0      # jamba's attention layer evicts


@pytest.mark.parametrize("arch", ARCHS)
def test_oneshot_matches_jax(arch):
    """forward_prefill of the two prompts right-padded to 72 tokens, then 4
    decode_steps fed the JAX package's greedy token."""
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs()
    rng = np.random.default_rng(12)
    S, steps = 72, 4
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.array(LENS)[:, None]
    hint = S + steps
    jlogits, jcache = _jprefill(jparams, jcfg, jnp.asarray(tokens),
                                policy=jpol, ccfg=jccfg,
                                valid=jnp.asarray(valid), total_seq_hint=hint)
    tlogits, tcache = ttf.forward_prefill(tparams, tcfg, T(tokens), tpol,
                                          tccfg, valid=T(valid),
                                          total_seq_hint=hint)
    _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
             f"{arch} prefill", stats=False)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jcache = _jdecode(jparams, jcfg, jnp.asarray(tok), jcache,
                                   policy=jpol, ccfg=jccfg)
        tlogits, tcache = ttf.decode_step(tparams, tcfg, T(tok), tcache,
                                          tpol, tccfg)
        _compare(jlogits, jcache, tlogits, tcache, jcfg.pattern_period,
                 f"{arch} decode step {step}", stats=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_fault9_padding_enters_recurrent_state(arch):
    """Fault 9, the reference's own design, reproduced: forward_prefill
    gives a recurrent mixer no mask, so a prompt of 45 tokens right-padded
    to 48 leaves its recurrent states (mamba's conv window too) other than
    the same prompt unpadded, and the next decode step's logits differ,
    in the JAX package and in the port alike (port == JAX on both). On
    xlstm the prefill's own logits (at the last real token) agree, the
    recurrence being causal; jamba's differ already there (its MoE
    layers' capacity dispatch sees the padding too)."""
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs(budget=64)
    n, S = 45, 48
    rng = np.random.default_rng(13)
    padded = np.zeros((1, S), np.int32)
    padded[0, :n] = rng.integers(0, jcfg.vocab_size, n)
    nxt = rng.integers(0, jcfg.vocab_size, 1).astype(np.int32)
    valid = np.arange(S)[None, :] < n
    runs = {}
    for name, tok, val in (("padded", padded, valid),
                           ("unpadded", padded[:, :n], valid[:, :n])):
        jl, jc = _jprefill(jparams, jcfg, jnp.asarray(tok), policy=jpol,
                           ccfg=jccfg, valid=jnp.asarray(val),
                           total_seq_hint=S + 2)
        tl, tc = ttf.forward_prefill(tparams, tcfg, T(tok), tpol, tccfg,
                                     valid=T(val), total_seq_hint=S + 2)
        _compare(jl, jc, tl, tc, jcfg.pattern_period, f"{arch} {name}",
                 stats=False)
        first = tl
        tc_states = [c if isinstance(c, PagedLayerCache) else
                     type(c)(**{f.name: getattr(c, f.name).clone()
                                for f in dataclasses.fields(c)})
                     for c in tc.layers]
        jl, jc = _jdecode(jparams, jcfg, jnp.asarray(nxt), jc, policy=jpol,
                          ccfg=jccfg)
        tl, tc = ttf.decode_step(tparams, tcfg, T(nxt), tc, tpol, tccfg)
        _compare(jl, jc, tl, tc, jcfg.pattern_period,
                 f"{arch} {name} decode", stats=False)
        runs[name] = (first, tc_states, tl, int(tc.cur_pos[0]))
    (fp, cp, lp_, pos_p), (fu, cu, lu, pos_u) = runs["padded"], \
        runs["unpadded"]
    assert pos_p == pos_u == n + 1
    if arch == XLSTM:
        np.testing.assert_allclose(fp.numpy(), fu.numpy(), atol=ATOL)
    for i, (a, b) in enumerate(zip(cp, cu)):
        if isinstance(a, PagedLayerCache):
            continue
        gap = max(float((getattr(a, f.name) - getattr(b, f.name)).abs()
                        .nan_to_num(0.0).max())
                  for f in dataclasses.fields(a))
        assert gap > 1e-3, f"{arch} layer {i}: padding left no trace"
        if isinstance(a, MambaState):
            # the conv window holds the 3 padding tokens' inputs
            assert not torch.equal(a.conv, b.conv)
    assert float((lp_ - lu).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_jax(arch):
    """loss_fn's loss, cross-entropy and aux loss and its gradient leaf by
    leaf (S 64: mamba_forward in one recomputed window, mlstm_chunkwise in
    one chunk), then one train_step against the JAX package's AdamW step
    (parameters within TOL where |g| > 1e-3, within one step of lr
    elsewhere: the first update's sign is not determined where |g| is
    within the gradients' tolerance of 0)."""
    jcfg, tcfg, jparams, tree, _ = _model(arch)
    dcfg = tdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=64,
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
    grads = params_from_jax(jax.device_get(jg), tcfg, device="cpu")
    for (path, a), b in zip(leaves_with_path(tg), leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{arch} grad {key_of(path)}",
                                   **TOL)
    mixer = "mamba" if arch == JAMBA else "mlstm"
    assert all(float(lp[mixer]["up_proj" if arch == XLSTM else "in_proj"]
                     .abs().max()) > 0
               for lp, s in zip(tg["layers"], tcfg.layer_specs())
               if s.mixer == mixer)
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
# engine and convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_no_sharing_and_attention_pools(arch):
    """Prefix sharing asked for and refused (``_sharing_ok``, as the JAX
    engine's): prompts that share 24 tokens are served with no adoption.
    pool_stats count the attention layers only, as the JAX engine's, and
    pool_bytes sum the attention pools alone; without an attention layer
    the lineage ledger is refused."""
    jcfg, tcfg, jparams, _, tparams = _model(arch)
    jccfg, tccfg, *_ = _cache_cfgs()
    kw = dict(max_batch=2, max_prompt_len=48, max_new_tokens=4,
              chunk_size=16, prefix_sharing=True)
    eng = Engine(tcfg, tparams, cache_cfg=tccfg, device="cpu", **kw)
    jeng = JEngine(jcfg, jparams, cache_cfg=jccfg, **kw)
    assert not eng._sharing_ok and not jeng._sharing_ok
    rng = np.random.default_rng(14)
    shared = rng.integers(0, jcfg.vocab_size, 24)
    for _ in range(3):
        eng.submit(np.concatenate([shared, rng.integers(
            0, jcfg.vocab_size, 16)]).astype(np.int32))
    done = eng.run()
    assert len(done) == 3 and all(len(r.output_tokens) == 4 for r in done)
    assert eng.stats.shared_prefix_hits == 0
    assert eng.stats.shared_prefix_tokens == 0
    pools = ttf.paged_layers(eng.cache.layers)
    assert len(pools) == jcfg.num_attn_layers()
    fresh = Engine(tcfg, tparams, cache_cfg=tccfg, device="cpu", **kw)
    assert fresh.pool_stats() == jeng.pool_stats()
    assert fresh._pool_pages_total == jeng._pool_pages_total
    assert fresh._free_pages_est == jeng._free_pages_est
    payload = sum(t.numel() * t.element_size() for c in pools
                  for t in (c.k_buf, c.v_buf))
    assert eng.pool_bytes()["payload_total"] == payload
    if not pools:
        assert eng.pool_stats()["pool_pages"] == 0
        with pytest.raises(ValueError, match="lineage ledger"):
            Engine(tcfg, tparams, cache_cfg=tccfg, device="cpu",
                   obs=ObsConfig(lineage=True), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_int8_pool_keeps_recurrent_states_float(arch):
    """An int8 pool quantizes the attention layers' K/V only: every
    recurrent state keeps the model's dtype (an int8 conv window would
    truncate the activations to integers at every step). xlstm, which has
    no attention layer, serves the same tokens and states on an int8 pool
    as on an f32 one; jamba's conv windows hold non-integer values."""
    _, tcfg, _, _, tparams = _model(arch)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (40, 23)]
    runs = []
    for dt in ("int8", "float32"):
        eng = Engine(tcfg, tparams, cache_cfg=CacheConfig(
            page_size=PAGE, cache_budget=BUDGET, dtype=dt), device="cpu",
            max_batch=2, max_prompt_len=48, max_new_tokens=4, chunk_size=16)
        for p in prompts:
            eng.submit(p)
        done = eng.run()
        states = [c for c in eng.cache.layers
                  if not isinstance(c, PagedLayerCache)]
        for st in states:
            for f in dataclasses.fields(st):
                t = getattr(st, f.name)
                assert t.dtype == torch.float32, (dt, f.name, t.dtype)
        convs = [st.conv for st in states if hasattr(st, "conv")]
        assert convs and all(bool((c != c.round()).any()) for c in convs)
        runs.append(({r.request_id: r.output_tokens for r in done}, states))
    if arch == XLSTM:
        (tok8, st8), (tok32, st32) = runs
        assert tok8 == tok32
        for a, b in zip(st8, st32):
            for f in dataclasses.fields(a):
                torch.testing.assert_close(getattr(a, f.name),
                                           getattr(b, f.name),
                                           atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_caches_and_f32_leaves(arch):
    """A JAX cache of every layer kind crosses to the port and back
    (xLSTM's m at -inf kept); under a bf16 cast, params_from_jax keeps f32
    exactly the leaves the JAX package's bf16 tree holds in f32."""
    jcfg, tcfg, jparams, tree, tparams = _model(arch)
    jccfg, tccfg, jpol, tpol = _cache_cfgs()
    tokens = np.random.default_rng(15).integers(
        0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    _, jc = _jprefill(jparams, jcfg, jnp.asarray(tokens), policy=jpol,
                      ccfg=jccfg, total_seq_hint=32)
    jc = jax.device_get(jc)
    tc = cache_from_jax(jc, tcfg, device="cpu")
    kinds = [type(c) for c in tc.layers]
    want = [PagedLayerCache if s.mixer == "attn" else
            {"mamba": MambaState, "mlstm": MLSTMState,
             "slstm": SLSTMState}[s.mixer] for s in tcfg.layer_specs()]
    assert kinds == want
    for t, j in zip(cache_to_numpy(tc)["layers"],
                    jax_cache_layers(jc, jcfg.pattern_period)):
        jn = layer_cache_to_numpy(j)
        assert t.keys() == jn.keys()
        for f, a in t.items():
            if a is not None:
                np.testing.assert_array_equal(a, jn[f], err_msg=f)
    empty = cache_from_jax(jax.device_get(jtf.init_decode_caches(
        jcfg, B, 32, jpol, jccfg)), tcfg, device="cpu")
    for c in empty.layers:
        if isinstance(c, (MLSTMState, SLSTMState)):
            assert bool(torch.isneginf(c.m).all())
    # the f32 leaves of a bf16 model
    bcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    shapes = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   bcfg))
    jf32 = {jax.tree_util.keystr(p).split("'")[-2]
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)
            if s.dtype == jnp.float32}
    got = params_from_jax(tree, ModelConfig(**dataclasses.asdict(bcfg)),
                          device="cpu", dtype=torch.bfloat16)
    tf32 = {key_of(p).split("/")[-1] for p, t in leaves_with_path(got)
            if t.dtype == torch.float32}
    assert tf32 == jf32
    kept = ({"A_log", "D", "dt_bias"} if arch == JAMBA else
            {"w_igate", "b_igate", "w_fgate", "b_fgate", "b_gates", "r_z",
             "r_i", "r_f", "r_o"})
    assert kept <= tf32
