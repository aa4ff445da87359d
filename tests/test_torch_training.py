"""The port's training path against the JAX package's, on the CPU.

Same inputs, made from one numpy seed (weights: the JAX init tree handed
over as numpy), through both:
- synthetic data (``lm_batch``, ``recall_batch``): bit-equal;
- ``lr_schedule`` within 1e-7 relative; ``global_norm`` and three chained
  ``adamw_update``s (a reduced llama tree, f32 and bf16 leaves) within 1e-6
  relative, bf16 parameters equal or one bf16 step apart; the same set of
  decayed leaves;
- ``cross_entropy``, 3-D and 4-D logits, within 1e-6;
- ``blocked_causal_attention`` at small chunks (window 0 and > 0, a row
  with no visible key): output and its gradient within 1e-5; the dispatch
  takes JAX's branch on both sides of the threshold;
- ``forward_train`` logits and every leaf's gradient of ``loss_fn`` on
  reduced llama-3.2-1b and qwen2.5-3b (non-zero qkv biases), remat on and
  off, within atol 1e-5 + rtol 1e-4;
- 5 ``train_step``s from one JAX init: loss, lr and grad norm within 1e-4
  relative; a JAX-written {"params", "opt"} checkpoint read by
  ``checkpoint_from_jax`` continues with the JAX run's next 2 steps;
- checkpoints: the port's round trip bit-equal (bf16 and f32), atomic, and
  readable by the JAX package's loader (f32 leaves); a JAX checkpoint of
  bf16 leaves loads bit for bit; the train CLI writes its checkpoint.

Fault 8: every CUDA kernel wrapper refuses an input that requires grad under
autograd (the guard runs before the device checks, so the CPU reaches it),
and the serving and one-shot entry points given parameters that require
grad record no graph.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.training import checkpoint as jckpt
from repro.training import cross_entropy as jcross_entropy
from repro.training import data as jdata
from repro.training import make_train_step as jmake_train_step
from repro.training import optimizer as jopt
from repro_torch.configs import CacheConfig, ModelConfig
from repro_torch.convert import (adamw_state_from_jax, checkpoint_from_jax,
                                 params_from_jax)
from repro_torch.core.policies import get_policy
from repro_torch.kernels import block_score, flash_prefill, paged_attention
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving import Engine
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import (batch_to_device, cross_entropy,
                                             make_train_step, value_and_grad)
from repro_torch.training.tree import key_of, leaves, leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-4)


def _configs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _jax_tree(jcfg, rng, seed=1):
    """The JAX init tree as numpy, qkv biases made non-zero."""
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(seed), jcfg))
    for slot in tree["pattern"]:
        for b in ("bq", "bk", "bv"):
            if b in slot["attn"]:
                slot["attn"][b] = (rng.standard_normal(
                    slot["attn"][b].shape) * 0.1).astype(slot["attn"][b].dtype)
    return tree


def _port(tree, tcfg, grad=False):
    params = params_from_jax(tree, tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(grad)
    return params


def _np(t):
    return t.detach().float().numpy()


def _assert_trees_close(port, jtree, tcfg, what, **tol):
    want = params_from_jax(jax.device_get(jtree), tcfg, device="cpu")
    for (path, a), b in zip(leaves_with_path(port), leaves(want)):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"{what} "
                                   f"{key_of(path)}", **tol)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab_size=512, seq_len=64,
                                     batch_size=3, seed=7),
                                dict(vocab_size=64, seq_len=32,
                                     batch_size=4, seed=0, num_pairs=2,
                                     key_space=8)])
def test_batches_bit_equal(kw):
    jc, tc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    for step in (0, 1, 17, 10_000):
        for host in (0, 1):
            pairs = [(jdata.lm_batch(jc, step, host),
                      tdata.lm_batch(tc, step, host)),
                     (jdata.lm_batch(jc, step, host, num_codebooks=2),
                      tdata.lm_batch(tc, step, host, num_codebooks=2)),
                     (jdata.recall_batch(jc, step, host),
                      tdata.recall_batch(tc, step, host))]
            for j, t in pairs:
                assert j.keys() == t.keys()
                for k in j:
                    assert j[k].dtype == t[k].dtype
                    np.testing.assert_array_equal(j[k], t[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    """Within 1e-7 relative, plus lr_peak * 2**-24 absolute: one f32
    rounding step of the cosine (|cos| <= 1), which XLA and torch compute
    by different polynomials, neither correctly rounded (they differ in
    the last bit for about 1 argument in 20); near the end of the decay
    1 + cos is small and that one step is up to 3e-7 of the rate. The
    warmup ramp is bit-equal."""
    for kw in (dict(lr_peak=3e-3, warmup_steps=50, total_steps=900),
               dict(lr_peak=1.0, warmup_steps=0, total_steps=37,
                    lr_min_ratio=0.25)):
        jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        steps = np.arange(0, kw["total_steps"] + 5)
        want = np.array([float(jopt.lr_schedule(jc, jnp.asarray(s)))
                         for s in steps], np.float32)
        got = np.array([float(topt.lr_schedule(tc, int(s))) for s in steps],
                       np.float32)
        warm = steps <= kw["warmup_steps"]
        np.testing.assert_array_equal(got[warm], want[warm])
        np.testing.assert_allclose(got, want, rtol=1e-7,
                                   atol=kw["lr_peak"] * 2 ** -24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_updates_match_jax(dtype):
    """Three chained updates on a reduced qwen2.5-3b tree (llama's leaves
    plus qkv biases), the gradient clipped (global norm ~56 > 1).

    - lr within 1e-6 relative.
    - The global norm within 1e-6 relative beyond the reference's own
      error: the JAX package sums the squares in f32 on the CPU, 1.7e-6 of
      the exact (f64) norm for the bf16 gradient here; the port's sum is
      within 1e-7 of it. The clip factor inherits that difference.
    - The moments within 1e-6 relative beyond twice the clip factors'
      relative difference. The first moment and a new parameter are sums
      of terms of either sign and like size (beta1 * mu and
      (1 - beta1) * g; p and -lr * update): where they cancel, the
      elementwise relative error is unbounded, so they are held within
      that tolerance of their value or of the leaf's largest magnitude.
    - bf16 parameters: each update starts from the same bf16 parameters
      (JAX's previous ones; a one-step difference would otherwise carry
      on) and lands equal or one bf16 step apart, plus the f32 tolerance
      of the old value where the result cancels to a small one."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = _configs("qwen2.5-3b", dtype)
    tree = _jax_tree(jcfg, rng)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                          .astype(a.dtype), tree) for _ in range(3)]
    ocfg = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10,
                weight_decay=0.1, grad_clip=1.0)
    jc, tc = jopt.AdamWConfig(**ocfg), topt.AdamWConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_adamw(jp)
    tp = _port(tree, tcfg)
    ts = topt.init_adamw(tp)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jc))
    for i, g in enumerate(grads):
        tg = params_from_jax(g, tcfg, device="cpu")
        exact = np.sqrt(sum((np.asarray(x, np.float64) ** 2).sum()
                            for x in jax.tree.leaves(g)))
        if dtype == "bfloat16":
            tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
        prev = leaves(tp)
        jp, js, jm = upd(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = topt.adamw_update(tp, tg, ts, tc)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for got, want in ((topt.global_norm(tg), jopt.global_norm(
                jax.tree.map(jnp.asarray, g))), (tm["grad_norm"],
                                                 jm["grad_norm"])):
            got, want = float(got), float(want)
            assert abs(got - exact) <= 1e-7 * exact
            assert abs(got - want) <= 1e-6 * want + abs(want - exact)
        clip_err = abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1)
        rtol = 1e-6 + 2 * clip_err
        assert ts.step == int(js.step) == i + 1
        for name, t, j in (("mu", ts.mu, js.mu), ("nu", ts.nu, js.nu),
                           ("params", tp, jp)):
            want = params_from_jax(jax.device_get(j), tcfg, device="cpu")
            for k, ((path, a), b) in enumerate(zip(leaves_with_path(t),
                                                   leaves(want))):
                what = f"step {i} {name} {key_of(path)}"
                assert a.dtype == b.dtype, what
                if a.dtype == torch.bfloat16:
                    a, b, p0 = _np(a), _np(b), _np(prev[k])
                    step = 2.0 ** (np.floor(np.log2(np.maximum(
                        np.maximum(abs(a), abs(b)), 2 ** -126))) - 7)
                    assert (abs(a - b) <= step + rtol * abs(p0)).all(), what
                    continue
                np.testing.assert_allclose(
                    _np(a), _np(b), rtol=rtol,
                    atol=rtol * float(b.abs().max()), err_msg=what)


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen2.5-3b", "tiny"])
def test_decay_mask_picks_jax_leaves(arch):
    if arch == "tiny":
        jcfg = dataclasses.replace(jget_arch("llama-3.2-1b").reduced(),
                                   tie_embeddings=False)
    else:
        jcfg = jget_arch(arch).reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(0), jcfg))
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        want[path[-1].key] = jopt._decay_mask(path)
    port = _port(tree, tcfg)
    got = {path[-1]: topt.decay_mask(path)
           for path, _ in leaves_with_path(port)}
    assert got == want
    assert not got["scale"] and got["wq"] and got["embed"]
    if "bq" in got:
        assert not (got["bq"] or got["bk"] or got["bv"])


# ---------------------------------------------------------------------------
# loss and attention
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    B, S, K, V = 2, 7, 3, 11
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    cases = [(rng.standard_normal((B, S, V)).astype(np.float32) * 3,
              rng.integers(0, V, (B, S)).astype(np.int32)),
             (rng.standard_normal((B, S, K, V)).astype(np.float32) * 3,
              rng.integers(0, V, (B, K, S)).astype(np.int32))]
    for logits, targets in cases:
        want = float(jcross_entropy(jnp.asarray(logits),
                                       jnp.asarray(targets),
                                       jnp.asarray(mask)))
        got = float(cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets),
                                      torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("window,shift", [(0, 0), (5, 0), (0, 6)])
def test_blocked_attention_and_grad_match_jax(window, shift):
    """q chunk 4, kv chunk 8 over 16 queries and keys (GQA, G 2). With
    ``shift`` the keys sit ahead of the queries, so the first queries see
    no key at all and give zeros; their m stays -inf through every
    block."""
    rng = np.random.default_rng(1)
    B, S, H, KV, hd = 2, 16, 4, 2, 8
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    qp = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kp = qp + shift
    kw = dict(window=window, q_chunk=4, kv_chunk=8)

    def jloss(q, k, v):
        o = jcommon.blocked_causal_attention(
            q, k, v, q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
            **kw)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = tcommon.blocked_causal_attention(
        tq, tk, tv, q_positions=torch.from_numpy(qp),
        kv_positions=torch.from_numpy(kp), **kw)
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=0)
    if shift:
        assert float(to.detach()[:, :shift].abs().max()) == 0.0
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), atol=1e-5,
                                   rtol=0, err_msg=f"d{name}")
    # the full-matrix route computes the same function
    full = tcommon.full_causal_attention(
        tq.detach(), tk.detach(), tv.detach(),
        q_positions=torch.from_numpy(qp), kv_positions=torch.from_numpy(kp),
        window=window)
    np.testing.assert_allclose(_np(full), _np(to), atol=1e-5, rtol=0)


@pytest.mark.parametrize("Sq,Sk,threshold", [
    (1024, 1024, 8192),     # 1024^2 <= 8192^2 / 16: full
    (2048, 2048, 8192),     # exactly at the threshold: full
    (3072, 3072, 8192),     # above it: blocked, chunks of 1024
    (1024, 1024, 2048),     # a lower threshold: blocked, one block
    (512, 8192, 1024),      # Sq < 1024: full, whatever Sk
])
def test_causal_attention_dispatch_matches_jax(Sq, Sk, threshold,
                                               monkeypatch):
    seen = {}

    def spy(mod, side):
        def full(q, k, v, **kw):
            seen[side] = ("full",)
            return q

        def blocked(q, k, v, *, q_chunk, kv_chunk, **kw):
            seen[side] = ("blocked", q_chunk, kv_chunk)
            return q
        monkeypatch.setattr(mod, "full_causal_attention", full)
        monkeypatch.setattr(mod, "blocked_causal_attention", blocked)

    spy(jcommon, "jax")
    spy(tcommon, "port")
    pos = dict(q_positions=None, kv_positions=None)
    jcommon.causal_attention(jnp.zeros((1, Sq, 1, 1)),
                             jnp.zeros((1, Sk, 1, 1)), None,
                             blocked_threshold=threshold, **pos)
    tcommon.causal_attention(torch.zeros((1, Sq, 1, 1)),
                             torch.zeros((1, Sk, 1, 1)), None,
                             blocked_threshold=threshold, **pos)
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen2.5-3b"])
def test_forward_train_and_grads_match_jax(arch, remat):
    rng = np.random.default_rng(2)
    jcfg, tcfg = _configs(arch)
    tree = _jax_tree(jcfg, rng)
    dcfg = tdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=48,
                            batch_size=2, seed=3)
    batch = tdata.lm_batch(dcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits, aux = jtf.forward_train(p, jcfg, jb["tokens"], remat=remat)
        ce = jcross_entropy(logits, jb["targets"], jb["mask"])
        return ce + 0.01 * aux, logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    tp = _port(tree, tcfg, grad=True)
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        tlogits, aux = ttf.forward_train(tp, tcfg, tb["tokens"], remat=remat)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    (tl, parts), tg = value_and_grad(tp, tcfg, tb, remat=remat)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(parts["ce"]), float(jl), rtol=1e-6)
    _assert_trees_close(tg, jg, tcfg, f"{arch} grad", **TOL)
    for lp in tg["layers"]:
        for name in ("wq", "wk", "wv"):
            assert float(lp["attn"][name].abs().max()) > 0


def test_forward_train_refuses_what_is_not_ported():
    """Nothing is refused any more. ``ac`` (the activation constraint,
    ported: tests/test_torch_grid.py holds it over a grid) without a grid
    pins nothing, as the JAX package's ``Identity``; ``cond``
    (cross-attention, held to JAX in tests/test_torch_multimodal.py): a
    model without cross-attention layers takes it and ignores it, as the
    JAX package's ``forward_train`` does."""
    _, tcfg = _configs("llama-3.2-1b")
    tp = _port(jax.device_get(jtf.init_model(jax.random.PRNGKey(0),
                                             _configs("llama-3.2-1b")[0])),
               tcfg)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        want, _ = ttf.forward_train(tp, tcfg, tokens)
        got, _ = ttf.forward_train(tp, tcfg, tokens,
                                   cond=torch.zeros((1, 2, tcfg.d_model)))
        pinned, _ = ttf.forward_train(tp, tcfg, tokens, ac=lambda x: x)
    assert torch.equal(got, want) and torch.equal(pinned, want)


# ---------------------------------------------------------------------------
# train steps and checkpoints
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=5)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """5 JAX train steps on reduced llama-3.2-1b from one init, with a
    {"params", "opt"} checkpoint after step 3."""
    jcfg, tcfg = _configs("llama-3.2-1b")
    tree = jax.device_get(jtf.init_model(jax.random.PRNGKey(4), jcfg))
    dcfg = tdata.DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                            batch_size=4, seed=5)
    step = jax.jit(jmake_train_step(jcfg, jopt.AdamWConfig(**OPT)))
    params = jax.tree.map(jnp.asarray, tree)
    opt = jopt.init_adamw(params)
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    series = []
    for i in range(5):
        b = {k: jnp.asarray(v) for k, v in tdata.lm_batch(dcfg, i).items()}
        params, opt, m = step(params, opt, b)
        series.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
        if i == 2:
            jckpt.save_checkpoint(ckpt, 3, {"params": params, "opt": opt})
    return dict(tcfg=tcfg, tree=tree, dcfg=dcfg, ckpt=ckpt,
                series=np.array(series))


def _port_steps(params, opt, tcfg, dcfg, steps):
    step = make_train_step(tcfg, topt.AdamWConfig(**OPT))
    out = []
    for i in steps:
        params, opt, m = step(params, opt, batch_to_device(
            tdata.lm_batch(dcfg, i), "cpu"))
        out.append([float(m[k]) for k in ("loss", "lr", "grad_norm")])
        assert set(m) == {"loss", "ce", "aux", "lr", "grad_norm"}
    return params, opt, np.array(out)


def test_train_steps_match_jax(jax_run):
    r = jax_run
    params = _port(r["tree"], r["tcfg"], grad=True)
    params, opt, series = _port_steps(params, topt.init_adamw(params),
                                      r["tcfg"], r["dcfg"], range(5))
    np.testing.assert_allclose(series, r["series"], rtol=1e-4, atol=0)
    assert series[-1, 0] < series[0, 0]
    assert opt.step == 5 and all(p.requires_grad for p in leaves(params))


def test_jax_checkpoint_resumes_in_port(jax_run):
    r = jax_run
    st = checkpoint_from_jax(r["ckpt"], 3, r["tcfg"], device="cpu")
    assert st["opt"].step == 3
    assert len(st["params"]["layers"]) == r["tcfg"].num_layers
    for p in leaves(st["params"]):
        p.requires_grad_(True)
    _, _, series = _port_steps(st["params"], st["opt"], r["tcfg"],
                               r["dcfg"], (3, 4))
    np.testing.assert_allclose(series, r["series"][3:], rtol=1e-4, atol=0)


def test_jax_bf16_checkpoint_loads_bit_equal(tmp_path):
    jcfg, tcfg = _configs("qwen2.5-3b", "bfloat16")
    jp = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    jo = jopt.init_adamw(jp)
    jo = jo._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda a: a + 0.5, jo.mu))
    jckpt.save_checkpoint(str(tmp_path), 7, {"params": jp, "opt": jo})
    st = checkpoint_from_jax(str(tmp_path), 7, tcfg, device="cpu")
    want = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    for (path, a), b in zip(leaves_with_path(st["params"]), leaves(want)):
        assert a.dtype == torch.bfloat16, key_of(path)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    ref = adamw_state_from_jax(jax.device_get(jo), tcfg, device="cpu")
    assert st["opt"].step == ref.step == 7
    for a, b in zip(leaves(st["opt"]), leaves(ref)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_round_trip(dtype, tmp_path):
    rng = np.random.default_rng(6)
    jcfg, tcfg = _configs("qwen2.5-3b", dtype)
    params = _port(_jax_tree(jcfg, rng), tcfg, grad=True)
    opt = topt.init_adamw(params)
    opt = opt._replace(step=11)
    tree = {"params": params, "opt": opt}
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    for step in (3, 12):
        npz = tckpt.save_checkpoint(d, step, tree)
    assert npz == os.path.join(d, "step_00000012", "state.npz")
    assert tckpt.latest_step(d) == 12
    assert sorted(os.listdir(os.path.dirname(npz))) == [
        "state.keys.json", "state.npz"]
    with open(os.path.join(d, "step_00000012", "state.keys.json")) as f:
        keys = json.load(f)
    assert "opt/.step" in keys and "params/layers/1/attn/bq" in keys
    got = tckpt.load_checkpoint(d, 12, tree)
    assert got["opt"].step == 11
    bits = lambda t: t.detach().view(torch.int16) \
        if t.dtype == torch.bfloat16 else t.detach()  # noqa: E731
    for (path, a), b in zip(leaves_with_path(got), leaves(tree)):
        if isinstance(b, int):
            assert a == b
            continue
        assert a.dtype == b.dtype and a.requires_grad == b.requires_grad
        assert torch.equal(bits(a), bits(b)), key_of(path)
    with np.load(npz) as data:          # numpy alone reads every leaf
        assert {data[k].dtype.str for k in data.files} <= {"<f4", "<i4",
                                                            "|V2"}
    if dtype == "float32":
        # the JAX package's loader takes the port's file into a numpy
        # template of the same structure
        jlike = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                             if isinstance(t, torch.Tensor) else
                             np.zeros((), np.int32),
                             {"params": params, "opt": tuple(opt)},
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
        jlike["opt"] = jopt.AdamWState(*jlike["opt"])
        got = jckpt.load_checkpoint(d, 12, jlike)
        np.testing.assert_array_equal(
            got["params"]["layers"][0]["attn"]["wq"],
            _np(params["layers"][0]["attn"]["wq"]))
        assert int(got["opt"].step) == 11


def test_train_cli_writes_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama-3.2-1b", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "3"], capture_output=True, text=True, env=env,
        timeout=120, check=True).stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and all("loss=" in ln and "gnorm=" in ln
                                   for ln in lines)
    assert tckpt.latest_step(str(tmp_path)) == 3
    assert os.path.exists(tmp_path / "step_00000003" / "state.npz")


# ---------------------------------------------------------------------------
# fault 8: no kernel under autograd, no graph while serving
# ---------------------------------------------------------------------------

def _f(*shape):
    return torch.zeros(shape)


def _i(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


# kernel -> (shape of the float input that may require grad, the call);
# the pool is (N 4, page 8, KV 2, hd 64), the tables (B 2, P 2)
WRAPPER_CALLS = {
    "paged_attention": ((2, 2, 2, 64), lambda t:
                        paged_attention.paged_attention_cuda(
                            t, _f(4, 8, 2, 64), _f(4, 8, 2, 64), _i(4, 8),
                            _i(2, 2), _i(2))),
    "paged_attention_int8": ((2, 2, 2, 64), lambda t:
                             paged_attention.paged_attention_int8_cuda(
                                 t, _i(4, 8, 2, 64, dtype=torch.int8),
                                 _i(4, 8, 2, 64, dtype=torch.int8),
                                 _f(4, 8, 2), _f(4, 8, 2), _i(4, 8),
                                 _i(2, 2), _i(2))),
    "paged_prefill": ((2, 1, 4, 64), lambda t:
                      flash_prefill.paged_prefill_cuda(
                          t, _f(4, 8, 2, 64), _f(4, 8, 2, 64), _i(4, 8),
                          _i(2, 2), _i(2, 1))),
    "flash_attention": ((2, 1, 4, 64), lambda t:
                        flash_prefill.flash_attention_cuda(
                            t, _f(2, 1, 2, 64), _f(2, 1, 2, 64))),
    "block_score": ((4, 8, 2, 64), lambda t: block_score.block_score_cuda(
        t, _f(4, 8, 2, 64), _i(4, 8))),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPER_CALLS))
def test_kernel_wrappers_refuse_autograd(kernel):
    shape, call = WRAPPER_CALLS[kernel]
    t = torch.zeros(shape, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{kernel}: .*no backward pass.*"
                       f"plain attention"):
        call(t)
    # without autograd the guard lets the call through to the device checks
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        call(t)


def _requires_grad_anywhere(obj) -> list:
    found = []
    for name, val in vars(obj).items():
        if isinstance(val, torch.Tensor) and val.requires_grad:
            found.append(name)
    return found


def test_serving_from_params_that_require_grad_records_no_graph():
    jcfg, tcfg = _configs("llama-3.2-1b")
    params = _port(jax.device_get(jtf.init_model(jax.random.PRNGKey(0),
                                                 jcfg)), tcfg, grad=True)
    rng = np.random.default_rng(7)
    ccfg = CacheConfig(page_size=8, cache_budget=16, policy="paged_eviction",
                       dtype="float32")
    pol = get_policy("paged_eviction")
    # the unified step
    cache = ttf.init_decode_caches(tcfg, 2, 64, pol, ccfg, chunk_tokens=16,
                                   device="cpu")
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16))
                              .astype(np.int32))
    logits, cache = ttf.forward_step(params, tcfg, tokens,
                                     torch.tensor([16, 9], dtype=torch.int32),
                                     cache, pol, ccfg)
    assert not logits.requires_grad
    for c in cache.layers:
        assert not _requires_grad_anywhere(c)
    # the one-shot path
    logits, cache = ttf.forward_prefill(params, tcfg, tokens, pol, ccfg,
                                        total_seq_hint=24)
    for _ in range(2):
        assert not logits.requires_grad
        logits, cache = ttf.decode_step(params, tcfg,
                                        logits.argmax(-1).to(torch.int32),
                                        cache, pol, ccfg)
    assert not logits.requires_grad
    for c in cache.layers:
        assert not _requires_grad_anywhere(c)
    # the engine, with regret probes (their taps are read to numpy)
    from repro_torch.obs import ObsConfig
    eng = Engine(tcfg, params, cache_cfg=ccfg, max_batch=2,
                 max_prompt_len=32, max_new_tokens=6, chunk_size=16,
                 device="cpu", obs=ObsConfig(regret_every=2))
    for n in (30, 12):
        eng.submit(rng.integers(0, tcfg.vocab_size, n).astype(np.int32))
    done = eng.run()
    assert [len(r.output_tokens) for r in done] == [6, 6]
    assert any(r.regret_samples for r in done)
    for c in eng.cache.layers:
        assert not _requires_grad_anywhere(c)
    assert all(p.requires_grad for p in leaves(params))
