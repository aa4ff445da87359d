"""The port's paged attention kernels against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them).

On the CPU the port runs each kernel's plain torch version; the same
churned pools (freed and reallocated pages, unmapped slots, shared prefix
pages, padding rows) go to both packages, and the outputs, the raw norm
tiles and the page scores reduced from them must agree within 1e-4. The
same holds for the flash attention kernel (contiguous causal GQA, with and
without a window; f32 within 2e-5, bf16 within one bf16 rounding step),
the page-score kernel (finite scores within 1e-5 relative, +inf on the
same pages) and the per-Q-head prefill kernel.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_cache as jpc
from repro.core.importance import page_scores_from_norms as j_scores
from repro.kernels import ops as jops
from repro.kernels.block_score import block_score_kernel
from repro.kernels.flash_prefill import (flash_attention_kernel,
                                         paged_flash_prefill_kernel,
                                         paged_flash_prefill_kernel_per_qhead)
from repro.kernels.paged_attention import paged_attention_kernel
from repro_torch.convert import layer_cache_from_jax
from repro_torch.core.importance import page_scores_from_norms
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_score import block_score_cuda, block_score_plain
from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                               flash_attention_plain,
                                               paged_prefill_cuda,
                                               paged_prefill_plain)
from repro_torch.kernels.paged_attention import (combine_splits,
                                                 paged_attention_cuda,
                                                 paged_attention_plain)

ATOL = 1e-4
B, P, page = 3, 7, 8


def _pool(KV, hd, seed):
    return ref.churned_pool(B, P, page, KV, hd, torch.float32, seed,
                            device="cpu")


def _jax_pool(t):
    """(N, page, KV, hd) torch -> the Pallas kernels' (KV, N, page, hd)."""
    return jnp.asarray(np.moveaxis(t.numpy(), 2, 0))


def _views(pos, bt):
    mapped = bt >= 0
    pv = torch.where(mapped[..., None], pos[bt.clamp_min(0).long()], -1)
    return pv, mapped


def _check_scores(norms, jnorms, pos, bt):
    kn, vn = norms
    for got, want in zip(norms, jnorms):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    pv, mapped = _views(pos, bt)
    got = page_scores_from_norms(kn, vn, pv, mapped).numpy()
    want = np.asarray(j_scores(jnorms[0], jnorms[1], jnp.asarray(pv.numpy()),
                               jnp.asarray(mapped.numpy())))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("KV,G,window", [(2, 2, 0), (1, 3, 0), (2, 2, 20)])
def test_decode_plain_matches_pallas(KV, G, window, splits):
    hd = 16
    k, v, pos, bt, cur = _pool(KV, hd, seed=KV * 10 + G + window)
    q = torch.randn((B, KV, G, hd), generator=torch.Generator()
                    .manual_seed(splits))
    acc, m, l, norms = paged_attention_plain(
        q, k, v, pos, bt, cur, window=window, num_splits=splits,
        return_scores=True)
    out = combine_splits(acc, m, l)
    jout, jnorms = paged_attention_kernel(
        jnp.asarray(q.numpy()), _jax_pool(k), _jax_pool(v),
        jnp.asarray(pos.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(cur.numpy()), window=window, num_splits=splits,
        return_scores=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    _check_scores(norms, jnorms, pos, bt)
    oracle = ref.paged_attention_block_table_ref(q, k, v, pos, bt, cur,
                                                 window=window)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("KV,G,window", [(2, 2, 0), (1, 3, 0), (2, 2, 20)])
def test_prefill_plain_matches_pallas(KV, G, window):
    hd, T = 16, 12
    k, v, pos, bt, cur = _pool(KV, hd, seed=KV * 10 + G + window)
    qp = ref.prefill_positions(cur, T)                 # incl. padding rows
    q = torch.randn((B, T, KV * G, hd), generator=torch.Generator()
                    .manual_seed(G))
    out, norms = paged_prefill_plain(q, k, v, pos, bt, qp, window=window,
                                     return_scores=True)
    jout, jnorms = paged_flash_prefill_kernel(
        jnp.asarray(q.numpy()), _jax_pool(k), _jax_pool(v),
        jnp.asarray(pos.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(qp.numpy()), window=window, return_scores=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    assert not out[B - 1].any(), "padding rows must output zeros"
    _check_scores(norms, jnorms, pos, bt)
    oracle = ref.paged_prefill_attention_block_table_ref(
        q, k, v, pos, bt, qp, window=window)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=ATOL)


@pytest.mark.parametrize("KV,G,window", [(2, 2, 0), (1, 3, 20)])
def test_prefill_per_qhead_plain_matches_pallas(KV, G, window):
    hd, T = 16, 12
    k, v, pos, bt, cur = _pool(KV, hd, seed=KV * 7 + G + window)
    qp = ref.prefill_positions(cur, T)
    q = torch.randn((B, T, KV * G, hd), generator=torch.Generator()
                    .manual_seed(G + 1))
    out, _ = paged_prefill_plain(q, k, v, pos, bt, qp, window=window,
                                 per_qhead=True)
    jout = paged_flash_prefill_kernel_per_qhead(
        jnp.asarray(q.numpy()), _jax_pool(k), _jax_pool(v),
        jnp.asarray(pos.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(qp.numpy()), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    with pytest.raises(ValueError, match="epilogue"):
        paged_prefill_plain(q, k, v, pos, bt, qp, per_qhead=True,
                            return_scores=True)


# the subset of tests/test_kernels.py's flash sweep, plus a window
@pytest.mark.parametrize("S,H,KV,hd,window,dtype", [
    (128, 2, 1, 64, 0, "float32"),
    (256, 4, 2, 128, 0, "float32"),
    (256, 4, 4, 64, 0, "bfloat16"),
    (256, 2, 2, 64, 100, "float32"),
])
def test_flash_plain_matches_pallas(S, H, KV, hd, window, dtype):
    rng = np.random.default_rng(S + H + window)
    x = [rng.standard_normal((2, S, n, hd)).astype(np.float32)
         for n in (H, KV, KV)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in x]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for a in jx]
    out = flash_attention_plain(*tx, window=window)
    assert out.dtype == tx[0].dtype
    want = flash_attention_kernel(*jx, window=window)
    atol, rtol = (2e-5, 0.0) if dtype == "float32" else (1e-5, 2 ** -7)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)
    assert torch.equal(ops.flash_attention(*tx, window=window), out)


def test_block_score_plain_matches_pallas():
    rng = np.random.default_rng(3)
    N, page, KV, hd = 11, 8, 2, 16
    k = rng.standard_normal((N, page, KV, hd)).astype(np.float32)
    v = rng.standard_normal((N, page, KV, hd)).astype(np.float32)
    pos = rng.integers(-1, 50, (N, page)).astype(np.int32)
    pos[3] = -1                                         # an empty page
    got = block_score_plain(*map(torch.from_numpy, (k, v, pos))).numpy()
    want = np.asarray(block_score_kernel(*map(jnp.asarray, (k, v, pos))))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[3])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_page_scores_matches_jax(dtype):
    """ops.page_scores (the pool pass gathered through the block table;
    int8 dequantized first) against the JAX package's, on a cache with
    unmapped slots and a partly filled page."""
    Bc, P, pg, KV, hd = 2, 4, 4, 2, 16
    rng = np.random.default_rng(4)
    C = 3 * pg
    kk = rng.standard_normal((Bc, C, KV, hd)).astype(np.float32)
    vv = rng.standard_normal((Bc, C, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(C, dtype=np.int32), (Bc, 1))
    pos[1, -2:] = -1
    jc = jpc.write_prompt_pages(
        jpc.init_layer_cache(Bc, P, pg, KV, hd,
                             "int8" if dtype == "int8" else jnp.float32),
        *map(jnp.asarray, (kk, vv, pos, np.ones((Bc, C), np.float32))))
    tc = layer_cache_from_jax(jc, device="cpu")
    got = ops.page_scores(tc).numpy()
    want = np.asarray(jops.page_scores(jc))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    np.testing.assert_allclose(got[fin], ref.page_scores_ref(tc).numpy()[fin],
                               rtol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    k, v, pos, bt, cur = _pool(2, 16, seed=1)
    q = torch.zeros((B, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, k, v, pos, bt, cur)
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_cuda(q.reshape(B, 1, 4, 16), k, v, pos, bt, cur[:, None])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.reshape(B, 1, 4, 16), k[:B, :1], v[:B, :1])
    with pytest.raises(ValueError, match="CUDA"):
        block_score_cuda(k, v, pos)
