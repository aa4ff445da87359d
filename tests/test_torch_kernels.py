"""The port's paged attention kernels against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_kernels.py runs them).

On the CPU the port runs each kernel's plain torch version; the same
churned pools (freed and reallocated pages, unmapped slots, shared prefix
pages, padding rows) go to both packages, and the outputs, the raw norm
tiles and the page scores reduced from them must agree within 1e-4.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.importance import page_scores_from_norms as j_scores
from repro.kernels.flash_prefill import paged_flash_prefill_kernel
from repro.kernels.paged_attention import paged_attention_kernel
from repro_torch.core.importance import page_scores_from_norms
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (paged_prefill_cuda,
                                               paged_prefill_plain)
from repro_torch.kernels.paged_attention import (combine_splits,
                                                 paged_attention_cuda,
                                                 paged_attention_plain)

ATOL = 1e-4
B, P, page = 3, 7, 8


def _pool(KV, hd, seed):
    return ref.churned_pool(B, P, page, KV, hd, torch.float32, seed)


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


def test_cuda_wrappers_refuse_cpu_tensors():
    k, v, pos, bt, cur = _pool(2, 16, seed=1)
    q = torch.zeros((B, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, k, v, pos, bt, cur)
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_cuda(q.reshape(B, 1, 4, 16), k, v, pos, bt, cur[:, None])
