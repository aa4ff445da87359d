"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py imports JAX.) Churned pools at the
main path's shapes (page 16, 49 slots, batch 8; llama-3.2-1b and -3b
heads), window 0 and 128, splits 1 and 4, padding rows; f32 within 1e-4,
bf16 within 1e-5 + 2**-7 of the value (both compute in f32, so a bf16
output may differ by one rounding step), norms within 1e-3 relative.
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (paged_prefill_cuda,
                                               paged_prefill_plain)
from repro_torch.kernels.paged_attention import (combine_splits,
                                                 paged_attention_cuda,
                                                 paged_attention_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 1e-5, 2 ** -7)])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 64), (8, 3, 128)])
def test_cuda_decode_matches_plain(cuda, KV, G, hd, dtype, atol, rtol):
    k, v, pos, bt, cur = (t.to(cuda) for t in ref.churned_pool(
        8, 49, 16, KV, hd, dtype, seed=hd))
    q = torch.randn((8, KV, G, hd), device=cuda).to(dtype)
    for window in (0, 128):
        for splits in (1, 4):
            kw = dict(window=window, num_splits=splits, return_scores=True)
            a, m, l, nk = paged_attention_cuda(q, k, v, pos, bt, cur, **kw)
            a2, m2, l2, nk2 = paged_attention_plain(q, k, v, pos, bt, cur,
                                                    **kw)
            torch.testing.assert_close(combine_splits(a, m, l).to(dtype),
                                       combine_splits(a2, m2, l2).to(dtype),
                                       atol=atol, rtol=rtol)
            for x, y in zip(nk, nk2):
                torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 1e-5, 2 ** -7)])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 64), (8, 3, 128)])
def test_cuda_prefill_matches_plain(cuda, KV, G, hd, dtype, atol, rtol):
    k, v, pos, bt, cur = (t.to(cuda) for t in ref.churned_pool(
        8, 49, 16, KV, hd, dtype, seed=hd))
    qp = ref.prefill_positions(cur.cpu(), 256).to(cuda)
    q = torch.randn((8, 256, KV * G, hd), device=cuda).to(dtype)
    for window in (0, 128):
        kw = dict(window=window, return_scores=True)
        o, nk = paged_prefill_cuda(q, k, v, pos, bt, qp, **kw)
        o2, nk2 = paged_prefill_plain(q, k, v, pos, bt, qp, **kw)
        torch.testing.assert_close(o, o2, atol=atol, rtol=rtol)
        for x, y in zip(nk, nk2):
            torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)
