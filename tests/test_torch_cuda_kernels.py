"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py imports JAX.) Churned pools at the
main path's shapes (page 16, 49 slots, batch 8; llama-3.2-1b and -3b
heads), window 0 and 128, padding rows, float and int8 pools; the decode
kernel also at llama-3.1-8b's and qwen2.5-3b's heads, G 1 and 2 at page 8,
splits 1, 2, 4 and one page per split, every q / pool dtype pair, a row
with no mapped slot and a row at cur_pos -1; contiguous prompts for the flash kernel (a length that is not a
multiple of its tile, window 0 and 256). f32 within 1e-4 (the split-TF32
tensor-core routes at hd 32, 64, 80, 96 and 128, the CUDA-core routes at
hd 48); a bf16 query over an f32 pool (f32 arithmetic) within 1e-5 +
2**-7 of the value (so a bf16 output may differ by one rounding step);
bf16 on the bf16 tensor-core routes within ``ref.tc_bf16_bound`` (each
probability is rounded to bf16 before P V); norms and page scores within
1e-3 relative. Each launch's route is checked against its counter.
The per-Q-head prefill kernel must equal the G-fold one bit for bit. On
an int8 pool the prefill kernel reads the int8 values and scales: with a
bf16 query on its int8 tensor-core route, within ``ref.tc_bf16_bound`` of
the plain version over the dequantized pool; with an f32 query on its int8
f32 tensor-core route (int8 CUDA-core route at hd 48), bit-equal to the f32
route over the dequantized pool and within 1e-4 of the plain version;
norms within 1e-5 relative. At TINY's shape (hd 32, KV 4, G 1) the f32
prefill splits each block's key range (``paged_prefill_cuda.splits``).
Under autograd every wrapper refuses an input that requires grad (the
kernels have no backward pass); forward_train launches none of them.
Every kernel also at the head dims beside 64 and 128 (``NEW_HD``): TINY's
32 (4 heads, 4 KV heads), stablelm-3b's 80 (32 and 32) and 96 at G 4,
with the same tolerances. The
one-shot prefill of a ragged prompt above 2048 tokens (not a multiple of
128) goes through the flash kernel and agrees with its plain version.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import CacheConfig, get_arch
from repro_torch.core.policies import get_policy
from repro_torch.kernels import ref
from repro_torch.kernels.block_score import block_score_cuda, block_score_plain
from repro_torch.kernels.flash_prefill import (flash_attention_cuda,
                                               flash_attention_plain,
                                               flash_route,
                                               paged_prefill_cuda,
                                               paged_prefill_int8_plain,
                                               paged_prefill_plain,
                                               prefill_route)
from repro_torch.kernels.paged_attention import (combine_splits, dequantize,
                                                 paged_attention_cuda,
                                                 paged_attention_int8_cuda,
                                                 paged_attention_int8_plain,
                                                 paged_attention_plain)
from repro_torch.models.transformer import (forward_prefill, forward_train,
                                            init_model)

TOL = [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 1e-5, 2 ** -7)]


def _assert_within(got, want, bound):
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# decode shapes (KV, G, hd, page): llama-3.2-1b, -3b, 3.1-8b, qwen2.5-3b, the
# reduced configs (G 2, page 8) and one KV head per query head
DECODE_SHAPES = [(8, 4, 64, 16), (8, 3, 128, 16), (8, 4, 128, 16),
                 (2, 8, 128, 16), (2, 2, 64, 8), (4, 1, 64, 8)]
DECODE_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2 ** -7)}
# (KV, G, hd) at the other head dims: TINY, stablelm-3b, G 4 at hd 96
NEW_HD = [(4, 1, 32), (32, 1, 80), (2, 4, 96)]


def _decode_cases(kernel, plain, q, pool, bt, cur, P):
    """Kernel against plain on a churned pool with row 1 all unmapped and
    row 2 at cur_pos -1 (both must give zeros), window 0 and 128, splits 1,
    2, 4 and P (one page per split); tolerance by q's dtype."""
    bt, cur = bt.clone(), cur.clone()
    bt[1] = -1
    cur[2] = -1
    atol, rtol = DECODE_TOL[q.dtype]
    for window in (0, 128):
        for splits in (1, 2, 4, P):
            kw = dict(window=window, num_splits=splits, return_scores=True)
            a, m, l, nk = kernel(q, *pool, bt, cur, **kw)
            a2, m2, l2, nk2 = plain(q, *pool, bt, cur, **kw)
            o = combine_splits(a, m, l).to(q.dtype)
            assert not o[1:3].any(), (window, splits)
            torch.testing.assert_close(o, combine_splits(a2, m2, l2).to(
                q.dtype), atol=atol, rtol=rtol)
            for x, y in zip(nk, nk2):
                torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("KV,G,hd,page", DECODE_SHAPES)
def test_cuda_decode_matches_plain(cuda, KV, G, hd, page, dtype, pool_dtype):
    k, v, pos, bt, cur = ref.churned_pool(8, 49, page, KV, hd, pool_dtype,
                                          seed=hd + G, device=cuda)
    q = torch.randn((8, KV, G, hd), device=cuda).to(dtype)
    _decode_cases(paged_attention_cuda, paged_attention_plain, q,
                  (k, v, pos), bt, cur, 49)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,page", DECODE_SHAPES)
def test_cuda_decode_int8_matches_plain(cuda, KV, G, hd, page, dtype):
    k, v, ks, vs, pos, bt, cur = ref.churned_pool(8, 49, page, KV, hd,
                                                  torch.int8, seed=hd + G + 1,
                                                  device=cuda)
    q = torch.randn((8, KV, G, hd), device=cuda).to(dtype)
    _decode_cases(paged_attention_int8_cuda, paged_attention_int8_plain, q,
                  (k, v, ks, vs, pos), bt, cur, 49)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("KV,G,hd", NEW_HD)
def test_cuda_decode_new_head_dims_match_plain(cuda, KV, G, hd, dtype,
                                               pool_dtype):
    """hd 32, 80 and 96: lanes padded to a power of two, the extra ones
    idle; a pool of the query's dtype or int8."""
    pool = ref.churned_pool(8, 49, 16, KV, hd, pool_dtype, seed=hd + G,
                            device=cuda)
    *pool, bt, cur = pool
    q = torch.randn((8, KV, G, hd), device=cuda).to(dtype)
    kernel, plain = (paged_attention_int8_cuda, paged_attention_int8_plain) \
        if pool_dtype == torch.int8 else (paged_attention_cuda,
                                          paged_attention_plain)
    _decode_cases(kernel, plain, q, tuple(pool), bt, cur, 49)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool_dtype,atol,rtol", [
    (torch.float32, torch.float32, 1e-4, 0.0),
    (torch.bfloat16, torch.bfloat16, 1e-5, 2 ** -7),
    (torch.bfloat16, torch.float32, 1e-5, 2 ** -7),   # a dequantized pool
])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 64), (8, 3, 128)] + NEW_HD)
def test_cuda_prefill_matches_plain(cuda, KV, G, hd, dtype, pool_dtype, atol,
                                    rtol):
    k, v, pos, bt, cur = ref.churned_pool(8, 49, 16, KV, hd, pool_dtype,
                                          seed=hd, device=cuda)
    qp = ref.prefill_positions(cur.cpu(), 256).to(cuda)
    q = torch.randn((8, 256, KV * G, hd), device=cuda).to(dtype)
    route = prefill_route(dtype, pool_dtype, hd)
    for window in (0, 128):
        kw = dict(window=window, return_scores=True)
        before = getattr(paged_prefill_cuda, f"{route}_launches")
        o, nk = paged_prefill_cuda(q, k, v, pos, bt, qp, **kw)
        assert getattr(paged_prefill_cuda, f"{route}_launches") == before + 1
        o2, nk2 = paged_prefill_plain(q, k, v, pos, bt, qp, **kw)
        if route == "tensor_core":
            w = ref.abs_value_weight(q, k, v, window=window, pos=pos,
                                     block_table=bt, q_pos=qp)
            _assert_within(o, o2, ref.tc_bf16_bound(o2, w))
        else:
            torch.testing.assert_close(o, o2, atol=atol, rtol=rtol)
        for x, y in zip(nk, nk2):
            torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)
        # the per-Q-head grid: bit-equal to the fold
        if route == "f32_tensor_core" and (KV, G, hd) == (4, 1, 32):
            assert paged_prefill_cuda.splits > 1   # TINY: a small grid
        o3, _ = paged_prefill_cuda(q, k, v, pos, bt, qp, window=window,
                                   per_qhead=True)
        assert torch.equal(o3, o), float((o3.float() - o.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.int8)])
def test_cuda_core_routes_at_other_head_dims(cuda, q_dtype, pool_dtype):
    """hd 48 has no tensor-core tile: K3 / K4 (every pair an f32 route
    takes) and K5 (f32) on their CUDA-core routes."""
    KV, G, hd = 4, 2, 48
    pool = ref.churned_pool(8, 49, 16, KV, hd, pool_dtype, seed=48,
                            device=cuda)
    *pool, pos, bt, cur = pool
    qp = ref.prefill_positions(cur.cpu(), 256).to(cuda)
    q = torch.randn((8, 256, KV * G, hd), device=cuda).to(q_dtype)
    route = prefill_route(q_dtype, pool_dtype, hd)
    assert route == ("int8_cuda_core" if pool_dtype == torch.int8
                     else "cuda_core")
    scales = dict(k_scale=pool[2], v_scale=pool[3]) if len(pool) == 4 \
        else {}
    plain = paged_prefill_int8_plain if scales else paged_prefill_plain
    atol, rtol = (1e-4, 0.0) if q_dtype == torch.float32 else (1e-5, 2 ** -7)
    for window in (0, 128):
        before = getattr(paged_prefill_cuda, f"{route}_launches")
        o, nk = paged_prefill_cuda(q, *pool[:2], pos, bt, qp, **scales,
                                   window=window, return_scores=True)
        assert getattr(paged_prefill_cuda, f"{route}_launches") == before + 1
        o2, nk2 = plain(q, *pool, pos, bt, qp, window=window,
                        return_scores=True)
        torch.testing.assert_close(o, o2, atol=atol, rtol=rtol)
        for x, y in zip(nk, nk2):
            torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)
        o3, _ = paged_prefill_cuda(q, *pool[:2], pos, bt, qp, **scales,
                                   window=window, per_qhead=True)
        assert torch.equal(o3, o)
    if q_dtype == torch.float32 and pool_dtype == torch.float32:
        x = [torch.randn((1, 1000, n, hd), device=cuda) for n in (8, 4, 4)]
        before = flash_attention_cuda.cuda_core_launches
        o = flash_attention_cuda(*x, window=256)
        assert flash_attention_cuda.cuda_core_launches == before + 1
        torch.testing.assert_close(o, flash_attention_plain(*x, window=256),
                                   atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(8, 4, 64), (8, 3, 128)] + NEW_HD)
def test_cuda_prefill_int8_matches_plain(cuda, KV, G, hd, dtype):
    k, v, ks, vs, pos, bt, cur = ref.churned_pool(8, 49, 16, KV, hd,
                                                  torch.int8, seed=hd + 7,
                                                  device=cuda)
    kd, vd = dequantize(k, ks), dequantize(v, vs)
    qp = ref.prefill_positions(cur.cpu(), 256).to(cuda)
    q = torch.randn((8, 256, KV * G, hd), device=cuda).to(dtype)
    route = prefill_route(dtype, torch.int8, hd)
    assert route == ("int8_f32_tensor_core" if dtype == torch.float32
                     else "int8_tensor_core")
    for window in (0, 128):
        kw = dict(window=window, return_scores=True)
        before = getattr(paged_prefill_cuda, f"{route}_launches")
        o, nk = paged_prefill_cuda(q, k, v, pos, bt, qp, k_scale=ks,
                                   v_scale=vs, **kw)
        assert getattr(paged_prefill_cuda, f"{route}_launches") == before + 1
        o2, nk2 = paged_prefill_int8_plain(q, k, v, ks, vs, pos, bt, qp, **kw)
        assert not o[7].any(), "padding rows must output zeros"
        if route == "int8_tensor_core":
            w = ref.abs_value_weight(q, kd, vd, window=window, pos=pos,
                                     block_table=bt, q_pos=qp)
            _assert_within(o, o2, ref.tc_bf16_bound(o2, w))
        else:
            o4, nk4 = paged_prefill_cuda(q, kd, vd, pos, bt, qp, **kw)
            assert torch.equal(o, o4), float((o - o4).abs().max())
            assert all(torch.equal(x, y) for x, y in zip(nk, nk4))
            torch.testing.assert_close(o, o2, atol=1e-4, rtol=0.0)
        for x, y in zip(nk, nk2):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        o3, _ = paged_prefill_cuda(q, k, v, pos, bt, qp, k_scale=ks,
                                   v_scale=vs, window=window, per_qhead=True)
        assert torch.equal(o3, o), float((o3.float() - o.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOL)
@pytest.mark.parametrize("H,KV,hd", [(32, 8, 64), (24, 8, 128)] +
                         [(KV * G, KV, hd) for KV, G, hd in NEW_HD])
def test_cuda_flash_matches_plain(cuda, H, KV, hd, dtype, atol, rtol):
    for B, S, window in ((2, 128, 0), (1, 1000, 0), (1, 1024, 256)):
        q = torch.randn((B, S, H, hd), device=cuda).to(dtype)
        k = torch.randn((B, S, KV, hd), device=cuda).to(dtype)
        v = torch.randn((B, S, KV, hd), device=cuda).to(dtype)
        route = flash_route(dtype, hd)
        before = getattr(flash_attention_cuda, f"{route}_launches")
        o = flash_attention_cuda(q, k, v, window=window)
        assert getattr(flash_attention_cuda, f"{route}_launches") == \
            before + 1
        o2 = flash_attention_plain(q, k, v, window=window)
        if route == "tensor_core":
            w = ref.abs_value_weight(q, k, v, window=window)
            _assert_within(o, o2, ref.tc_bf16_bound(o2, w))
        else:
            torch.testing.assert_close(o, o2, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,KV,hd", [(16, 8, 64), (16, 8, 128),
                                        (32, 8, 64), (16, 2, 64)] +
                         [(16, KV, hd) for KV, _, hd in NEW_HD])
def test_cuda_block_score_matches_plain(cuda, page, KV, hd, dtype):
    k, v, pos, bt, cur = ref.churned_pool(8, 49, page, KV, hd, dtype,
                                          seed=hd + KV + page, device=cuda)
    pos[bt[0, 0]] = -1                                  # an empty page
    before = block_score_cuda.launches
    got, want = block_score_cuda(k, v, pos), block_score_plain(k, v, pos)
    assert block_score_cuda.launches == before + 1
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isinf(got[bt[0, 0]])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
def test_cuda_prefill_ragged_long_prompt(cuda):
    cfg = dataclasses.replace(get_arch("llama-3.2-1b").reduced(),
                              num_heads=4, num_kv_heads=2)
    params = init_model(cfg, seed=0, device=cuda)
    S = 3000
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                           dtype=torch.int32).to(cuda)
    valid = torch.arange(S, device=cuda)[None] < \
        torch.tensor([[S], [S - 77]], device=cuda)
    ccfg = CacheConfig(page_size=8, cache_budget=64, dtype="float32")
    pol = get_policy(ccfg.policy)
    before = flash_attention_cuda.launches
    lk, ck = forward_prefill(params, cfg, tokens, pol, ccfg, valid=valid)
    assert flash_attention_cuda.launches == before + cfg.num_layers
    lp, cp = forward_prefill(params, cfg, tokens, pol, ccfg, valid=valid,
                             plain_kernels=True)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    for a, b in zip(ck.layers, cp.layers):
        for f in ("block_table", "pos", "cur_page", "cur_off"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_cuda_kernels_refuse_autograd(cuda):
    """Under autograd a wrapper refuses an input that requires grad (the
    kernels have no backward pass) and launches nothing; under no_grad the
    same call runs. forward_train launches no kernel; the one-shot prefill
    from weights that require grad runs (it is under no_grad)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(cuda)
               for s in ((2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    before = flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention_cuda(q.requires_grad_(), k, v)
    assert flash_attention_cuda.launches == before
    with torch.no_grad():
        out = flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, flash_attention_plain(q.detach(), k, v),
                               atol=1e-4, rtol=0)
    cfg = get_arch("llama-3.2-1b").reduced()
    params = init_model(cfg, seed=0, device=cuda)
    for p in params["layers"][0]["attn"].values():
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                           dtype=torch.int32).to(cuda)
    logits, _ = forward_train(params, cfg, tokens)
    logits.sum().backward()
    assert flash_attention_cuda.launches == before + 1
    assert float(params["layers"][0]["attn"]["wq"].grad.abs().max()) > 0
    ccfg = CacheConfig(page_size=8, cache_budget=64, dtype="float32")
    lg, _ = forward_prefill(params, cfg, tokens, get_policy(ccfg.policy),
                            ccfg)
    assert flash_attention_cuda.launches == before + 1 + cfg.num_layers
    assert not lg.requires_grad
