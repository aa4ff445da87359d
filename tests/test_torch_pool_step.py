"""Alg. 3's pool bookkeeping kernels (kernels/pool_step.py) against their
plain torch versions.

The ``cuda`` tests skip without a CUDA device; the file imports neither JAX
nor the JAX package, so on the card it runs as

    python -m pytest -q --noconftest -m cuda tests/test_torch_pool_step.py

Pool states are built on the CPU by the port's own chunked appends (as
tests/test_torch_policies.py builds them in the JAX package, with quarter
scores so that page means tie and sum exactly), then moved to the card and
copied: one copy runs the kernel, the other the plain version
(``plain=True``). Every pool field (the trash row aside), the stats and the
outcome tensors must then be equal bit for bit: f32, bf16 and int8 pools;
protect_recent on and off; stored and fused page scores, with exact ties
and rows whose candidates are all +inf; inactive rows; a pool smaller than
B * P, which forces evictions; pages shared by ``adopt_prefix``. Multi-step
runs of ``decode_append`` cross page boundaries and the budget for every
policy; the score the append kernel computes itself (Alg. 1) is held within
2 ulp of ``vk_ratio_score``, and its bits are then handed to the plain copy
so that both go on from equal inputs.

On a CPU pool ``decode_append`` and ``PagedEviction.post_write`` take the
plain versions and launch nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import CacheConfig
from repro_torch.core import importance
from repro_torch.core.decode import decode_append
from repro_torch.core.paged_cache import (adopt_prefix, append_chunk,
                                          append_plan, init_layer_cache,
                                          release_rows,
                                          row_intact_prefix_pages)
from repro_torch.core.policies import POLICIES, get_policy
from repro_torch.kernels.pool_step import (paged_evict_cuda,
                                           pool_append_cuda,
                                           pool_append_plain)

B, P, page, KV, hd, T = 4, 8, 4, 2, 8, 8
ALL = ["paged_eviction", "full", "streaming_llm", "inverse_key_l2", "keydiff"]
POOLS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8",
         "int8_bf16": "int8"}
FIELDS = ("k", "v", "k_scale", "v_scale", "pos", "score", "block_table",
          "ref_count", "cur_page", "cur_off", "stats")
OUTCOME = ("pages_evicted", "tokens_evicted", "forced_evictions",
           "victim_page", "victim_score")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tok_dtype(pool):
    """The tokens' dtype: bf16 into a bf16 pool, and into an int8 one in
    the ``int8_bf16`` cases."""
    return torch.float32 if pool in ("f32", "int8") else torch.bfloat16


def _build(seed, pool, pool_pages=None, share=False):
    """A CPU pool after 4 chunked appends of 0-8 tokens a row with
    quarter scores; with ``share``, row 1 released and given row 0's intact
    prompt pages (a shared prefix)."""
    rng = np.random.default_rng(seed)
    c = init_layer_cache(B, P, page, KV, hd, POOLS[pool],
                         pool_pages=pool_pages, track_stats=True,
                         device="cpu")
    dt = _tok_dtype(pool)
    nxt = np.zeros(B, np.int32)
    for _ in range(4):
        n = rng.integers(0, T + 1, B).astype(np.int32)
        t = np.arange(T, dtype=np.int32)
        pos = np.where(t[None] < n[:, None], nxt[:, None] + t, -1)
        times = append_plan(c, c.cur_off.numpy(), c.head_mapped().numpy(),
                            n, T)
        append_chunk(
            c, torch.from_numpy(rng.standard_normal((B, T, KV, hd),
                                                    np.float32)).to(dt),
            torch.from_numpy(rng.standard_normal((B, T, KV, hd),
                                                 np.float32)).to(dt),
            torch.from_numpy(pos.astype(np.int32)),
            torch.from_numpy((rng.integers(1, 4, (B, T)) / 4)
                             .astype(np.float32)),
            torch.from_numpy(n), times)
        nxt += n
    if share:
        n_pages = row_intact_prefix_pages(c, 0)
        one = torch.tensor([False, True, False, False])
        release_rows(c, one)
        adopt_prefix(c, torch.tensor([-1, 0, -1, -1], dtype=torch.int32),
                     torch.full((B,), int(n_pages), dtype=torch.int32),
                     enable=one)
    return c


def _to(cache, device):
    return dataclasses.replace(cache, **{
        f.name: None if getattr(cache, f.name) is None else
        getattr(cache, f.name).clone().to(device)
        for f in dataclasses.fields(cache)})


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _same_pool(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert torch.equal(_bits(a), _bits(b)), f


def _same_outcome(got, want):
    for name in OUTCOME:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert torch.equal(_bits(a), _bits(b)), name


def _fused(rng, cache):
    """Fused-like page scores: integers 1-2 (exact ties), +inf on a fifth
    of the slots and on every slot of row 3 (all candidates +inf)."""
    ps = rng.integers(1, 3, (B, P)).astype(np.float32)
    ps[rng.random((B, P)) < 0.2] = np.inf
    ps[3] = np.inf
    return torch.from_numpy(ps).to(cache.device)


def _cfg(policy, protect, budget=8):
    return CacheConfig(page_size=page, cache_budget=budget, policy=policy,
                       protect_recent=protect, dtype="float32")


def _pair(cuda, seed, pool, **kw):
    base = _build(seed, pool, **kw)
    return _to(base, cuda), _to(base, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["full_pool", "small_pool", "shared"])
@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_evict_matches_plain(cuda, seed, pool, protect, fused, state):
    """PagedEviction.post_write: one launch of paged_evict against the
    plain version, every row's head page full (the hook's working case)
    and a random one inactive."""
    kw = {"small_pool": dict(pool_pages=2 * P), "shared": dict(share=True),
          "full_pool": {}}[state]
    kern, plain = _pair(cuda, seed, pool, **kw)
    for c in (kern, plain):
        c.cur_off.fill_(page)
    rng = np.random.default_rng(seed + 100)
    active = torch.from_numpy(rng.random(B) < 0.8).to(cuda)
    ps = _fused(rng, kern) if fused else None
    pol = get_policy("paged_eviction")
    cfg = _cfg("paged_eviction", protect)
    n0 = paged_evict_cuda.launches
    got = pol.post_write(kern, cfg, active=active, page_scores=ps)
    want = pol.post_write(plain, cfg, active=active, page_scores=ps,
                          plain=True)
    assert paged_evict_cuda.launches == n0 + 1
    _same_outcome(got, want)
    _same_pool(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["full_pool", "small_pool", "shared"])
@pytest.mark.parametrize("scored", [False, True], ids=["alg1", "given"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_append_matches_plain(cuda, seed, pool, scored, state):
    """One decode token a row through pool_append against the plain
    version (rollover of full heads, then the write), inactive rows
    included; with the score given the pools must be equal in every bit,
    with Alg. 1 computed in the kernel the scores within 2 ulp."""
    kw = {"small_pool": dict(pool_pages=2 * P), "shared": dict(share=True),
          "full_pool": {}}[state]
    kern, plain = _pair(cuda, seed, pool, **kw)
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = _tok_dtype(pool)
    k = torch.randn((B, KV, hd), generator=g, device=cuda).to(dt)
    v = torch.randn((B, KV, hd), generator=g, device=cuda).to(dt)
    pos = torch.arange(100, 100 + B, dtype=torch.int32, device=cuda)
    active = torch.tensor([True, False, True, True], device=cuda)
    score = importance.vk_ratio_score(k, v)
    n0 = pool_append_cuda.launches
    pool_append_cuda(kern, k, v, pos, score if scored else None, active)
    assert pool_append_cuda.launches == n0 + 1
    pool_append_plain(plain, k, v, pos, score, active)
    if not scored:
        _within_2ulp(kern.score, plain.score)
        plain.score_buf.copy_(kern.score_buf)
    _same_pool(kern, plain)


def _within_2ulp(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    w = want[fin].abs()
    ulp = torch.nextafter(w, torch.full_like(w, np.inf)) - w
    err = (got[fin] - want[fin]).abs()
    assert bool((err <= 2 * ulp).all()), float((err / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["stored", "fused"])
@pytest.mark.parametrize("small", [False, True], ids=["full_pool",
                                                      "small_pool"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("policy", ALL)
def test_decode_append_steps_match_plain(cuda, policy, pool, small, fused):
    """48 decode steps of decode_append from a shared-prefix state, with
    rows going inactive now and then: page boundaries, the budget and (in
    the small pool) forced evictions. PagedEviction's scores come from the
    kernel (2 ulp, then handed over); the other policies' are given."""
    kern, plain = _pair(cuda, 3, pool, share=True,
                        pool_pages=2 * P + 2 if small else None)
    pol = get_policy(policy)
    cfg = _cfg(policy, True, budget=12)
    g = torch.Generator(device=cuda).manual_seed(7)
    rng = np.random.default_rng(7)
    dt = _tok_dtype(pool)
    pos = torch.full((B,), 40, dtype=torch.int32, device=cuda)

    def attend(c):
        # fused-like scores with ties: a function of the block table
        return torch.where(c.mapped_mask(), (c.block_table % 3).float(),
                           torch.inf) if fused else None

    n0 = pool_append_cuda.launches
    for step in range(48):
        k = torch.randn((B, KV, hd), generator=g, device=cuda).to(dt)
        v = torch.randn((B, KV, hd), generator=g, device=cuda).to(dt)
        active = torch.from_numpy(rng.random(B) < 0.85).to(cuda)
        got = decode_append(kern, k, v, pos, pol, cfg, active=active,
                            attend=attend)
        want = decode_append(plain, k, v, pos, pol, cfg, active=active,
                             attend=attend, plain=True)
        if policy == "paged_eviction":
            _within_2ulp(kern.score, plain.score)
            plain.score_buf.copy_(kern.score_buf)
        _same_outcome(got, want)
        _same_pool(kern, plain)
        pos = torch.where(active, pos + 1, pos)
    assert pool_append_cuda.launches == n0 + 48


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV_,hd_", [(8, 128), (8, 64), (2, 96), (4, 32)])
def test_alg1_score_within_2ulp(cuda, dtype, KV_, hd_):
    """The append kernel's own Alg. 1 score of 512 tokens (a zero key
    among them: the 1e-6 floor) within 2 ulp of vk_ratio_score on the
    card, at a head dim read as vectors (128) and at shorter ones."""
    Bn = 512
    c = init_layer_cache(Bn, 2, 16, KV_, hd_, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(hd_)
    k = (torch.randn((Bn, KV_, hd_), generator=g, device=cuda) *
         torch.rand((Bn, KV_, 1), generator=g, device=cuda) * 4).to(dtype)
    v = torch.randn((Bn, KV_, hd_), generator=g, device=cuda).to(dtype)
    k[5] = 0
    pos = torch.zeros(Bn, dtype=torch.int32, device=cuda)
    pool_append_cuda(c, k, v, pos)
    got = c.score[torch.arange(Bn, device=cuda), 0]
    _within_2ulp(got, importance.vk_ratio_score(k, v))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    c = _to(_build(0, "f32"), cuda)
    k = torch.zeros((B, KV, hd), device=cuda)
    pos = torch.zeros(B, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k_tok"):
        pool_append_cuda(c, k[:, :1], k, pos)
    with pytest.raises(ValueError, match="active"):
        pool_append_cuda(c, k, k, pos, active=torch.ones(B, device=cuda))
    with pytest.raises(ValueError, match="page_scores"):
        paged_evict_cuda(c, 8, False, page_scores=torch.zeros(
            (B, P + 1), device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        pool_append_cuda(_build(0, "f32"), k, k, pos)


@pytest.mark.parametrize("policy", ALL)
def test_cpu_pool_takes_the_plain_versions(policy):
    """On a CPU pool decode_append and every post_write run the plain
    versions: no kernel launch, and the same pool as the torch code."""
    a, b = _build(0, "f32"), _build(0, "f32")
    pol = get_policy(policy)
    cfg = _cfg(policy, False)
    n_app, n_ev = pool_append_cuda.launches, paged_evict_cuda.launches
    rng = np.random.default_rng(0)
    for step in range(12):
        k = torch.from_numpy(rng.standard_normal((B, KV, hd), np.float32))
        v = torch.from_numpy(rng.standard_normal((B, KV, hd), np.float32))
        pos = torch.full((B,), 40 + step, dtype=torch.int32)
        decode_append(a, k, v, pos, pol, cfg)
        decode_append(b, k, v, pos, pol, cfg, plain=True)
    assert (pool_append_cuda.launches, paged_evict_cuda.launches) == \
        (n_app, n_ev)
    _same_pool(a, b)


def test_only_unaveraged_alg1_is_scored_in_the_kernel():
    """The append kernel computes the token score itself only for Alg. 1
    over one device's heads: PagedEviction without a tensor-parallel
    group; the baselines and any grouped policy hand theirs over."""
    assert [POLICIES[n].local_vk_ratio for n in ALL] == \
        [True, False, False, False, False]
    assert not get_policy("paged_eviction", tp_group=object()).local_vk_ratio
