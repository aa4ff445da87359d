"""The tolerance of the tensor-core bf16 attention kernels, on the CPU.

The bf16 routes of the flash and paged-prefill kernels round each
probability to bf16 before P V; the plain versions keep P in f32.
``ref.tc_bf16_bound`` (1e-5 + 2^-7 |plain| + 2^-8 (P |V|) / l) is what the
card's checks hold them to. Here that rounding is emulated in plain torch
(the softmax of the plain version, P rounded to bf16 before P V, the output
rounded to bf16), at the phase-2 shapes of chip_smoke.py in small form
(llama-3.2-1b heads: 8 KV heads of 64, G 4; page 16; a churned pool with a
full prefill row, a partial one, decode rows and an idle row), with and
without a window. The bound must cover the emulated error everywhere and
must be broken somewhere by twice that error, so it is not vacuous.

The int8 tensor-core route of the paged prefill (a bf16 query over an int8
pool) keeps the scales out of the products: S = (q . x) s_k / 127 with the
int8 values x exact in bf16, P' = p s_v / 127 rounded to bf16, o = P' x / l
(l the sum of the unfolded p). Emulated the same way at hd 64 and 80, it
must lie within the same bound, weighted by (P |V|) / l of the dequantized
pool, and reach more than half of it somewhere.

The f32 routes of K3 (the fold, over an f32 pool and over an int8 one
through its dequantized values, which the int8 route widens bit for bit),
K4 and K5 run every product in split TF32: hi = tf32(x), lo = tf32(x -
hi), lo hi + hi lo then hi hi, f32 sums; each 64-key tile's P V summed on
its own and folded as o alpha + P V; K3 over a split key range merged. That
arithmetic is emulated here at hd 32 and 128, windows 0 and 128, and must
stay within the f32 tolerance chip_smoke.py holds the routes to (1e-4)
of the plain version, while plain TF32 (one product of the rounded
operands) must break it somewhere: the tolerance tells the two apart.
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (flash_attention_plain,
                                               paged_prefill_int8_plain,
                                               paged_prefill_plain)
from repro_torch.kernels.paged_attention import dequantize

KV, G, HD, PAGE = 8, 4, 64, 16
F32_ATOL = 1e-4     # chip_smoke.py's TOL["float32"]


def _softmax_pv_bf16(s, valid, v):
    """Masked softmax over the last axis of s, P rounded to bf16, then
    P V / l in f32; fully masked rows give zeros."""
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return (p.bfloat16().float() @ v) / l.clamp_min(1e-30)


def _flash_emulated(q, k, v, window):
    B, S, H, hd = q.shape
    qg = q.reshape(B, S, KV, G, hd).float().permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]      # (B, KV, 1, S, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qg @ kf.transpose(-1, -2) * hd ** -0.5            # (B, KV, G, S, S)
    i = torch.arange(S)
    valid = i[None, :] <= i[:, None]
    if window > 0:
        valid &= i[None, :] > i[:, None] - window
    o = _softmax_pv_bf16(s, valid, vf)                    # (B, KV, G, S, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).bfloat16()


def _prefill_emulated(q, k, v, pos, bt, qp, window):
    B, T, H, hd = q.shape
    kg, vg, pg = ref.gather_block_table(k, v, pos, bt)
    P = kg.shape[2]
    kf = kg.float().reshape(B, KV, 1, P * PAGE, hd)
    vf = vg.float().reshape(B, KV, 1, P * PAGE, hd)
    qg = q.reshape(B, T, KV, G, hd).float().permute(0, 2, 3, 1, 4)
    s = qg @ kf.transpose(-1, -2) * hd ** -0.5            # (B, KV, G, T, S)
    kp = pg.reshape(B, 1, P * PAGE)
    qq = qp[:, :, None]
    valid = (kp >= 0) & (qq >= 0) & (kp <= qq)
    if window > 0:
        valid &= kp > qq - window
    o = _softmax_pv_bf16(s, valid[:, None, None], vf)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).bfloat16()


def _prefill_int8_emulated(q, k8, v8, ks, vs, pos, bt, qp, window):
    """The int8 tensor-core route: per-key factors s / 127 (correctly
    rounded, as the kernel divides), scores of the exact int8 values scaled
    per key, P' = p s_v / 127 rounded to bf16 before P' x, l the sum of the
    unfolded p, the output rounded to bf16."""
    B, T, H, hd = q.shape
    kg, vg, pg = ref.gather_block_table(k8, v8, pos, bt)
    kf, vf, _ = ref.gather_block_table(ks[..., None], vs[..., None], pos, bt)
    P = kg.shape[2]
    S = P * PAGE
    x_k = kg.float().reshape(B, KV, 1, S, hd)
    x_v = vg.float().reshape(B, KV, 1, S, hd)
    f_k = (kf / torch.tensor(127.0)).reshape(B, KV, 1, 1, S)
    f_v = (vf / torch.tensor(127.0)).reshape(B, KV, 1, 1, S)
    qg = q.reshape(B, T, KV, G, hd).float().permute(0, 2, 3, 1, 4)
    s = (qg @ x_k.transpose(-1, -2)) * f_k * hd ** -0.5   # (B, KV, G, T, S)
    kp = pg.reshape(B, 1, S)
    qq = qp[:, :, None]
    valid = (kp >= 0) & (qq >= 0) & (kp <= qq)
    if window > 0:
        valid &= kp > qq - window
    valid = valid[:, None, None]
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    pf = torch.where(valid, p * f_v, 0.0).bfloat16().float()
    o = (pf @ x_v) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).bfloat16()


def _check(emulated, plain, weight):
    err = (emulated.float() - plain.float()).abs()
    bound = ref.tc_bf16_bound(plain, weight)
    assert bool((err <= bound).all()), float((err / bound).max())
    assert bool((2 * err > bound).any()), float((err / bound).max())


@pytest.mark.parametrize("window", [0, 64])
def test_tc_bound_covers_flash(window):
    g = torch.Generator().manual_seed(window)
    S = 256
    q, k, v = (torch.randn((1, S, n, HD), generator=g).bfloat16()
               for n in (KV * G, KV, KV))
    plain = flash_attention_plain(q, k, v, window=window)
    weight = ref.abs_value_weight(q, k, v, window=window)
    assert weight.dtype == torch.float32 and weight.shape == plain.shape
    _check(_flash_emulated(q, k, v, window), plain, weight)


@pytest.mark.parametrize("window", [0, 128])
def test_tc_bound_covers_paged_prefill(window):
    k, v, pos, bt, cur = ref.churned_pool(4, 9, PAGE, KV, HD, torch.bfloat16,
                                          seed=7 + window, device="cpu")
    T = 48
    qp = ref.prefill_positions(cur, T)
    q = torch.randn((4, T, KV * G, HD),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    plain, _ = paged_prefill_plain(q, k, v, pos, bt, qp, window=window)
    weight = ref.abs_value_weight(q, k, v, window=window, pos=pos,
                                  block_table=bt, q_pos=qp)
    assert weight.shape == plain.shape
    assert not weight[3].any(), "padding rows weigh nothing"
    _check(_prefill_emulated(q, k, v, pos, bt, qp, window), plain, weight)


def test_abs_value_weight_is_attention_of_magnitudes():
    """(P |V|) / l >= |P V| / l elementwise, with equality where v >= 0."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn((1, 64, n, 16), generator=g) for n in (4, 2))
    v = torch.randn((1, 64, 2, 16), generator=g)
    w = ref.abs_value_weight(q, k, v)
    out = flash_attention_plain(q, k, v)
    assert bool((w + 1e-6 >= out.abs()).all())
    torch.testing.assert_close(ref.abs_value_weight(q, k, v.abs()),
                               flash_attention_plain(q, k, v.abs()))


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("window", [0, 64])
def test_tc_bound_covers_paged_prefill_int8(window, hd):
    k8, v8, ks, vs, pos, bt, cur = ref.churned_pool(
        4, 9, PAGE, KV, hd, torch.int8, seed=11 + window + hd, device="cpu")
    T = 48
    qp = ref.prefill_positions(cur, T)
    q = torch.randn((4, T, KV * G, hd),
                    generator=torch.Generator().manual_seed(2)).bfloat16()
    plain, _ = paged_prefill_int8_plain(q, k8, v8, ks, vs, pos, bt, qp,
                                        window=window)
    weight = ref.abs_value_weight(q, dequantize(k8, ks), dequantize(v8, vs),
                                  window=window, pos=pos, block_table=bt,
                                  q_pos=qp)
    assert not weight[3].any(), "padding rows weigh nothing"
    _check(_prefill_int8_emulated(q, k8, v8, ks, vs, pos, bt, qp, window),
           plain, weight)


# ---------------------------------------------------------------------------
# the f32 routes: split TF32
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero; the low 13 bits zero): the kernels' ``to_tf32``."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in split TF32: lo_a hi_b + hi_a lo_b, then hi_a hi_b, f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm1(a, b):
    """a @ b in plain TF32: one product of the rounded operands."""
    return _tf32(a) @ _tf32(b)


def _walk(q, k, v, valid, scale, mm, splits=1, tile=64):
    """The f32 routes' arithmetic for rows q (..., R, hd) over keys k, v
    (..., S, hd) where valid (..., R, S): per split of the 64-key tiles an
    online softmax (m on the unscaled products, p = exp(scale (s - m)),
    masked p exactly 0, each tile's P V folded as o alpha + P V), then the
    splits merged as the merge kernel does; products by ``mm``."""
    S = k.shape[-2]
    per = -(-(-(-S // tile)) // splits) * tile
    parts = []
    for k0 in range(0, S, per):
        m = torch.full(q.shape[:-1] + (1,), -1e30)
        l = torch.zeros(q.shape[:-1] + (1,))
        o = torch.zeros(q.shape)
        for t0 in range(k0, min(S, k0 + per), tile):
            ok = valid[..., t0:t0 + tile]
            s = mm(q, k[..., t0:t0 + tile, :].transpose(-1, -2))
            m_new = torch.maximum(m, torch.where(ok, s, -1e30).amax(
                -1, keepdim=True))
            alpha = torch.where(m_new == m, 1.0,
                                torch.exp((m - m_new) * scale))
            p = torch.where(ok, torch.exp((s - m_new) * scale), 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            o = o * alpha + mm(p, v[..., t0:t0 + tile, :])
            m = m_new
        parts.append((o, m, l))
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    w = [torch.where(m == mx, 1.0, torch.exp((m - mx) * scale))
         for _, m, _ in parts]
    o = sum(wi * oi for wi, (oi, _, _) in zip(w, parts))
    l = sum(wi * li for wi, (_, _, li) in zip(w, parts))
    return o / l.clamp_min(1e-30)


def _paged_f32_emulated(q, k, v, pos, bt, qp, window, mm, per_qhead=False,
                    splits=1):
    """K3's fold (rows g * T + t of a KV head) or K4 (each query head's T
    rows) over the block table's slots laid end to end."""
    B, T, H, hd = q.shape
    kg, vg, pg = ref.gather_block_table(k, v, pos, bt)
    nkv, S = kg.shape[1], kg.shape[2] * kg.shape[3]
    g = H // nkv
    kf = kg.float().reshape(B, nkv, 1, S, hd)
    vf = vg.float().reshape(B, nkv, 1, S, hd)
    kp, qq = pg.reshape(B, 1, S), qp[:, :, None]
    valid = (kp >= 0) & (qq >= 0) & (kp <= qq)               # (B, T, S)
    if window > 0:
        valid &= kp > qq - window
    qg = q.reshape(B, T, nkv, g, hd).float().permute(0, 2, 3, 1, 4)
    if per_qhead:       # (B, KV, G, T, hd): one query head's rows at a time
        o = torch.stack([_walk(qg[:, :, h], kf[:, :, 0], vf[:, :, 0],
                               valid[:, None], hd ** -0.5, mm, splits)
                         for h in range(g)], 2)
    else:               # (B, KV, G * T, hd): the fold
        o = _walk(qg.reshape(B, nkv, g * T, hd), kf[:, :, 0], vf[:, :, 0],
                  valid[:, None].repeat(1, g, 1, 1).reshape(B, 1, g * T, S),
                  hd ** -0.5, mm, splits)
        o = o.reshape(B, nkv, g, T, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


def _flash_f32_emulated(q, k, v, window, mm):
    B, S, H, hd = q.shape
    nkv = k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)                     # (B, H, S, hd)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(H // nkv, 1)
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(H // nkv, 1)
    i = torch.arange(S)
    valid = i[None, :] <= i[:, None]
    if window > 0:
        valid &= i[None, :] > i[:, None] - window
    o = _walk(qh, kh, vh, valid, hd ** -0.5, mm)
    return o.permute(0, 2, 1, 3)


def test_tf32_rounds_to_nearest_ties_away():
    """Ten mantissa bits, the low 13 zero, within half a TF32 step, ties
    away from zero (both signs), carries into the exponent."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(
        -6, 6, (4096,), generator=g)
    t = _tf32(x)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    step = 2.0 ** (torch.frexp(x.abs()).exponent.double() - 11)
    assert bool(((t.double() - x.double()).abs() <= step / 2).all())
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                        2 - 2 ** -12])
    assert _tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                   1 + 2 * 2 ** -10, 2.0]


@pytest.mark.parametrize("kernel", ["fold", "fold_int8", "per_qhead",
                                    "flash"])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("window", [0, 128])
def test_split_tf32_within_f32_tolerance(kernel, hd, window):
    g = torch.Generator().manual_seed(hd + window)
    if kernel == "flash":
        S = 256
        q, k, v = (torch.randn((1, S, n, hd), generator=g)
                   for n in (KV * G, KV, KV))
        plain = flash_attention_plain(q, k, v, window=window)
        run = lambda mm: _flash_f32_emulated(q, k, v, window, mm)  # noqa: E731
    else:
        if kernel == "fold_int8":   # the int8 route's tiles: dequantize()
            k8, v8, ks, vs, pos, bt, cur = ref.churned_pool(
                4, 9, PAGE, KV, hd, torch.int8, seed=hd, device="cpu")
            k, v = dequantize(k8, ks), dequantize(v8, vs)
        else:
            k, v, pos, bt, cur = ref.churned_pool(
                4, 9, PAGE, KV, hd, torch.float32, seed=hd, device="cpu")
        T = 48
        qp = ref.prefill_positions(cur, T)
        q = torch.randn((4, T, KV * G, hd), generator=g)
        plain, _ = paged_prefill_plain(q, k, v, pos, bt, qp, window=window)
        per_qhead = kernel == "per_qhead"
        splits = 1 if per_qhead else 2   # 144 keys: 3 tiles, 2 + 1
        run = lambda mm: _paged_f32_emulated(  # noqa: E731
            q, k, v, pos, bt, qp, window, mm, per_qhead, splits)
    err = float((run(_mm3) - plain).abs().max())
    err1 = float((run(_mm1) - plain).abs().max())
    print(f"{kernel} hd {hd} window {window}: split TF32 max abs err "
          f"{err:.3g}, plain TF32 {err1:.3g} (tol {F32_ATOL})")
    assert err <= F32_ATOL, err
    assert err1 > F32_ATOL, err1
