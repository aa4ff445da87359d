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
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (flash_attention_plain,
                                               paged_prefill_plain)

KV, G, HD, PAGE = 8, 4, 64, 16


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
