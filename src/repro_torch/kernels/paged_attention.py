"""Split-K paged decode attention: the CUDA kernel's wrapper, its plain
torch version, and ``combine_splits``.

Both compute, for q (B, KV, G, hd) over the pool (N, page, KV, hd) walked
through the block table (B, P), the per-split UN-normalised partials
``acc`` (B, KV, S, G, hd), ``m`` and ``l`` (B, KV, S, G) of an online
softmax, and with ``return_scores`` the per-token norms ``kn``/``vn``
(B, KV, P, page) of every slot's page (page ``max(bt, 0)`` when unmapped).
A token is valid iff its slot is mapped, 0 <= pos <= cur_pos and, with a
window, pos > cur_pos - window; masked scores take -1e30. ``combine_splits``
merges the splits (plain torch, as in the JAX package).

The int8 variant reads a quantized pool (int8 K/V with (N, page, KV) f32
absmax scales) and dequantizes each element as ``x * (s / 127)``; its norm
tiles are those of the dequantized values.

The kernel source is ``csrc/paged_attention.cu``; it replaces the JAX
package's Pallas ``paged_attention_kernel`` and
``paged_attention_kernel_int8``. It takes the shapes of
:func:`decode_shape_check` (hd 32, 64, 80, 96 or 128, G <= 8, page <= 128)
over a pool
whose base and strides are whole chunks (:func:`chunk_aligned`); the
wrappers raise on anything else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import FLOAT, INT, LONG, PTR
from repro_torch.kernels.ref import gather_block_table

NEG_INF = -1e30


def split_grid(P: int, num_splits: int) -> tuple[int, int]:
    """(splits, pages per split) of a P-page walk."""
    S = max(1, min(int(num_splits), P))
    return S, -(-P // S)


def combine_splits(acc, m, l):
    """Reduce split partials to the attention output (B, KV, G, hd) f32.
    Empty splits (m == -1e30, l == 0) contribute exactly 0; a fully empty
    row divides 0 by the 1e-30 floor and gives zeros."""
    m_max = m.amax(2)
    coef = torch.exp(m - m_max[:, :, None])
    l_tot = (coef * l).sum(2)
    o = (coef[..., None] * acc).sum(2)
    return o / l_tot.clamp_min(1e-30)[..., None]


def paged_attention_plain(q, k_pool, v_pool, pos, block_table, cur_pos, *,
                          window: int = 0, scale: float | None = None,
                          num_splits: int = 1, return_scores: bool = False):
    """Plain torch version of the decode kernel: same inputs, same outputs
    ``(acc, m, l, (kn, vn) | None)``."""
    B, KV, G, hd = q.shape
    P = block_table.shape[1]
    page = pos.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    S, pps = split_grid(P, num_splits)
    kg, vg, pg = gather_block_table(k_pool, v_pool, pos, block_table)
    kf, vf = kg.float(), vg.float()                     # (B, KV, P, page, hd)
    s = torch.einsum("bkgd,bkpjd->bkgpj", q.float(), kf) * scale
    cur = cur_pos[:, None, None]
    valid = (pg >= 0) & (pg <= cur)
    if window > 0:
        valid &= pg > (cur - window)
    # pad the page axis to S * pps (padding pages are all-invalid)
    pad = S * pps - P
    s = torch.nn.functional.pad(s, (0, 0, 0, pad)).reshape(
        B, KV, G, S, pps * page)
    valid = torch.nn.functional.pad(valid, (0, 0, 0, pad)).reshape(
        B, 1, 1, S, pps * page)
    vs = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad)).reshape(
        B, KV, S, pps * page, hd)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)                                      # (B, KV, G, S)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgsj,bksjd->bksgd", p, vs)
    norms = None
    if return_scores:
        norms = (torch.linalg.vector_norm(kf, dim=-1),
                 torch.linalg.vector_norm(vf, dim=-1))
    return acc, m.permute(0, 1, 3, 2), l.permute(0, 1, 3, 2), norms


def dequantize(x, scale):
    """int8 values (..., hd) and their absmax scales (...,) -> f32, as the
    JAX package's ``k_dequant``: ``x * (scale / 127)``."""
    return x.float() * (scale / 127.0)[..., None]


def paged_attention_int8_plain(q, k_pool, v_pool, k_scale, v_scale, pos,
                               block_table, cur_pos, **kw):
    """Plain torch version of the int8 decode kernel: dequantize the pool,
    then :func:`paged_attention_plain`. k_pool/v_pool: (N, page, KV, hd)
    int8; k_scale/v_scale: (N, page, KV) f32."""
    return paged_attention_plain(q, dequantize(k_pool, k_scale),
                                 dequantize(v_pool, v_scale), pos,
                                 block_table, cur_pos, **kw)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# head dims the decode kernel is built for: every q / pool pair at 64 and
# 128; at the others a pool of q's own dtype or int8 (the pairs a model's
# own pool or an int8 one gives)
DECODE_HEAD_DIMS = (32, 64, 80, 96, 128)
DECODE_ANY_PAIR_HEAD_DIMS = (64, 128)


def decode_shape_check(q_dtype, pool_dtype, G: int, hd: int,
                       page: int) -> None:
    """What the decode kernel takes, a function of dtypes and shape only: a
    float32 or bfloat16 query over a float32, bfloat16 or int8 pool at head
    dim 64 or 128, or over a pool of its own dtype or int8 at head dim 32,
    80 or 96; 1 <= G <= 8 query heads per KV head, pages of at most 128
    tokens. Raises TypeError or ValueError on anything else: there is no
    other decode kernel to fall back to."""
    if q_dtype not in (torch.float32, torch.bfloat16) or \
            pool_dtype not in _DTYPES:
        raise TypeError(f"no decode kernel for a {q_dtype} query over a "
                        f"{pool_dtype} pool")
    if hd not in DECODE_HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head dim "
                         f"{', '.join(map(str, DECODE_HEAD_DIMS))}, not {hd}")
    if hd not in DECODE_ANY_PAIR_HEAD_DIMS and \
            pool_dtype not in (q_dtype, torch.int8):
        raise ValueError(f"at head dim {hd} the decode kernel takes a pool "
                         f"of the query's dtype or int8, not a {pool_dtype} "
                         f"pool under a {q_dtype} query")
    if not 1 <= G <= 8:
        raise ValueError(f"the decode kernel takes 1 to 8 query heads per KV "
                         f"head, not {G}")
    if not 1 <= page <= 128:
        raise ValueError(f"the decode kernel takes pages of 1 to 128 tokens, "
                         f"not {page}")


def chunk_aligned(pool) -> None:
    """The decode kernel copies one chunk per lane (16 bytes of an f32 or
    bf16 row, 8 of an int8 row): the pool's base must be aligned to it and
    its strides whole chunks. Raises ValueError otherwise."""
    chunk = 8 if pool.dtype == torch.int8 else 16
    if pool.data_ptr() % chunk:
        raise ValueError(f"the pool is not {chunk}-byte aligned")
    if any(st * pool.element_size() % chunk for st in pool.stride()[:3]):
        raise ValueError(f"pool strides {pool.stride()} are not multiples "
                         f"of {chunk} bytes")


def _check_pool(q, k_pool, v_pool, pos, block_table, scales=None):
    """Validate what the paged kernels (decode and prefill) take; raise on
    anything else. q is f32 or bf16; the pool f32 or bf16 (either, whatever
    q is), or int8 when ``scales`` (k_scale, v_scale) are given."""
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("pos", pos), ("block_table", block_table)]
    if scales is not None:
        tensors += [("k_scale", scales[0]), ("v_scale", scales[1])]
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    pool_types = (torch.int8,) if scales is not None else \
        (torch.float32, torch.bfloat16)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype not in pool_types or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"q / pool dtypes {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}: q is float32 or bfloat16, the "
                        f"pool {' or '.join(map(str, pool_types))}")
    if scales is not None:
        N, page, KV = k_pool.shape[:3]
        for sc in scales:
            if sc.dtype != torch.float32 or not sc.is_contiguous() or \
                    sc.shape != (N, page, KV):
                raise ValueError("scales must be contiguous float32 "
                                 "(N, page, KV)")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(-1) != 1:
        raise ValueError("k_pool / v_pool need equal strides and a "
                         "contiguous head dim")
    if pos.dtype != torch.int32 or not pos.is_contiguous() or \
            block_table.dtype != torch.int32 or \
            not block_table.is_contiguous():
        raise ValueError("pos and block_table must be contiguous int32")
    if k_pool.shape[1] > 128:
        raise ValueError("page size above 128 is not supported")


def _check_decode(q, k_pool, v_pool):
    """What the decode kernel adds to :func:`_check_pool`: q (B, KV, G, hd)
    matching the pool, :func:`decode_shape_check` and chunk alignment."""
    B, KV, G, hd = q.shape
    decode_shape_check(q.dtype, k_pool.dtype, G, hd, k_pool.shape[1])
    if k_pool.shape[2:] != (KV, hd):
        raise ValueError(f"q {tuple(q.shape)} does not match the pool "
                         f"{tuple(k_pool.shape)}")
    chunk_aligned(k_pool)
    chunk_aligned(v_pool)


def paged_attention_cuda(q, k_pool, v_pool, pos, block_table, cur_pos, *,
                         window: int = 0, scale: float | None = None,
                         num_splits: int = 1, return_scores: bool = False):
    """Launch the CUDA decode kernel; same contract as
    :func:`paged_attention_plain`. Raises on CPU tensors, on what
    :func:`decode_shape_check` refuses, or on a failed launch.
    ``paged_attention_cuda.launches`` counts the launches."""
    _check_pool(q, k_pool, v_pool, pos, block_table)
    _check_decode(q, k_pool, v_pool)
    out = _launch(q, k_pool, v_pool, None, pos, block_table, cur_pos,
                  window, scale, num_splits, return_scores)
    paged_attention_cuda.launches += 1
    return out


def paged_attention_int8_cuda(q, k_pool, v_pool, k_scale, v_scale, pos,
                              block_table, cur_pos, *, window: int = 0,
                              scale: float | None = None, num_splits: int = 1,
                              return_scores: bool = False):
    """Launch the CUDA decode kernel on an int8 pool; same contract as
    :func:`paged_attention_int8_plain`. Raises on CPU tensors, on what
    :func:`decode_shape_check` refuses, or on a failed launch.
    ``paged_attention_int8_cuda.launches`` counts the launches."""
    _check_pool(q, k_pool, v_pool, pos, block_table, (k_scale, v_scale))
    _check_decode(q, k_pool, v_pool)
    out = _launch(q, k_pool, v_pool, (k_scale, v_scale), pos, block_table,
                  cur_pos, window, scale, num_splits, return_scores)
    paged_attention_int8_cuda.launches += 1
    return out


_SIGNATURES = {"paged_decode": [PTR] * 13 + [INT] * 6 + [LONG] * 3 +
               [INT] * 3 + [FLOAT, INT, INT, PTR]}


def _launch(q, k_pool, v_pool, scales, pos, block_table, cur_pos, window,
            scale, num_splits, return_scores):
    q = q.contiguous()
    cur_pos = cur_pos.to(torch.int32).contiguous()
    B, KV, G, hd = q.shape
    N, page = pos.shape
    P = block_table.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    S, pps = split_grid(P, num_splits)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KV, S, G, hd), **f32)
    m = torch.empty((B, KV, S, G), **f32)
    l = torch.empty((B, KV, S, G), **f32)
    kn = vn = None
    if return_scores:
        kn = torch.empty((B, KV, P, page), **f32)
        vn = torch.empty((B, KV, P, page), **f32)
    lib = build.load("paged_attention", _SIGNATURES)
    ptr = lambda t: t.data_ptr() if t is not None else None
    ks, vs = scales if scales is not None else (None, None)
    sn, sp, skv, _ = k_pool.stride()
    rc = lib.paged_decode(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(ks), ptr(vs), ptr(pos),
        ptr(block_table), ptr(cur_pos), ptr(acc), ptr(m), ptr(l), ptr(kn),
        ptr(vn), B, KV, G, hd, P, page, sn, sp, skv, S, pps, int(window),
        float(scale), _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "paged_decode")
    return acc, m, l, ((kn, vn) if return_scores else None)


paged_attention_cuda.launches = 0
paged_attention_int8_cuda.launches = 0
