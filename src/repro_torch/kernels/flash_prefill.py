"""G-fold paged chunked-prefill attention: the CUDA kernel's wrapper and
its plain torch version.

Both compute, for a chunk q (B, T, H, hd) with positions q_pos (B, T)
(-1 == padding query) over the pool (N, page, KV, hd) walked through the
block table (B, P), the attention output (B, T, H, hd) in q's dtype, and
with ``return_scores`` the per-token norms ``kn``/``vn`` (B, KV, P, page).
A (query, key) pair is valid iff the slot is mapped, kpos >= 0, qpos >= 0,
kpos <= qpos and, with a window, kpos > qpos - window; rows with no valid
key give zeros. The chunk's own K/V must already be in the pool.

The kernel source is ``csrc/flash_prefill.cu``; it replaces the JAX
package's Pallas ``paged_flash_prefill_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import _DTYPES, NEG_INF, _check_pool
from repro_torch.kernels.ref import gather_block_table


def paged_prefill_plain(q, k_pool, v_pool, pos, block_table, q_pos, *,
                        window: int = 0, scale: float | None = None,
                        return_scores: bool = False):
    """Plain torch version of the prefill kernel: same inputs, same outputs
    ``(out, (kn, vn) | None)``."""
    B, T, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    kg, vg, pg = gather_block_table(k_pool, v_pool, pos, block_table)
    KV, P, page = kg.shape[1], kg.shape[2], kg.shape[3]
    G = H // KV
    kf, vf = kg.float(), vg.float()                     # (B, KV, P, page, hd)
    qg = q.reshape(B, T, KV, G, hd).float()
    s = torch.einsum("btkgd,bkpjd->bkgtpj", qg, kf).reshape(
        B, KV, G, T, P * page) * scale
    kp = pg.reshape(B, 1, P * page)
    qp = q_pos[:, :, None]
    valid = (kp >= 0) & (qp >= 0) & (kp <= qp)           # (B, T, P * page)
    if window > 0:
        valid &= kp > (qp - window)
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = (p @ vf.reshape(B, KV, 1, P * page, hd)) / l.clamp_min(1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)
    norms = None
    if return_scores:
        norms = (torch.linalg.vector_norm(kf, dim=-1),
                 torch.linalg.vector_norm(vf, dim=-1))
    return out, norms


def tile_rows(hd: int) -> int:
    """Folded query rows one block holds (2048 f32 of q and of acc)."""
    return max(8, min(32, 2048 // hd))


def paged_prefill_cuda(q, k_pool, v_pool, pos, block_table, q_pos, *,
                       window: int = 0, scale: float | None = None,
                       return_scores: bool = False):
    """Launch the CUDA prefill kernel; same contract as
    :func:`paged_prefill_plain`. Raises on CPU tensors or a failed launch.
    ``paged_prefill_cuda.launches`` counts the launches."""
    _check_pool(q, k_pool, v_pool, pos, block_table)
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    B, T, H, hd = q.shape
    N, page = pos.shape
    KV = k_pool.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not fold over {KV} KV heads")
    G = H // KV
    P = block_table.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    kn = vn = None
    if return_scores:
        kn = torch.empty((B, KV, P, page), dtype=torch.float32,
                         device=q.device)
        vn = torch.empty_like(kn)
    lib = build.load("flash_prefill")
    fn = lib.paged_prefill
    vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn.argtypes = [vp] * 9 + [ci] * 7 + [cl] * 3 + [ci] * 2 + [cf, ci, vp]
    fn.restype = ci
    ptr = lambda t: t.data_ptr() if t is not None else None
    sn, sp, skv, _ = k_pool.stride()
    rc = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(pos), ptr(block_table),
            ptr(q_pos), ptr(out), ptr(kn), ptr(vn), B, T, KV, G, hd, P, page,
            sn, sp, skv, tile_rows(hd), int(window), float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "paged_prefill")
    paged_prefill_cuda.launches += 1
    return out, ((kn, vn) if return_scores else None)


paged_prefill_cuda.launches = 0
