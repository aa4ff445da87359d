"""The prefill attention kernels: G-fold paged chunked prefill (and its
per-Q-head variant) and contiguous causal flash attention, each with its
CUDA wrapper and plain torch version.

**Paged chunked prefill.**
Both compute, for a chunk q (B, T, H, hd) with positions q_pos (B, T)
(-1 == padding query) over the pool (N, page, KV, hd) walked through the
block table (B, P), the attention output (B, T, H, hd) in q's dtype, and
with ``return_scores`` the per-token norms ``kn``/``vn`` (B, KV, P, page).
A (query, key) pair is valid iff the slot is mapped, kpos >= 0, qpos >= 0,
kpos <= qpos and, with a window, kpos > qpos - window; rows with no valid
key give zeros. The chunk's own K/V must already be in the pool. The pool
is f32 or bf16 whatever q is (an int8 pool is dequantized first).
``per_qhead=True`` runs the per-Q-head grid, bit-equal to the fold, with
no norms. The kernel source is ``csrc/flash_prefill.cu``; it replaces the
JAX package's Pallas ``paged_flash_prefill_kernel`` and
``paged_flash_prefill_kernel_per_qhead``.

**Flash attention.** For contiguous q (B, S, H, hd) and k, v (B, S, KV, hd)
(H = G * KV), causal GQA attention, causal by index: query i sees key j
iff j <= i and, with a window, j > i - window (positions are not read; a
right-padded prompt's valid queries never see its padding). Masked scores
take -1e30 and the output is acc / max(l, 1e-30), in q's dtype. The kernel
source is ``csrc/flash_attention.cu``; it replaces the JAX package's Pallas
``flash_attention_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import _DTYPES, NEG_INF, _check_pool
from repro_torch.kernels.ref import flash_attention_ref, gather_block_table


def paged_prefill_plain(q, k_pool, v_pool, pos, block_table, q_pos, *,
                        window: int = 0, scale: float | None = None,
                        return_scores: bool = False, per_qhead: bool = False):
    """Plain torch version of the prefill kernel: same inputs, same outputs
    ``(out, (kn, vn) | None)``. The per-Q-head grid computes the same
    function (``per_qhead`` only refuses scores, as the kernel does)."""
    if per_qhead and return_scores:
        raise ValueError("the per-Q-head kernel has no score epilogue")
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
                       return_scores: bool = False, per_qhead: bool = False):
    """Launch the CUDA prefill kernel (the per-Q-head one when
    ``per_qhead``); same contract as :func:`paged_prefill_plain`. Raises on
    CPU tensors or a failed launch. ``paged_prefill_cuda.launches`` counts
    the G-fold launches, ``.per_qhead_launches`` the per-Q-head ones."""
    if per_qhead and return_scores:
        raise ValueError("the per-Q-head kernel has no score epilogue")
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
    fn.argtypes = [vp] * 9 + [ci] * 7 + [cl] * 3 + [ci] * 2 + \
        [cf, ci, ci, ci, vp]
    fn.restype = ci
    ptr = lambda t: t.data_ptr() if t is not None else None
    sn, sp, skv, _ = k_pool.stride()
    rc = fn(ptr(q), ptr(k_pool), ptr(v_pool), ptr(pos), ptr(block_table),
            ptr(q_pos), ptr(out), ptr(kn), ptr(vn), B, T, KV, G, hd, P, page,
            sn, sp, skv, tile_rows(hd), int(window), float(scale),
            _DTYPES[q.dtype], _DTYPES[k_pool.dtype], int(per_qhead),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "paged_prefill")
    if per_qhead:
        paged_prefill_cuda.per_qhead_launches += 1
    else:
        paged_prefill_cuda.launches += 1
    return out, ((kn, vn) if return_scores else None)


paged_prefill_cuda.launches = 0
paged_prefill_cuda.per_qhead_launches = 0


# ---------------------------------------------------------------------------
# contiguous causal flash attention
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, window: int = 0,
                          scale: float | None = None):
    """Plain torch version of the flash attention kernel: the dense oracle
    (it holds the (S, S) scores of every head at once). Every query sees at
    least its own key, so the kernel's -1e30 mask and 1e-30 floor never
    act and a plain softmax computes the same function."""
    return flash_attention_ref(q, k, v, window=window, scale=scale)


def flash_attention_cuda(q, k, v, *, window: int = 0,
                         scale: float | None = None):
    """Launch the CUDA flash attention kernel; same contract as
    :func:`flash_attention_plain`. Raises on CPU tensors or a failed launch.
    ``flash_attention_cuda.launches`` counts the launches."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q / k / v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"the kernel takes float32 or bfloat16, all alike")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form GQA attention")
    if hd > 128:
        raise ValueError(f"head dim {hd} above 128 is not supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 4 + [ci] * 6 + [cf, ci, vp]
    fn.restype = ci
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, KV, hd, int(window), float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
