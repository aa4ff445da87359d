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
is f32 or bf16 whatever q is, or int8 with its (N, page, KV) f32 absmax
scales (:func:`paged_prefill_int8_plain`; the CUDA wrapper takes them as
``k_scale`` / ``v_scale`` and reads the int8 values natively).
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

**Routes.** Each CUDA wrapper picks its route from dtypes and head dim
alone (:func:`prefill_route`, :func:`flash_route`). At hd 32, 64, 80, 96 or
128 every route runs on the tensor cores: bf16 throughout, or a bf16 query
over an int8 pool, in bf16 (``attn_tile.cuh``); an f32 query (over any
pool, int8 included) or a bf16 query over an f32 pool in split TF32
(``attn_tile_f32.cuh``: three TF32 products per f32 product, f32
accuracy). At other head dims an f32 query or a bf16 query over an f32
pool runs on the CUDA cores; anything else raises. The bf16 tensor-core
routes round each probability to bf16 before P V, so they are held to the
plain version within :func:`repro_torch.kernels.ref.tc_bf16_bound`, not
one bf16 rounding step; the split-TF32 routes to the f32 tolerance.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import FLOAT, INT, LONG, PTR
from repro_torch.kernels.paged_attention import (_DTYPES, NEG_INF,
                                                 _check_pool, dequantize)
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


def paged_prefill_int8_plain(q, k_pool, v_pool, k_scale, v_scale, pos,
                             block_table, q_pos, **kw):
    """Plain torch version of the prefill kernel on an int8 pool:
    dequantize (``x * (s / 127)``), then :func:`paged_prefill_plain`, as the
    JAX package's ``paged_prefill_attention`` does. k_pool / v_pool:
    (N, page, KV, hd) int8; k_scale / v_scale: (N, page, KV) f32."""
    return paged_prefill_plain(q, dequantize(k_pool, k_scale),
                               dequantize(v_pool, v_scale), pos,
                               block_table, q_pos, **kw)


TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
INT8_TENSOR_CORE, INT8_CUDA_CORE = "int8_tensor_core", "int8_cuda_core"
F32_TENSOR_CORE = "f32_tensor_core"
INT8_F32_TENSOR_CORE = "int8_f32_tensor_core"
PREFILL_ROUTES = (TENSOR_CORE, CUDA_CORE, INT8_TENSOR_CORE, INT8_CUDA_CORE,
                  F32_TENSOR_CORE, INT8_F32_TENSOR_CORE)
FLASH_ROUTES = (TENSOR_CORE, F32_TENSOR_CORE, CUDA_CORE)
# head dims the tensor-core tiles are built for (whole 16-column mma steps)
TC_HEAD_DIMS = (32, 64, 80, 96, 128)


def _tc_head_dim(what: str, hd: int) -> None:
    if hd not in TC_HEAD_DIMS:
        raise ValueError(f"{what} needs head dim "
                         f"{', '.join(map(str, TC_HEAD_DIMS))} (tensor-core "
                         f"route), not {hd}")


def prefill_route(q_dtype, pool_dtype, hd: int) -> str:
    """The prefill kernel's route, a function of dtypes and head dim only:

    - a bf16 query over a bf16 pool at hd 32, 64, 80, 96 or 128:
      ``"tensor_core"``
      (mma.sync on 64-row tiles, key tiles gathered by cp.async);
    - a bf16 query over an int8 pool at those head dims:
      ``"int8_tensor_core"`` (the same tiles; int8 pages copied in as int8
      and widened to bf16 in shared memory, exactly; the per-key scales
      applied to the scores and folded into the probabilities in f32);
    - an f32 query over an f32 or bf16 pool, or a bf16 query over an f32
      pool (widened exactly), at those head dims: ``"f32_tensor_core"``
      (split TF32 on 128-row tiles: every f32 product as three TF32
      products, f32 accuracy; rounding the f32 pool to bf16 would move the
      scores far beyond a one-rounding tolerance);
    - an f32 query over an int8 pool at those head dims:
      ``"int8_f32_tensor_core"`` (the same tiles; int8 pages widened to f32
      in shared memory as ``x * (s / 127)``, bit for bit the values of
      :func:`dequantize`);
    - at any other head dim, an f32 query over an int8 pool:
      ``"int8_cuda_core"`` (the CUDA-core page walk dequantizing each value
      in registers); an f32 query over an f32 or bf16 pool, or a bf16 query
      over an f32 pool: ``"cuda_core"`` (f32 products on the CUDA cores);
    - anything else raises (a bf16 query over a bf16 or int8 pool at
      another hd included): no route falls back to another."""
    floats = (torch.float32, torch.bfloat16)
    tc = hd in TC_HEAD_DIMS
    if q_dtype == torch.bfloat16 and pool_dtype == torch.bfloat16:
        _tc_head_dim("a bf16 query over a bf16 pool", hd)
        return TENSOR_CORE
    if q_dtype == torch.bfloat16 and pool_dtype == torch.int8:
        _tc_head_dim("a bf16 query over an int8 pool", hd)
        return INT8_TENSOR_CORE
    if q_dtype == torch.float32 and pool_dtype == torch.int8:
        return INT8_F32_TENSOR_CORE if tc else INT8_CUDA_CORE
    if q_dtype in floats and pool_dtype in floats:
        return F32_TENSOR_CORE if tc else CUDA_CORE
    raise TypeError(f"no prefill route for a {q_dtype} query over a "
                    f"{pool_dtype} pool")


# rows one block of the f32 tensor-core routes holds, and keys per key tile
# (csrc/flash_prefill.cu's kRowsF and attn_tile.cuh's kKeys)
F32_TC_ROWS, KEY_TILE = 128, 64


def prefill_splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Key-range splits of the f32 tensor-core prefill: 1 when the grid of
    ``blocks`` row tiles already holds four blocks per SM, else enough
    splits to reach that, at most one per two key tiles and 8 (each split
    writes its rows' partial state, merged by a second kernel), then as few
    as cover the key tiles at that many tiles per split."""
    if blocks >= 4 * sms:
        return 1
    n = max(1, min(-(-4 * sms // blocks), key_tiles // 2, 8))
    return -(-key_tiles // -(-key_tiles // n))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_rows(hd: int) -> int:
    """Folded query rows one block of the CUDA-core route holds (2048 f32
    of q and of acc)."""
    return max(8, min(32, 2048 // hd))


def _check_16b(**tensors) -> None:
    """What the tensor-core routes' 16-byte copies need: 16-byte aligned
    bases and, for the pool, strides of whole 16 bytes (multiples of 8
    elements of a bf16 pool, of 16 of an int8 one)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        per = 16 // t.element_size()
        if name.endswith("pool") and any(st % per for st in t.stride()[:3]):
            raise ValueError(f"{name} strides {t.stride()} are not "
                             f"multiples of {per} elements")


def paged_prefill_cuda(q, k_pool, v_pool, pos, block_table, q_pos, *,
                       k_scale=None, v_scale=None, window: int = 0,
                       scale: float | None = None,
                       return_scores: bool = False, per_qhead: bool = False):
    """Launch the CUDA prefill kernel (the per-Q-head one when
    ``per_qhead``) on the route :func:`prefill_route` picks; same contract
    as :func:`paged_prefill_plain`, or, over an int8 pool with its
    ``k_scale`` / ``v_scale``, as :func:`paged_prefill_int8_plain` (the
    kernel reads the int8 values and scales; nothing is dequantized
    first). Raises on an input that requires grad under autograd, on CPU
    tensors, on what no route takes, or on a failed launch. The
    tensor-core fold orders its rows g * T + t, the JAX package's order (a
    token-major order measured no faster at the mixed step, PERF.md §6).
    Launch counts: ``paged_prefill_cuda.launches`` (G-fold),
    ``.per_qhead_launches``, and per route over both grids
    ``.tensor_core_launches``, ``.cuda_core_launches``,
    ``.int8_tensor_core_launches``, ``.int8_cuda_core_launches``,
    ``.f32_tensor_core_launches`` and ``.int8_f32_tensor_core_launches``.
    The f32 tensor-core routes split each block's key range when the grid
    is small (:func:`prefill_splits`); ``.splits`` is the last launch's
    count."""
    build.refuse_autograd("paged_prefill", q, k_pool, v_pool, k_scale,
                          v_scale)
    if per_qhead and return_scores:
        raise ValueError("the per-Q-head kernel has no score epilogue")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 pool needs both k_scale and v_scale")
    scales = None if k_scale is None else (k_scale, v_scale)
    _check_pool(q, k_pool, v_pool, pos, block_table, scales)
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    B, T, H, hd = q.shape
    N, page = pos.shape
    KV = k_pool.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not fold over {KV} KV heads")
    route = prefill_route(q.dtype, k_pool.dtype, hd)
    G = H // KV
    P = block_table.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    kn = vn = None
    if return_scores:
        kn = torch.empty((B, KV, P, page), dtype=torch.float32,
                         device=q.device)
        vn = torch.empty_like(kn)
    lib = build.load("flash_prefill", _PREFILL_SIGNATURES)
    ptr = lambda t: t.data_ptr() if t is not None else None
    sn, sp, skv, _ = k_pool.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale),
            ptr(pos), ptr(block_table), ptr(q_pos), ptr(out), ptr(kn),
            ptr(vn), B, T, KV, G, hd, P, page, sn, sp, skv)
    if route in (TENSOR_CORE, INT8_TENSOR_CORE):
        _check_16b(q=q, k_pool=k_pool, v_pool=v_pool)
        rc = lib.paged_prefill_tc(*head, int(window), float(scale),
                                  _DTYPES[k_pool.dtype], int(per_qhead),
                                  stream)
    elif route in (F32_TENSOR_CORE, INT8_F32_TENSOR_CORE):
        _check_16b(q=q, k_pool=k_pool, v_pool=v_pool)
        rows = T if per_qhead else G * T
        blocks = -(-rows // F32_TC_ROWS) * (H if per_qhead else KV) * B
        nsplit = prefill_splits(blocks, -(-P * page // KEY_TILE),
                                _sm_count(q.device.index))
        part = None
        if nsplit > 1:
            part = torch.empty(nsplit * B * H * T * (hd + 2),
                               dtype=torch.float32, device=q.device)
        rc = lib.paged_prefill_f32tc(
            *head, int(window), float(scale), _DTYPES[q.dtype],
            _DTYPES[k_pool.dtype], int(per_qhead), ptr(part), nsplit, stream)
        paged_prefill_cuda.splits = nsplit
    else:
        rc = lib.paged_prefill(*head, tile_rows(hd), int(window),
                               float(scale), _DTYPES[q.dtype],
                               _DTYPES[k_pool.dtype], int(per_qhead), stream)
    build.check(lib, rc, "paged_prefill")
    if per_qhead:
        paged_prefill_cuda.per_qhead_launches += 1
    else:
        paged_prefill_cuda.launches += 1
    setattr(paged_prefill_cuda, f"{route}_launches",
            getattr(paged_prefill_cuda, f"{route}_launches") + 1)
    return out, ((kn, vn) if return_scores else None)


_PREFILL_SIGNATURES = {
    "paged_prefill_tc": [PTR] * 11 + [INT] * 7 + [LONG] * 3 +
    [INT, FLOAT, INT, INT, PTR],
    "paged_prefill_f32tc": [PTR] * 11 + [INT] * 7 + [LONG] * 3 +
    [INT, FLOAT, INT, INT, INT, PTR, INT, PTR],
    "paged_prefill": [PTR] * 11 + [INT] * 7 + [LONG] * 3 + [INT] * 2 +
    [FLOAT, INT, INT, INT, PTR]}
paged_prefill_cuda.launches = 0
paged_prefill_cuda.per_qhead_launches = 0
paged_prefill_cuda.tensor_core_launches = 0
paged_prefill_cuda.cuda_core_launches = 0
paged_prefill_cuda.int8_tensor_core_launches = 0
paged_prefill_cuda.int8_cuda_core_launches = 0
paged_prefill_cuda.f32_tensor_core_launches = 0
paged_prefill_cuda.int8_f32_tensor_core_launches = 0
paged_prefill_cuda.splits = 0


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


def flash_route(dtype, hd: int) -> str:
    """The flash kernel's route, a function of dtype and head dim only: bf16
    at hd 32, 64, 80, 96 or 128 takes ``"tensor_core"`` (mma.sync on 128-row
    tiles, cp.async K/V ring); f32 at those head dims ``"f32_tensor_core"``
    (the same tiles in split TF32), at any other hd <= 128 ``"cuda_core"``;
    anything else raises, with no fallback from one route to another."""
    if dtype == torch.bfloat16:
        if hd in TC_HEAD_DIMS:
            return TENSOR_CORE
        raise ValueError(f"bf16 flash attention needs head dim "
                         f"{', '.join(map(str, TC_HEAD_DIMS))} (tensor-core "
                         f"route), not {hd}")
    if dtype == torch.float32:
        if hd in TC_HEAD_DIMS:
            return F32_TENSOR_CORE
        if hd <= 128:
            return CUDA_CORE
        raise ValueError(f"head dim {hd} above 128 is not supported")
    raise TypeError(f"no flash attention route for {dtype}")


def flash_attention_cuda(q, k, v, *, window: int = 0,
                         scale: float | None = None):
    """Launch the CUDA flash attention kernel on the route
    :func:`flash_route` picks; same contract as
    :func:`flash_attention_plain`. Raises on an input that
    requires grad under autograd, on CPU tensors, on what no route
    takes, or on a failed launch. ``flash_attention_cuda.launches`` counts
    the launches, ``.tensor_core_launches``, ``.f32_tensor_core_launches``
    and ``.cuda_core_launches`` those of each route."""
    build.refuse_autograd("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q / k / v dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                        f"differ")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form GQA attention")
    route = flash_route(q.dtype, hd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if route != CUDA_CORE:
        _check_16b(q=q, k=k, v=v)
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    lib = build.load("flash_attention", _FLASH_SIGNATURES)
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, S, H, KV, hd, int(window),
                             float(scale), _DTYPES[q.dtype],
                             int(route != CUDA_CORE),
                             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention_cuda.launches += 1
    setattr(flash_attention_cuda, f"{route}_launches",
            getattr(flash_attention_cuda, f"{route}_launches") + 1)
    return out


_FLASH_SIGNATURES = {"flash_attention": [PTR] * 4 + [INT] * 6 +
                     [FLOAT, INT, INT, PTR]}
flash_attention_cuda.launches = 0
flash_attention_cuda.tensor_core_launches = 0
flash_attention_cuda.f32_tensor_core_launches = 0
flash_attention_cuda.cuda_core_launches = 0
