"""Page scoring of the paper's Alg.1 (block mode) over the physical pool:
the CUDA kernel's wrapper and its plain torch version.

Both compute, for the pool k, v (N, page, KV, hd) and positions pos
(N, page), the (N,) f32 mean over each page's valid tokens (pos >= 0) of
``mean_h ||v|| / max(mean_h ||k||, 1e-6)``, and +inf for an empty page.
This pass is off the hot paths: the attention kernels emit the same norms
as a fused epilogue. It is their oracle (``ops.page_scores``).

The kernel source is ``csrc/block_score.cu``; it replaces the JAX package's
Pallas ``block_score_kernel``. The same library holds an empty kernel whose
launch (:func:`launch_floor_cuda`) measures the fixed cost of a launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import INT, LONG, PTR
from repro_torch.kernels.paged_attention import _DTYPES, chunk_aligned
from repro_torch.kernels.ref import block_score_ref


def block_score_plain(k_pool, v_pool, pos):
    """Plain torch version of the kernel: (N,) f32 page scores."""
    return block_score_ref(k_pool, v_pool, pos)


# head dims taken whatever their chunk count (padded to a power of two of
# lanes): TINY's 32, stablelm-3b's 80 and the reduced configs' 96
PADDED_HEAD_DIMS = (32, 80, 96)


def block_score_shape_check(dtype, page: int, KV: int, hd: int) -> None:
    """What the kernel takes, a function of dtype and shape only: a float32
    or bfloat16 pool (int8 is dequantized first), a head dim of whole
    16-byte chunks whose chunk count is a power of two up to 32 (f32: hd 4
    to 128; bf16: hd 8 to 256) or hd 32, 80 or 96 (their chunks padded to a
    power of two of lanes), and page * (KV + 1) <= 4096 (each token's head
    norms staged in shared memory). Raises TypeError or ValueError on
    anything else: there is no other page-score kernel to fall back to."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"no page-score kernel for a {dtype} pool "
                        f"(dequantize int8 first)")
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = hd // per_chunk
    pow2 = 1 <= lanes <= 32 and not lanes & (lanes - 1)
    if hd % per_chunk or not (pow2 or hd in PADDED_HEAD_DIMS):
        raise ValueError(f"the page-score kernel takes a head dim of 1, 2, "
                         f"4, ..., 32 chunks of {per_chunk} {dtype} values, "
                         f"or {', '.join(map(str, PADDED_HEAD_DIMS))}, not "
                         f"{hd}")
    if page < 1 or KV < 1 or page * (KV + 1) > 4096:
        raise ValueError(f"the page-score kernel takes page * (KV + 1) <= "
                         f"4096, not {page} * {KV + 1}")


def block_score_cuda(k_pool, v_pool, pos):
    """Launch the CUDA page-score kernel; same contract as
    :func:`block_score_plain`. Raises on CPU tensors, a shape or layout the
    kernel does not take (:func:`block_score_shape_check`, 16-byte aligned
    chunks) or a failed launch. ``block_score_cuda.launches`` counts the
    launches."""
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("pos", pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}, {v_pool.dtype} differ")
    N, page, KV, hd = k_pool.shape
    block_score_shape_check(k_pool.dtype, page, KV, hd)
    if k_pool.stride() != v_pool.stride() or k_pool.stride(-1) != 1:
        raise ValueError("k_pool / v_pool need equal strides and a "
                         "contiguous head dim")
    chunk_aligned(k_pool)
    chunk_aligned(v_pool)
    if pos.dtype != torch.int32 or not pos.is_contiguous() or \
            pos.shape != (N, page):
        raise ValueError("pos must be contiguous int32 of shape (N, page)")
    out = torch.empty((N,), dtype=torch.float32, device=k_pool.device)
    lib = build.load("block_score", _SIGNATURES)
    sn, sp, skv, _ = k_pool.stride()
    rc = lib.block_score(k_pool.data_ptr(), v_pool.data_ptr(), pos.data_ptr(),
            out.data_ptr(), N, page, KV, hd, sn, sp, skv,
            _DTYPES[k_pool.dtype],
            torch.cuda.current_stream(k_pool.device).cuda_stream)
    build.check(lib, rc, "block_score")
    block_score_cuda.launches += 1
    return out


def launch_floor_cuda(out):
    """Launch the library's empty kernel (one block, one write to ``out[0]``,
    an f32 CUDA tensor): its time is the fixed cost of any launch, beside
    which the kernels' times are read. Not a kernel of any path."""
    if not out.is_cuda or out.dtype != torch.float32:
        raise ValueError("out must be a float32 CUDA tensor")
    lib = build.load("block_score", _SIGNATURES)
    rc = lib.empty_launch(out.data_ptr(),
                          torch.cuda.current_stream(out.device).cuda_stream)
    build.check(lib, rc, "empty_launch")


_SIGNATURES = {"block_score": [PTR] * 4 + [INT] * 4 + [LONG] * 3 +
               [INT, PTR],
               "empty_launch": [PTR, PTR]}
block_score_cuda.launches = 0
