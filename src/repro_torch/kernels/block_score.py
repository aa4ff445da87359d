"""Page scoring of the paper's Alg.1 (block mode) over the physical pool:
the CUDA kernel's wrapper and its plain torch version.

Both compute, for the pool k, v (N, page, KV, hd) and positions pos
(N, page), the (N,) f32 mean over each page's valid tokens (pos >= 0) of
``mean_h ||v|| / max(mean_h ||k||, 1e-6)``, and +inf for an empty page.
This pass is off the hot paths: the attention kernels emit the same norms
as a fused epilogue. It is their oracle (``ops.page_scores``).

The kernel source is ``csrc/block_score.cu``; it replaces the JAX package's
Pallas ``block_score_kernel``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import INT, LONG, PTR
from repro_torch.kernels.paged_attention import _DTYPES
from repro_torch.kernels.ref import block_score_ref


def block_score_plain(k_pool, v_pool, pos):
    """Plain torch version of the kernel: (N,) f32 page scores."""
    return block_score_ref(k_pool, v_pool, pos)


def block_score_cuda(k_pool, v_pool, pos):
    """Launch the CUDA page-score kernel; same contract as
    :func:`block_score_plain`. Raises on CPU tensors or a failed launch.
    ``block_score_cuda.launches`` counts the launches."""
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("pos", pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor")
    if k_pool.dtype not in (torch.float32, torch.bfloat16) or \
            v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}, {v_pool.dtype}: the "
                        f"kernel takes float32 or bfloat16 (dequantize int8)")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(-1) != 1:
        raise ValueError("k_pool / v_pool need equal strides and a "
                         "contiguous head dim")
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError("pos must be contiguous int32")
    N, page, KV, hd = k_pool.shape
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


_SIGNATURES = {"block_score": [PTR] * 4 + [INT] * 4 + [LONG] * 3 +
               [INT, PTR]}
block_score_cuda.launches = 0
