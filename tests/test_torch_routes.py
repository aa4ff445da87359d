"""The route rules of the prefill and flash attention wrappers and the
decode kernel's shape rule, on the CPU.

A route is a function of dtypes and head dim alone, written down in the
wrappers (``prefill_route``, ``flash_route``): bf16 throughout at hd 32, 64,
80, 96 or 128 runs on the tensor cores; an f32 query, or a bf16 query over an f32
pool (the dequantized int8 pool), on the CUDA cores; anything else raises.
No route falls back to the other. The tensor-core route's 16-byte copies
need aligned bases and pool strides in multiples of 8 elements, which the
wrappers check and refuse otherwise.

The decode kernel (``decode_shape_check``) takes an f32 or bf16 query over
an f32, bf16 or int8 pool at head dim 64 or 128, over a pool of its own
dtype or int8 at head dim 32, 80 or 96, 1 <= G <= 8 and pages of at most 128
tokens, and a pool whose base and strides are whole 16-byte (f32,
bf16) or 8-byte (int8) chunks; the rest raises.

The page-score kernel (``block_score_shape_check``) takes an f32 or bf16
pool whose head dim is 1, 2, 4, ..., 32 whole 16-byte chunks, or 32, 80 or
96, and page * (KV + 1) <= 4096; the rest raises. Every refusal of a head
dim names the head dims taken.
"""
import pytest
import torch

from repro_torch.kernels import block_score as bs
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import paged_attention as pa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("hd", [32, 64, 80, 96, 128])
def test_prefill_bf16_pair_takes_tensor_cores(hd):
    assert fp.prefill_route(BF16, BF16, hd) == fp.TENSOR_CORE


@pytest.mark.parametrize("q_dtype,pool_dtype", [(F32, F32), (F32, BF16),
                                                (BF16, F32)])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 96, 128])
def test_prefill_f32_and_bf16_over_f32_take_cuda_cores(q_dtype, pool_dtype,
                                                       hd):
    assert fp.prefill_route(q_dtype, pool_dtype, hd) == fp.CUDA_CORE


@pytest.mark.parametrize("q_dtype,pool_dtype,hd,exc", [
    (BF16, BF16, 40, ValueError),           # no tensor-core tile at hd 40
    (BF16, BF16, 72, ValueError),
    (BF16, BF16, 136, ValueError),
    (BF16, torch.int8, 64, TypeError),      # int8 pools are dequantized first
    (torch.float16, torch.float16, 64, TypeError),
])
def test_prefill_route_refuses_the_rest(q_dtype, pool_dtype, hd, exc):
    with pytest.raises(exc, match="32, 64, 80, 96, 128" if exc is ValueError
                       else None):
        fp.prefill_route(q_dtype, pool_dtype, hd)


@pytest.mark.parametrize("dtype,hd,route", [
    (BF16, 32, fp.TENSOR_CORE), (BF16, 64, fp.TENSOR_CORE),
    (BF16, 80, fp.TENSOR_CORE), (BF16, 96, fp.TENSOR_CORE),
    (BF16, 128, fp.TENSOR_CORE),
    (F32, 16, fp.CUDA_CORE), (F32, 32, fp.CUDA_CORE), (F32, 64, fp.CUDA_CORE),
    (F32, 80, fp.CUDA_CORE), (F32, 96, fp.CUDA_CORE),
    (F32, 128, fp.CUDA_CORE),
])
def test_flash_route(dtype, hd, route):
    assert fp.flash_route(dtype, hd) == route


@pytest.mark.parametrize("dtype,hd,exc", [
    (BF16, 40, ValueError), (BF16, 72, ValueError), (BF16, 136, ValueError),
    (F32, 256, ValueError), (torch.float16, 64, TypeError),
])
def test_flash_route_refuses_the_rest(dtype, hd, exc):
    with pytest.raises(exc):
        fp.flash_route(dtype, hd)


def test_16_byte_copy_checks():
    pool = torch.zeros((4, 16, 2, 64), dtype=BF16)
    fp._check_16b(q=torch.zeros((1, 8, 4, 64), dtype=BF16), k_pool=pool)
    padded = torch.zeros((4, 16, 2, 68), dtype=BF16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fp._check_16b(k_pool=padded)
    with pytest.raises(ValueError, match="aligned"):
        fp._check_16b(q=torch.zeros(1000, dtype=BF16)[1:])


@pytest.mark.parametrize("q_dtype", [F32, BF16])
@pytest.mark.parametrize("pool_dtype", [F32, BF16, torch.int8])
@pytest.mark.parametrize("G,hd,page", [
    (1, 64, 8), (2, 64, 8), (3, 128, 16), (4, 64, 16), (4, 128, 16),
    (8, 128, 16), (5, 64, 128), (4, 64, 1)])
def test_decode_shape_check_accepts(q_dtype, pool_dtype, G, hd, page):
    pa.decode_shape_check(q_dtype, pool_dtype, G, hd, page)


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (F32, F32), (F32, torch.int8), (BF16, BF16), (BF16, torch.int8)])
@pytest.mark.parametrize("G,hd,page", [
    (2, 32, 8), (1, 80, 16), (4, 96, 16), (8, 96, 128)])
def test_decode_shape_check_takes_the_new_head_dims(q_dtype, pool_dtype, G,
                                                    hd, page):
    """hd 32 (TINY), 80 (stablelm-3b) and 96 (the reduced override) over a
    pool of the query's dtype or int8; the mixed f32 / bf16 pairs there
    raise."""
    pa.decode_shape_check(q_dtype, pool_dtype, G, hd, page)
    other = BF16 if q_dtype == F32 else F32
    with pytest.raises(ValueError, match="dtype or int8"):
        pa.decode_shape_check(q_dtype, other, G, hd, page)


@pytest.mark.parametrize("q_dtype,pool_dtype,G,hd,page,exc", [
    (BF16, BF16, 4, 40, 16, ValueError),
    (BF16, torch.int8, 4, 72, 16, ValueError),
    (F32, F32, 4, 136, 16, ValueError),
    (F32, F32, 4, 256, 16, ValueError),
    (BF16, BF16, 9, 64, 16, ValueError),
    (BF16, BF16, 0, 64, 16, ValueError),
    (BF16, BF16, 4, 64, 256, ValueError),
    (BF16, BF16, 4, 64, 0, ValueError),
    (torch.float16, BF16, 4, 64, 16, TypeError),
    (BF16, torch.float16, 4, 64, 16, TypeError),
    (torch.int8, torch.int8, 4, 64, 16, TypeError),
])
def test_decode_shape_check_refuses_the_rest(q_dtype, pool_dtype, G, hd,
                                             page, exc):
    with pytest.raises(exc):
        pa.decode_shape_check(q_dtype, pool_dtype, G, hd, page)


@pytest.mark.parametrize("dtype", [F32, BF16, torch.int8])
def test_decode_chunk_alignment(dtype):
    pa.chunk_aligned(torch.zeros((4, 16, 2, 64), dtype=dtype))
    padded = torch.zeros((4, 16, 2, 66), dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="multiples"):
        pa.chunk_aligned(padded)
    flat = torch.zeros(4 * 16 * 2 * 64 + 1, dtype=dtype)
    with pytest.raises(ValueError, match="aligned"):
        pa.chunk_aligned(flat[1:].reshape(4, 16, 2, 64))


@pytest.mark.parametrize("dtype,page,KV,hd", [
    (F32, 16, 8, 64), (F32, 16, 8, 128), (BF16, 16, 8, 64),
    (BF16, 16, 8, 128), (BF16, 32, 8, 64), (F32, 16, 2, 64),
    (BF16, 8, 1, 8), (BF16, 16, 8, 256), (F32, 1, 1, 4),
    (BF16, 16, 8, 32), (F32, 16, 8, 32), (BF16, 16, 32, 80),
    (F32, 16, 32, 80), (BF16, 16, 2, 96), (F32, 16, 2, 96)])
def test_block_score_shape_check_accepts(dtype, page, KV, hd):
    bs.block_score_shape_check(dtype, page, KV, hd)


@pytest.mark.parametrize("dtype,page,KV,hd,exc", [
    (torch.int8, 16, 8, 64, TypeError),     # int8 pools are dequantized first
    (torch.float16, 16, 8, 64, TypeError),
    (BF16, 16, 8, 68, ValueError),          # not whole 16-byte chunks
    (BF16, 16, 8, 72, ValueError),          # 9 chunks, not a padded hd
    (BF16, 16, 8, 40, ValueError),
    (F32, 16, 8, 136, ValueError),
    (F32, 16, 8, 256, ValueError),          # 64 lanes per head
    (BF16, 16, 8, 512, ValueError),
    (BF16, 0, 8, 64, ValueError),
    (BF16, 1024, 8, 64, ValueError),        # head norms exceed shared memory
])
def test_block_score_shape_check_refuses_the_rest(dtype, page, KV, hd, exc):
    with pytest.raises(exc):
        bs.block_score_shape_check(dtype, page, KV, hd)


@pytest.mark.parametrize("hd", [40, 72, 136])
def test_head_dim_refusals_name_the_head_dims_taken(hd):
    with pytest.raises(ValueError, match="32, 64, 80, 96, 128"):
        pa.decode_shape_check(BF16, BF16, 4, hd, 16)
    with pytest.raises(ValueError, match="32, 64, 80, 96, 128"):
        fp.prefill_route(BF16, BF16, hd)
    with pytest.raises(ValueError, match="32, 64, 80, 96, 128"):
        fp.flash_route(BF16, hd)
    with pytest.raises(ValueError, match="or 32, 80, 96"):
        bs.block_score_shape_check(BF16, 16, 8, hd)
