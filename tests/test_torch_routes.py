"""The route rules of the prefill and flash attention wrappers, on the CPU.

A route is a function of dtypes and head dim alone, written down in the
wrappers (``prefill_route``, ``flash_route``): bf16 throughout at hd 64 or
128 runs on the tensor cores; an f32 query, or a bf16 query over an f32
pool (the dequantized int8 pool), on the CUDA cores; anything else raises.
No route falls back to the other. The tensor-core route's 16-byte copies
need aligned bases and pool strides in multiples of 8 elements, which the
wrappers check and refuse otherwise.
"""
import pytest
import torch

from repro_torch.kernels import flash_prefill as fp

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("hd", [64, 128])
def test_prefill_bf16_pair_takes_tensor_cores(hd):
    assert fp.prefill_route(BF16, BF16, hd) == fp.TENSOR_CORE


@pytest.mark.parametrize("q_dtype,pool_dtype", [(F32, F32), (F32, BF16),
                                                (BF16, F32)])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_prefill_f32_and_bf16_over_f32_take_cuda_cores(q_dtype, pool_dtype,
                                                       hd):
    assert fp.prefill_route(q_dtype, pool_dtype, hd) == fp.CUDA_CORE


@pytest.mark.parametrize("q_dtype,pool_dtype,hd,exc", [
    (BF16, BF16, 32, ValueError),           # no tensor-core tile at hd 32
    (BF16, BF16, 96, ValueError),
    (BF16, torch.int8, 64, TypeError),      # int8 pools are dequantized first
    (torch.float16, torch.float16, 64, TypeError),
])
def test_prefill_route_refuses_the_rest(q_dtype, pool_dtype, hd, exc):
    with pytest.raises(exc):
        fp.prefill_route(q_dtype, pool_dtype, hd)


@pytest.mark.parametrize("dtype,hd,route", [
    (BF16, 64, fp.TENSOR_CORE), (BF16, 128, fp.TENSOR_CORE),
    (F32, 16, fp.CUDA_CORE), (F32, 64, fp.CUDA_CORE),
    (F32, 128, fp.CUDA_CORE),
])
def test_flash_route(dtype, hd, route):
    assert fp.flash_route(dtype, hd) == route


@pytest.mark.parametrize("dtype,hd,exc", [
    (BF16, 32, ValueError), (F32, 256, ValueError),
    (torch.float16, 64, TypeError),
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
