// Per-physical-page Alg.1 score of the paper, from the page pool.
//
// Replaces: the Pallas TPU kernel `block_score_kernel` of the JAX package
// (src/repro/kernels/block_score.py, body `_block_score_kernel`), the
// standalone page-scoring pass that is the oracle of the attention kernels'
// fused norm epilogue.
//
// What it computes: for each physical page n of the pool (N, page, KV, hd),
// the mean over its valid tokens (pos >= 0) of
// mean_h ||v|| / max(mean_h ||k||, 1e-6); +inf for a page with no valid
// token. An int8 pool is dequantized by the caller first, as in JAX.
//
// Design: one block per page, one warp per token (warps stride over the
// page's tokens): the lanes stride over hd, a shuffle reduction gives each
// head's squared norm, and the warp sums the heads' norms in head order.
// Each token's ratio goes to shared memory, and one thread sums the valid
// ones in token order, as the plain version reduces them.
//
// What bounds it on an H100: bytes. It reads every K and V element of the
// pool once (4 FLOPs per element pair) and writes one float per page.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-6f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_score_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const int* __restrict__ pos, float* __restrict__ out,
                       int page, int KV, int hd, long long s_n,
                       long long s_page, long long s_kv) {
  extern __shared__ float tok[];   // page
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = warp; j < page; j += nwarps) {
    float ksum = 0.f, vsum = 0.f;
    for (int h = 0; h < KV; ++h) {
      const long long base = n * s_n + j * s_page + h * s_kv;
      float sk = 0.f, sv = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float a = paged::to_float(k[base + d]);
        const float c = paged::to_float(v[base + d]);
        sk += a * a;
        sv += c * c;
      }
      for (int o = 16; o > 0; o >>= 1) {
        sk += __shfl_xor_sync(0xffffffffu, sk, o);
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
      }
      ksum += sqrtf(sk);
      vsum += sqrtf(sv);
    }
    if (lane == 0) tok[j] = (vsum / KV) / fmaxf(ksum / KV, kEps);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cnt = 0;
    float ssum = 0.f;
    for (int j = 0; j < page; ++j) {
      if (pos[(long long)n * page + j] >= 0) {
        ++cnt;
        ssum += tok[j];
      }
    }
    out[n] = cnt > 0 ? ssum / cnt : __int_as_float(0x7f800000);
  }
}

template <typename T>
int launch(const void* k, const void* v, const int* pos, float* out, int N,
           int page, int KV, int hd, long long s_n, long long s_page,
           long long s_kv, cudaStream_t stream) {
  if (N == 0) return 0;
  block_score_kernel<T><<<N, kThreads, page * sizeof(float), stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), pos, out, page, KV,
      hd, s_n, s_page, s_kv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k / v pool (N, page, KV, hd) with element strides s_n, s_page, s_kv and hd
// contiguous, of one type (dtype 0 = float32, 1 = bfloat16); pos (N, page)
// int32 contiguous; out (N,) f32. Returns the CUDA error code of the launch
// (0 == success).
int block_score(const void* k, const void* v, const int* pos, float* out,
                int N, int page, int KV, int hd, long long s_n,
                long long s_page, long long s_kv, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(k, v, pos, out, N, page, KV, hd, s_n, s_page, s_kv,
                         st);
  return launch<__nv_bfloat16>(k, v, pos, out, N, page, KV, hd, s_n, s_page,
                               s_kv, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
