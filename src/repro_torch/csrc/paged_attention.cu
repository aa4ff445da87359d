// Split-K paged decode attention with block-table indirection and the
// fused ||K|| / ||V|| score epilogue.
//
// Replaces: the Pallas TPU kernels `paged_attention_kernel` and
// `paged_attention_kernel_int8` of the JAX package
// (src/repro/kernels/paged_attention.py, bodies `_decode_step_body` /
// `_paged_attn_kernel` / `_paged_attn_kernel_int8`). The int8 variant is
// the same kernel instantiated on an int8 pool: each element is
// dequantized on load with its (token, head) scale, so the pool is read at
// one byte per element plus one f32 scale per (token, head) and row.
//
// What it computes: one query token per request, G query heads per KV head,
// attends over the shared page pool through the block table. Block
// (split, kv, b) walks its split's pages in order with an online softmax
// and writes the UN-normalised partials acc (B, KV, S, G, hd), m and l
// (B, KV, S, G); `combine_splits` in the wrapper merges the splits. With
// scores, every (b, kv, p) slot gets its per-token ||k||, ||v|| (page
// max(bt, 0) for unmapped slots, as in JAX), written by the one split that
// owns p.
//
// What bounds it on an H100: bytes. Each block reads its pages' K and V
// once (page x hd per head, in bf16 or f32) and does 2 * G FLOPs per
// element read, far below the 295 FLOP/byte the card needs to be compute
// bound. The design therefore (a) reads each K/V element exactly once per
// (b, kv) and reuses it from shared memory for all G query heads, (b)
// splits the page walk (num_splits) so that B * KV * S blocks fill the 132
// SMs when B * KV alone does not, and (c) skips the loads of pages no query
// can see (unmapped, empty, in the future or out of the window) unless the
// score epilogue needs their norms. Loads are scalar and the dot products
// run on CUDA cores; TMA / wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "paged_common.cuh"

namespace {

template <typename TQ, typename TK>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, paged::Pool pool,
                        const int* __restrict__ bt,
                        const int* __restrict__ cur_pos, float* acc_out,
                        float* m_out, float* l_out, float* kn, float* vn,
                        int KV, int G, int P, int pps, int S, int window,
                        float scale) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int hd = pool.hd, page = pool.page;
  const paged::Smem s = paged::carve(smem, G, page, hd);
  const int cur = cur_pos[b];
  const long long bk = (long long)b * KV + kv;
  const TQ* qb = q + bk * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    s.q[g * (hd + 1) + d] = paged::to_float(qb[i]);
    s.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    s.m[g] = paged::kNegInf;
    s.l[g] = 0.f;
    s.qpos[g] = cur;
  }
  __syncthreads();
  const int p0 = sp * pps;
  const int p1 = min(P, p0 + pps);
  float* kn_b = kn ? kn + bk * P * page : nullptr;
  float* vn_b = vn ? vn + bk * P * page : nullptr;
  paged::walk_pages<TK>(s, pool, kv, bt + (long long)b * P, p0, p1, G,
                        scale, window, cur, cur, kn_b, vn_b);
  const long long part = (bk * S + sp) * G;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x)
    acc_out[part * hd + i] = s.acc[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_out[part + g] = s.m[g];
    l_out[part + g] = s.l[g];
  }
}

template <typename TQ, typename TK>
int launch(const void* q, paged::Pool pool, const int* bt, const int* cur_pos,
           float* acc, float* m, float* l, float* kn, float* vn, int B, int KV,
           int G, int P, int S, int pps, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = paged::smem_bytes(G, pool.page, pool.hd);
  cudaError_t err = paged::allow_smem(paged_decode_kernel<TQ, TK>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, KV, B);
  paged_decode_kernel<TQ, TK><<<grid, paged::kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), pool, bt, cur_pos, acc, m, l, kn, vn, KV,
      G, P, pps, S, window, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(int pool_dtype, const void* q, paged::Pool pool, const int* bt,
             const int* cur_pos, float* acc, float* m, float* l, float* kn,
             float* vn, int B, int KV, int G, int P, int S, int pps,
             int window, float scale, cudaStream_t st) {
  if (pool_dtype == 0)
    return launch<TQ, float>(q, pool, bt, cur_pos, acc, m, l, kn, vn, B, KV,
                             G, P, S, pps, window, scale, st);
  if (pool_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, pool, bt, cur_pos, acc, m, l, kn, vn,
                                     B, KV, G, P, S, pps, window, scale, st);
  return launch<TQ, int8_t>(q, pool, bt, cur_pos, acc, m, l, kn, vn, B, KV,
                            G, P, S, pps, window, scale, st);
}

}  // namespace

extern "C" {

// q (B, KV, G, hd) contiguous; k/v pool (N, page, KV, hd) with element
// strides s_n, s_page, s_kv and hd contiguous; k_scale / v_scale (N, page,
// KV) f32 contiguous for an int8 pool, else null; pos (N, page) int32; bt
// (B, P) int32; cur_pos (B,) int32. Outputs f32: acc (B, KV, S, G, hd), m
// and l (B, KV, S, G), and when kn / vn are not null (B, KV, P, page)
// norms. q_dtype: 0 = float32, 1 = bfloat16; pool_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8. Returns the CUDA error code of the launch
// (0 == success).
int paged_decode(const void* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale, const int* pos,
                 const int* bt, const int* cur_pos, float* acc, float* m,
                 float* l, float* kn, float* vn, int B, int KV, int G, int hd,
                 int P, int page, long long s_n, long long s_page,
                 long long s_kv, int num_splits, int pages_per_split,
                 int window, float scale, int q_dtype, int pool_dtype,
                 void* stream) {
  const paged::Pool pool{k,    v,    k_scale, v_scale, pos, s_n,
                         s_page, s_kv, page,    hd,      KV};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(pool_dtype, q, pool, bt, cur_pos, acc, m, l, kn,
                           vn, B, KV, G, P, num_splits, pages_per_split,
                           window, scale, st);
  return launch_q<__nv_bfloat16>(pool_dtype, q, pool, bt, cur_pos, acc, m, l,
                                 kn, vn, B, KV, G, P, num_splits,
                                 pages_per_split, window, scale, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
