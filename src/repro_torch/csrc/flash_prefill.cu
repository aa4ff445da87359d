// G-fold chunked-prefill attention over the shared page pool, with the
// fused ||K|| / ||V|| score epilogue, and its per-Q-head variant.
//
// Replaces: the Pallas TPU kernels `paged_flash_prefill_kernel` (G-fold)
// and `paged_flash_prefill_kernel_per_qhead` of the JAX package
// (src/repro/kernels/flash_prefill.py, body `_paged_prefill_kernel`).
//
// What it computes: a (B, T, H, hd) chunk of queries attends over each
// request's pages (the chunk's own K/V already written: write-then-attend).
// The G query heads of a KV group fold into G * T rows (row g * T + t is head
// kv * G + g, token t), so a block that holds a tile of those rows reads each
// K/V page once for all of them. Block (tile, kv, b) walks every page of the
// block table with an online softmax and writes acc / max(l, 1e-30): rows
// with no valid key (padding queries, q_pos < 0) come out as zeros. With
// scores, the blocks of tile 0 write the per-token norms of every
// (b, kv, p), so each is written by exactly one block. Nothing assumes G is
// a power of two (G is 3 on Llama-3.2-3B).
//
// The per-Q-head variant (the JAX package's bit-parity oracle of the fold
// and the baseline of its kernel benchmark) runs the same page walk on a
// (tile, head, b) grid: a block holds T rows of ONE query head and reads
// each page once per query head, G times the fold's traffic. Each row's
// dot products, max, sum and accumulation run in the same order in both,
// so the two outputs are bit-equal. It has no score epilogue.
//
// What bounds it on an H100: at chunk 256 the work is about 4 * rows * hd
// FLOPs per key and the pool is read once per row tile, so a tile of R rows
// does 2 * R FLOPs per byte read in f32 on CUDA cores: compute on the CUDA
// cores (no tensor cores yet) is the limit, then the repeated page reads
// (one per tile). The design keeps the tile in shared memory, reuses each
// page tile for all R rows and G heads, and skips every page no row of the
// tile can see (unmapped, empty, or wholly after the tile's last query), and
// every tile that holds only padding rows, which in a mixed step is most of
// the decode rows' T - 1 padding tokens. wgmma / TMA are later work.
//
// Types: q (and the output) f32 or bf16; the pool f32 or bf16 (an int8
// pool is dequantized to f32 by the caller, as the JAX package does).
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "paged_common.cuh"

namespace {

// The tile's smallest and largest valid query position into s_qmin / s_qmax
// (s_qmax < 0 when the tile holds only padding rows).
__device__ void tile_bounds(const paged::Smem& s, int rows, int* s_qmin,
                            int* s_qmax) {
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = -1;
    for (int r = 0; r < rows; ++r) {
      const int qp = s.qpos[r];
      if (qp >= 0) {
        lo = min(lo, qp);
        hi = max(hi, qp);
      }
    }
    *s_qmin = lo;
    *s_qmax = hi;
  }
  __syncthreads();
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const TQ* __restrict__ q, paged::Pool pool,
                         const int* __restrict__ bt,
                         const int* __restrict__ q_pos, TQ* out, float* kn,
                         float* vn, int Tq, int KV, int G, int P,
                         int tile_rows, int window, float scale) {
  extern __shared__ float smem[];
  __shared__ int s_qmin, s_qmax;
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int hd = pool.hd, page = pool.page;
  const int H = KV * G;
  const int r0 = tile * tile_rows;
  const int rows = min(tile_rows, G * Tq - r0);
  const paged::Smem s = paged::carve(smem, tile_rows, page, hd);
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int g = (r0 + r) / Tq, t = (r0 + r) - g * Tq;
    const long long qi = (((long long)b * Tq + t) * H + kv * G + g) * hd + d;
    s.q[r * (hd + 1) + d] = paged::to_float(q[qi]);
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int t = (r0 + r) % Tq;
    s.qpos[r] = q_pos[(long long)b * Tq + t];
    s.m[r] = paged::kNegInf;
    s.l[r] = 0.f;
  }
  __syncthreads();
  tile_bounds(s, rows, &s_qmin, &s_qmax);
  const bool norms = kn != nullptr && tile == 0;
  if (s_qmax >= 0 || norms) {
    const long long bk = (long long)b * KV + kv;
    paged::walk_pages<TK>(s, pool, kv, bt + (long long)b * P, 0, P, rows,
                          scale, window, s_qmin, s_qmax,
                          norms ? kn + bk * P * page : nullptr,
                          norms ? vn + bk * P * page : nullptr);
  }
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int g = (r0 + r) / Tq, t = (r0 + r) - g * Tq;
    const long long oi = (((long long)b * Tq + t) * H + kv * G + g) * hd + d;
    out[oi] = paged::from_float<TQ>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_per_qhead_kernel(const TQ* __restrict__ q, paged::Pool pool,
                                   const int* __restrict__ bt,
                                   const int* __restrict__ q_pos, TQ* out,
                                   int Tq, int KV, int G, int P,
                                   int tile_rows, int window, float scale) {
  extern __shared__ float smem[];
  __shared__ int s_qmin, s_qmax;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = pool.hd, page = pool.page;
  const int H = KV * G, kv = h / G;
  const int t0 = tile * tile_rows;
  const int rows = min(tile_rows, Tq - t0);
  const paged::Smem s = paged::carve(smem, tile_rows, page, hd);
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const long long qi = (((long long)b * Tq + t0 + r) * H + h) * hd + d;
    s.q[r * (hd + 1) + d] = paged::to_float(q[qi]);
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s.qpos[r] = q_pos[(long long)b * Tq + t0 + r];
    s.m[r] = paged::kNegInf;
    s.l[r] = 0.f;
  }
  __syncthreads();
  tile_bounds(s, rows, &s_qmin, &s_qmax);
  if (s_qmax >= 0)
    paged::walk_pages<TK>(s, pool, kv, bt + (long long)b * P, 0, P, rows,
                          scale, window, s_qmin, s_qmax, nullptr, nullptr);
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const long long oi = (((long long)b * Tq + t0 + r) * H + h) * hd + d;
    out[oi] = paged::from_float<TQ>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename TQ, typename TK>
int launch(bool per_qhead, const void* q, paged::Pool pool, const int* bt,
           const int* q_pos, void* out, float* kn, float* vn, int B, int Tq,
           int KV, int G, int P, int tile_rows, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = paged::smem_bytes(tile_rows, pool.page, pool.hd);
  const TQ* qt = static_cast<const TQ*>(q);
  TQ* ot = static_cast<TQ*>(out);
  cudaError_t err;
  if (per_qhead) {
    err = paged::allow_smem(paged_prefill_per_qhead_kernel<TQ, TK>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Tq + tile_rows - 1) / tile_rows, KV * G, B);
    paged_prefill_per_qhead_kernel<TQ, TK>
        <<<grid, paged::kThreads, smem, stream>>>(
            qt, pool, bt, q_pos, ot, Tq, KV, G, P, tile_rows, window, scale);
  } else {
    err = paged::allow_smem(paged_prefill_kernel<TQ, TK>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((G * Tq + tile_rows - 1) / tile_rows, KV, B);
    paged_prefill_kernel<TQ, TK><<<grid, paged::kThreads, smem, stream>>>(
        qt, pool, bt, q_pos, ot, kn, vn, Tq, KV, G, P, tile_rows, window,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(int pool_dtype, bool per_qhead, const void* q, paged::Pool pool,
             const int* bt, const int* q_pos, void* out, float* kn, float* vn,
             int B, int Tq, int KV, int G, int P, int tile_rows, int window,
             float scale, cudaStream_t st) {
  if (pool_dtype == 0)
    return launch<TQ, float>(per_qhead, q, pool, bt, q_pos, out, kn, vn, B,
                             Tq, KV, G, P, tile_rows, window, scale, st);
  return launch<TQ, __nv_bfloat16>(per_qhead, q, pool, bt, q_pos, out, kn,
                                   vn, B, Tq, KV, G, P, tile_rows, window,
                                   scale, st);
}

}  // namespace

extern "C" {

// q (B, T, H, hd) contiguous, H = KV * G; k/v pool (N, page, KV, hd) with
// element strides s_n, s_page, s_kv and hd contiguous; pos (N, page) int32;
// bt (B, P) int32; q_pos (B, T) int32 (-1 == padding). out (B, T, H, hd) in
// q's type; kn / vn (B, KV, P, page) f32 when not null (G-fold only).
// tile_rows: the rows one block holds (folded rows, or one head's tokens
// when per_qhead). q_dtype / pool_dtype: 0 = float32, 1 = bfloat16. Returns
// the CUDA error code of the launch (0 == success).
int paged_prefill(const void* q, const void* k, const void* v, const int* pos,
                  const int* bt, const int* q_pos, void* out, float* kn,
                  float* vn, int B, int T, int KV, int G, int hd, int P,
                  int page, long long s_n, long long s_page, long long s_kv,
                  int tile_rows, int window, float scale, int q_dtype,
                  int pool_dtype, int per_qhead, void* stream) {
  const paged::Pool pool{k,    v,    nullptr, nullptr, pos, s_n,
                         s_page, s_kv, page,    hd,      KV};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(pool_dtype, per_qhead != 0, q, pool, bt, q_pos,
                           out, kn, vn, B, T, KV, G, P, tile_rows, window,
                           scale, st);
  return launch_q<__nv_bfloat16>(pool_dtype, per_qhead != 0, q, pool, bt,
                                 q_pos, out, kn, vn, B, T, KV, G, P,
                                 tile_rows, window, scale, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
