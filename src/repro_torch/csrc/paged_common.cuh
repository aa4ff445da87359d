// Shared pieces of the paged kernels, and the block-wide page walk of the
// CUDA-core routes of the paged prefill (flash_prefill.cu, at a head dim
// without a tensor-core tile: f32 queries over an f32, bf16 or int8 pool,
// and a bf16 query over an f32 pool):
// for one (request b, KV head) block, fold every page of a block-table
// range into an online softmax over a tile of query rows. The decode kernel
// (paged_attention.cu) has its own warp-level walk and uses only the
// helpers here (Pool, to_float, pair_valid, allow_smem).
//
// The pool is read in its native (N, page, KV, hd) layout through the
// strides the wrapper passes (the JAX wrapper copied it to (KV, N, page, hd)
// first). A block loads its own block-table entries; unmapped slots read
// page 0 and are masked, exactly as the Pallas kernels clamp their DMA.
//
// Masking follows the Pallas kernels: a (row, token) pair is valid iff the
// slot is mapped, kpos >= 0, qpos >= 0, kpos <= qpos and, with a window,
// kpos > qpos - window; masked scores take -1e30 (not -inf) and their
// probabilities are zeroed. A page with no valid pair for the tile leaves
// (m, l, acc) unchanged (alpha == 1, p == 0), so it is skipped outright.
//
// Pools are f32, bf16 or int8. An int8 pool carries (N, page, KV) f32
// absmax scales: each page's scale / 127 (a correctly rounded division) is
// computed once per token into shared memory, and each element is
// dequantized on load as x * (scale / 127), the JAX package's order, so
// the tiles in shared memory (and the norms taken from them) are the
// dequantized values, bit for bit those of a pool dequantized beforehand.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory of one block, carved from the dynamic allocation. Rows of
// q and k are padded to hd + 1 floats so a warp reading one column of
// several rows hits distinct banks.
struct Smem {
  float* q;      // rows x (hd + 1)  query tile, f32
  float* k;      // page x (hd + 1)  K page tile, f32
  float* v;      // page x hd        V page tile, f32
  float* p;      // rows x page      scores, then probabilities
  float* acc;    // rows x hd        un-normalised output
  float* m;      // rows             running max
  float* l;      // rows             running normaliser
  float* alpha;  // rows             rescale factor of the current page
  float* kf;     // page             int8 pools: the page's k scale / 127
  float* vf;     // page             int8 pools: the page's v scale / 127
  int* qpos;     // rows             query positions (-1 == padding)
  int* kpos;     // page             token positions of the current page
};

inline size_t smem_bytes(int rows, int page, int hd) {
  const size_t floats = (size_t)rows * (hd + 1) + (size_t)page * (hd + 1) +
                        (size_t)page * hd + (size_t)rows * page +
                        (size_t)rows * hd + 3 * (size_t)rows +
                        2 * (size_t)page;
  return floats * sizeof(float) + ((size_t)rows + page) * sizeof(int);
}

__device__ __forceinline__ Smem carve(float* base, int rows, int page,
                                      int hd) {
  Smem s;
  s.q = base;
  base += rows * (hd + 1);
  s.k = base;
  base += page * (hd + 1);
  s.v = base;
  base += page * hd;
  s.p = base;
  base += rows * page;
  s.acc = base;
  base += rows * hd;
  s.m = base;
  base += rows;
  s.l = base;
  base += rows;
  s.alpha = base;
  base += rows;
  s.kf = base;
  base += page;
  s.vf = base;
  base += page;
  s.qpos = reinterpret_cast<int*>(base);
  s.kpos = s.qpos + rows;
  return s;
}

struct Pool {
  const void* k;     // (N, page, KV, hd) element strides below, hd contiguous
  const void* v;
  const float* k_scale;  // int8 pools: (N, page, KV) contiguous; else null
  const float* v_scale;
  const int* pos;    // (N, page) contiguous
  long long s_n, s_page, s_kv;
  int page, hd, kv_heads;
};

__device__ __forceinline__ bool pair_valid(bool mapped, int kp, int qp,
                                           int window) {
  return mapped && kp >= 0 && qp >= 0 && kp <= qp &&
         (window <= 0 || kp > qp - window);
}

// Fold pages [p0, p1) of block-table row `bt_row` into the state of `rows`
// query rows (s.q, s.qpos, s.m, s.l, s.acc initialised by the caller, and
// a __syncthreads() issued after). qmin / qmax bound the valid query
// positions of the tile (qmax < 0: no valid row) and only serve to skip
// pages. When kn_out is not null, the per-token ||k|| and ||v|| of every
// page are written at kn_out[p * page + j] (the fused score epilogue).
template <typename TK>
__device__ void walk_pages(const Smem& s, const Pool& pool, int kv,
                           const int* bt_row, int p0, int p1, int rows,
                           float scale, int window, int qmin, int qmax,
                           float* kn_out, float* vn_out) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int page = pool.page, hd = pool.hd;
  const TK* kp = static_cast<const TK*>(pool.k);
  const TK* vp = static_cast<const TK*>(pool.v);
  const bool norms = kn_out != nullptr;
  constexpr bool kInt8 = std::is_same_v<TK, int8_t>;
  for (int p = p0; p < p1; ++p) {
    const int phys = bt_row[p];
    const bool mapped = phys >= 0;
    const long long pg = mapped ? phys : 0;
    bool live = false;
    if (tid < page) {
      const int kq = pool.pos[pg * page + tid];
      s.kpos[tid] = kq;
      live = mapped && kq >= 0 && kq <= qmax &&
             (window <= 0 || kq > qmin - window);
      if constexpr (kInt8) {
        const long long si = (pg * page + tid) * pool.kv_heads + kv;
        s.kf[tid] = pool.k_scale[si] / 127.f;
        s.vf[tid] = pool.v_scale[si] / 127.f;
      }
    }
    const bool attend = __syncthreads_or(live);
    if (attend || norms) {
      const long long base = pg * pool.s_n + (long long)kv * pool.s_kv;
      for (int i = tid; i < page * hd; i += nthr) {
        const int j = i / hd, d = i - j * hd;
        const long long off = base + (long long)j * pool.s_page + d;
        float kx = to_float(kp[off]), vx = to_float(vp[off]);
        if constexpr (kInt8) {
          kx *= s.kf[j];
          vx *= s.vf[j];
        }
        s.k[j * (hd + 1) + d] = kx;
        s.v[j * hd + d] = vx;
      }
      __syncthreads();
    }
    if (norms) {
      for (int j = warp; j < page; j += nwarps) {
        float sk = 0.f, sv = 0.f;
        for (int d = lane; d < hd; d += 32) {
          const float a = s.k[j * (hd + 1) + d];
          const float b = s.v[j * hd + d];
          sk += a * a;
          sv += b * b;
        }
        for (int o = 16; o > 0; o >>= 1) {
          sk += __shfl_xor_sync(0xffffffffu, sk, o);
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
        }
        if (lane == 0) {
          kn_out[(long long)p * page + j] = sqrtf(sk);
          vn_out[(long long)p * page + j] = sqrtf(sv);
        }
      }
    }
    if (attend) {
      for (int i = tid; i < rows * page; i += nthr) {
        const int r = i / page, j = i - r * page;
        const float* qr = s.q + r * (hd + 1);
        const float* kj = s.k + j * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kj[d];
        s.p[i] = dot * scale;
      }
      __syncthreads();
      for (int r = tid; r < rows; r += nthr) {
        const int qp = s.qpos[r];
        float* pr = s.p + r * page;
        const float m_prev = s.m[r];
        float m_new = m_prev;
        for (int j = 0; j < page; ++j)
          if (pair_valid(mapped, s.kpos[j], qp, window))
            m_new = fmaxf(m_new, pr[j]);
        float lsum = 0.f;
        for (int j = 0; j < page; ++j) {
          const float e = pair_valid(mapped, s.kpos[j], qp, window)
                              ? expf(pr[j] - m_new) : 0.f;
          pr[j] = e;
          lsum += e;
        }
        const float alpha = expf(m_prev - m_new);
        s.alpha[r] = alpha;
        s.l[r] = alpha * s.l[r] + lsum;
        s.m[r] = m_new;
      }
      __syncthreads();
      for (int i = tid; i < rows * hd; i += nthr) {
        const int r = i / hd, d = i - r * hd;
        const float* pr = s.p + r * page;
        float a = s.acc[i] * s.alpha[r];
        for (int j = 0; j < page; ++j) a += pr[j] * s.v[j * hd + d];
        s.acc[i] = a;
      }
    }
    __syncthreads();
  }
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
