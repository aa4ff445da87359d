// G-fold chunked-prefill attention over the shared page pool, with the
// fused ||K|| / ||V|| score epilogue, and its per-Q-head variant.
//
// Replaces: the Pallas TPU kernels `paged_flash_prefill_kernel` (G-fold)
// and `paged_flash_prefill_kernel_per_qhead` of the JAX package
// (src/repro/kernels/flash_prefill.py, body `_paged_prefill_kernel`).
//
// What it computes: a (B, T, H, hd) chunk of queries attends over each
// request's pages (the chunk's own K/V already written: write-then-attend).
// The G query heads of a KV group fold into G * T rows, so a block that
// holds a tile of those rows reads each K/V page once for all of them.
// Each block walks every page of the block table with an online softmax and
// writes acc / max(l, 1e-30): rows with no valid key (padding queries,
// q_pos < 0) come out as zeros. With scores, the blocks of tile 0 write the
// per-token norms of every (b, kv, p), so each is written by exactly one
// block. Nothing assumes G is a power of two (G is 3 on Llama-3.2-3B).
//
// The per-Q-head variant (the JAX package's bit-parity oracle of the fold
// and the baseline of its kernel benchmark) runs the same walk on a
// (tile, head, b) grid: a block holds the rows of ONE query head and reads
// each page once per query head, G times the fold's traffic. It has no
// score epilogue. Each row's arithmetic is the same in both grids, so the
// two outputs are bit-equal.
//
// Two routes, chosen by the wrapper from the dtypes (never a fallback):
//
// bf16 query over a bf16 pool, hd 32, 64, 80, 96 or 128: tensor cores
// (attn_tile.cuh: mma.sync m16n8k16, ldmatrix, cp.async). A block holds 64
// rows on 4 warps, in the fold's g * T + t order or, on request, token-major (t * G + g: a
// decode row's G heads share one tile, and its block walks the pages once
// instead of G blocks walking them in parallel). The block's keys
// are the block table's slots laid end to end, cut into key tiles of 64
// keys from slot 0 (4 pages of 16); each key's row is gathered through the
// block table into shared memory by 16-byte cp.async copies, in the pool's
// native strides, into a ring of two stages, so tile i + 1 loads while tile
// i is computed. Before the walk the block marks the key tiles that hold a
// key some row of it can see (or every tile, for the norm writers); only
// those are loaded. The mask is built on the score fragment from the
// keys' positions and the rows' q_pos. Both grids group keys into the same
// tiles, and a tile that is all masked for a row leaves it bit for bit
// unchanged, so per-Q-head and G-fold agree bit for bit.
//
// f32 query (either pool), or a bf16 query over an f32 pool (the pool an
// int8 cache dequantizes to): CUDA cores, the page walk of
// paged_common.cuh, one page of keys per step, f32 dot products from
// shared memory, rows in the g * T + t order.
//
// What bounds it on an H100: at chunk 256 the work is about 4 * rows * hd
// FLOPs per key and the pool is read once per row tile, from L2 after the
// first; the bytes (the pages reached, q and the output once each) bound it
// on paper. The tensor-core route keeps the products off the CUDA cores and
// skips every key tile and row tile no row can use, which in a mixed step
// is most of the decode rows' T - 1 padding tokens.
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"
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

// ---------------------------------------------------------------------------
// bf16 query over a bf16 pool, on tensor cores
// ---------------------------------------------------------------------------

constexpr int kRowsP = 64;                     // rows per block
constexpr int kThreadsP = 32 * kRowsP / 16;    // a warp per 16 rows

// Sum of squares, in f32, of the 8 bf16 values of a 16-byte chunk.
__device__ __forceinline__ float sum_squares8(const tc::bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x * f.x + f.y * f.y;
  }
  return s;
}

inline size_t tc_smem_bytes(int D, int ntiles) {
  return (size_t)(kRowsP + 4 * tc::kKeys) * D * 2 +
         (size_t)(2 * tc::kKeys + 3 * kRowsP + ntiles) * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreadsP)
    paged_prefill_tc_kernel(const tc::bf16* __restrict__ q,
                            const tc::bf16* __restrict__ kpool,
                            const tc::bf16* __restrict__ vpool,
                            const int* __restrict__ pos,
                            const int* __restrict__ bt,
                            const int* __restrict__ q_pos,
                            tc::bf16* __restrict__ out, float* kn, float* vn,
                            int Tq, int KV, int G, int P, int page,
                            long long s_n, long long s_page, long long s_kv,
                            int window, float scale, int per_qhead) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tc::bf16* sQ = reinterpret_cast<tc::bf16*>(smem_raw);  // kRowsP x D
  tc::bf16* sK = sQ + kRowsP * D;                         // 2 x kKeys x D
  tc::bf16* sV = sK + 2 * tc::kKeys * D;                  // 2 x kKeys x D
  int* s_kpos = reinterpret_cast<int*>(sV + 2 * tc::kKeys * D);  // 2 x kKeys
  int* s_qpos = s_kpos + 2 * tc::kKeys;  // per row; -1 == padding
  int* s_tok = s_qpos + kRowsP;          // per row: token, -1 past the chunk
  int* s_head = s_tok + kRowsP;          // per row: query head
  int* s_tiles = s_head + kRowsP;        // live flag per key tile, then list
  __shared__ int s_qmin, s_qmax, s_count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, b = blockIdx.z;
  const int H = KV * G;
  const int kv = per_qhead ? blockIdx.y / G : blockIdx.y;
  const int nkeys = P * page;
  const int ntiles = (nkeys + tc::kKeys - 1) / tc::kKeys;
  const bool norms = kn != nullptr && tile == 0;
  const int* btr = bt + (long long)b * P;

  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = -1;
  }
  for (int i = tid; i < ntiles; i += blockDim.x) s_tiles[i] = norms;
  __syncthreads();
  if (tid < kRowsP) {
    const int r = tile * kRowsP + tid;
    int t = -1, h = 0;
    if (per_qhead) {
      if (r < Tq) {
        t = r;
        h = blockIdx.y;
      }
    } else if (r < G * Tq) {
      t = r % Tq;
      h = kv * G + r / Tq;
    }
    const int qp = t >= 0 ? q_pos[(long long)b * Tq + t] : -1;
    s_tok[tid] = t;
    s_head[tid] = h;
    s_qpos[tid] = qp;
    if (qp >= 0) {
      atomicMin(&s_qmin, qp);
      atomicMax(&s_qmax, qp);
    }
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;
  const bool attend = qmax >= 0;
  const int r0 = warp * 16, g = lane >> 2;
  auto store = [&](const tc::Rows<D>& st) {
    st.store([&](int hh, int c, float x0, float x1) {
      const int r = r0 + g + 8 * hh, t = s_tok[r];
      if (t >= 0)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((long long)b * Tq + t) * H + s_head[r]) * D + c) =
            __floats2bfloat162_rn(x0, x1);
    });
  };
  tc::Rows<D> st;
  st.init();
  if (!attend && !norms) {  // padding rows only: zeros
    store(st);
    return;
  }

  // mark the key tiles that hold a key some row can see
  if (attend && !norms) {
    for (int key = tid; key < nkeys; key += blockDim.x) {
      const int p = key / page, phys = btr[p];
      if (phys < 0) continue;
      const int kq = pos[(long long)phys * page + (key - p * page)];
      if (kq >= 0 && kq <= qmax && (window <= 0 || kq > qmin - window))
        s_tiles[key / tc::kKeys] = 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < ntiles; ++i)
      if (s_tiles[i]) s_tiles[n++] = i;
    s_count = n;
  }
  __syncthreads();
  const int n = s_count;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * tc::kKeys;
    auto row = [&](const tc::bf16* base) {
      return [=](int j) -> const tc::bf16* {
        const int key = k0 + j;
        if (key >= nkeys) return nullptr;
        const int p = key / page;
        const long long phys = max(btr[p], 0);
        return base + phys * s_n + (long long)(key - p * page) * s_page +
               (long long)kv * s_kv;
      };
    };
    tc::load_tile<D>(sK + stage * tc::kKeys * D, tc::kKeys, kpool,
                     row(kpool));
    tc::load_tile<D>(sV + stage * tc::kKeys * D, tc::kKeys, vpool,
                     row(vpool));
    if (tid < tc::kKeys) {
      const int key = k0 + tid;
      int kq = -1;  // unmapped slots and keys past the table: masked
      if (key < nkeys) {
        const int p = key / page, phys = btr[p];
        if (phys >= 0) kq = pos[(long long)phys * page + (key - p * page)];
      }
      s_kpos[stage * tc::kKeys + tid] = kq;
    }
  };

  const int qp[2] = {s_qpos[r0 + g], s_qpos[r0 + g + 8]};
  const bool warp_rows = __any_sync(0xffffffffu, qp[0] >= 0 || qp[1] >= 0);
  if (attend)
    tc::load_tile<D>(sQ, kRowsP, q, [&](int r) -> const tc::bf16* {
      return s_qpos[r] >= 0
                 ? q + (((long long)b * Tq + s_tok[r]) * H + s_head[r]) * D
                 : nullptr;
    });
  if (n > 0) load_kv(s_tiles[0], 0);
  tc::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int stage = i & 1, kt = s_tiles[i];
    if (i + 1 < n) {
      load_kv(s_tiles[i + 1], stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const tc::bf16* tK = sK + stage * tc::kKeys * D;
    const tc::bf16* tV = sV + stage * tc::kKeys * D;
    if (norms) {  // f32 sums of the bf16 values: two lanes per key
      const int j = warp * 16 + (lane >> 1), half = lane & 1;
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int col = 8 * (half * (D / 16) + c);
        sk += sum_squares8(tK + tc::swz<D>(j, col));
        sv += sum_squares8(tV + tc::swz<D>(j, col));
      }
      sk += __shfl_xor_sync(0xffffffffu, sk, 1);
      sv += __shfl_xor_sync(0xffffffffu, sv, 1);
      const int key = kt * tc::kKeys + j;
      if (!half && key < nkeys) {
        const long long at = ((long long)b * KV + kv) * nkeys + key;
        kn[at] = sqrtf(sk);
        vn[at] = sqrtf(sv);
      }
    }
    if (attend && warp_rows) {
      const int* kpos = s_kpos + stage * tc::kKeys;
      float s[8][4];
      tc::qk<D>(s, sQ, r0, tK);
      tc::softmax_pv<D>(st, s, tV, scale, [&](int hh, int j) {
        return paged::pair_valid(true, kpos[j], qp[hh], window);
      });
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();
  store(st);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* pos,
              const int* bt, const int* q_pos, void* out, float* kn,
              float* vn, int B, int Tq, int KV, int G, int P, int page,
              long long s_n, long long s_page, long long s_kv, int window,
              float scale, int per_qhead, cudaStream_t stream) {
  const int ntiles = (P * page + tc::kKeys - 1) / tc::kKeys;
  const size_t smem = tc_smem_bytes(D, ntiles);
  cudaError_t err = paged::allow_smem(paged_prefill_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = per_qhead ? Tq : G * Tq;
  const dim3 grid((rows + kRowsP - 1) / kRowsP, per_qhead ? KV * G : KV, B);
  paged_prefill_tc_kernel<D><<<grid, kThreadsP, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), pos, bt, q_pos,
      static_cast<tc::bf16*>(out), per_qhead ? nullptr : kn,
      per_qhead ? nullptr : vn, Tq, KV, G, P, page, s_n, s_page, s_kv,
      window, scale, per_qhead);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 query, or a bf16 query over an f32 pool, on CUDA cores
// ---------------------------------------------------------------------------

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

}  // namespace

extern "C" {

// CUDA-core route. q (B, T, H, hd) contiguous, H = KV * G; k/v pool
// (N, page, KV, hd) with element strides s_n, s_page, s_kv and hd
// contiguous; pos (N, page) int32; bt (B, P) int32; q_pos (B, T) int32
// (-1 == padding). out (B, T, H, hd) in q's type; kn / vn (B, KV, P, page)
// f32 when not null (G-fold only). tile_rows: the rows one block holds
// (folded rows, or one head's tokens when per_qhead). q_dtype / pool_dtype:
// 0 = float32, 1 = bfloat16; a bf16 query over a bf16 pool is the
// tensor-core route's (paged_prefill_tc) and is refused here. Returns the
// CUDA error code of the launch (0 == success).
int paged_prefill(const void* q, const void* k, const void* v, const int* pos,
                  const int* bt, const int* q_pos, void* out, float* kn,
                  float* vn, int B, int T, int KV, int G, int hd, int P,
                  int page, long long s_n, long long s_page, long long s_kv,
                  int tile_rows, int window, float scale, int q_dtype,
                  int pool_dtype, int per_qhead, void* stream) {
  const paged::Pool pool{k,    v,    nullptr, nullptr, pos, s_n,
                         s_page, s_kv, page,    hd,      KV};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pq = per_qhead != 0;
  if (q_dtype == 0 && pool_dtype == 0)
    return launch<float, float>(pq, q, pool, bt, q_pos, out, kn, vn, B, T,
                                KV, G, P, tile_rows, window, scale, st);
  if (q_dtype == 0 && pool_dtype == 1)
    return launch<float, __nv_bfloat16>(pq, q, pool, bt, q_pos, out, kn, vn,
                                        B, T, KV, G, P, tile_rows, window,
                                        scale, st);
  if (q_dtype == 1 && pool_dtype == 0)
    return launch<__nv_bfloat16, float>(pq, q, pool, bt, q_pos, out, kn, vn,
                                        B, T, KV, G, P, tile_rows, window,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-core route: a bf16 query over a bf16 pool, hd 32, 64, 80, 96 or
// 128, every
// pool row 16-byte aligned (s_n, s_page, s_kv multiples of 8). Arguments
// as paged_prefill; folded row r is query head kv * G + r / T, token r % T.
int paged_prefill_tc(const void* q, const void* k, const void* v,
                     const int* pos, const int* bt, const int* q_pos,
                     void* out, float* kn, float* vn, int B, int T, int KV,
                     int G, int hd, int P, int page, long long s_n,
                     long long s_page, long long s_kv, int window,
                     float scale, int per_qhead, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PREFILL_TC(D)                                                       \
  case D:                                                                   \
    return launch_tc<D>(q, k, v, pos, bt, q_pos, out, kn, vn, B, T, KV, G, \
                        P, page, s_n, s_page, s_kv, window, scale,         \
                        per_qhead, st);
  switch (hd) {
    PREFILL_TC(32)
    PREFILL_TC(64)
    PREFILL_TC(80)
    PREFILL_TC(96)
    PREFILL_TC(128)
  }
#undef PREFILL_TC
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
