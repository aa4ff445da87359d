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
// Six routes, chosen by the wrapper from the dtypes and head dim (never a
// fallback):
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
// bf16 query over an int8 pool (int8 values, (N, page, KV) f32 absmax
// scales), hd 32, 64, 80, 96 or 128: the same tensor-core kernel and tiles,
// instantiated on int8. A key tile's rows come in as int8, 16 values per
// 16-byte cp.async copy, into a two-stage staging ring; with them each
// key's s_k / 127 and s_v / 127 (the JAX package's x * (s / 127) factor,
// correctly rounded). The tile being computed is widened to one bf16 tile
// in shared memory (exact: every int8 value is a bf16 integer), so Q K^T
// and P V run on the bf16 tile routine as they do for a bf16 pool. The
// scales stay out of the products: S = (Q X_k^T) (s_k / 127) per key
// column in registers, and P' = p (s_v / 127), rounded to bf16 as the bf16
// route rounds p, feeds P V while l sums the unfolded p. Against the plain
// version's f32 arithmetic over the dequantized pool that adds one f32
// rounding per score, and P' carries the bf16 route's error model
// (ref.tc_bf16_bound, its weight (P |V|) / l of the dequantized V). A
// masked key's p is 0 before its scale is applied, so a stale scale on a
// free slot never reaches the output. The norms are (s / 127) ||x||, ||x||
// from the exact integer sum of squares.
//
// f32 query over an f32 or bf16 pool, or a bf16 query over an f32 pool (q
// widened exactly), hd 32, 64, 80, 96 or 128: tensor cores in split TF32
// (attn_tile_f32.cuh: every f32 product as three TF32 mma.sync products,
// f32 accuracy; P kept in f32). Blocks of 128 rows on 8 warps, the same
// 64-key tiles, tile marking and two-stage cp.async ring as the bf16
// route; a bf16 pool's tiles come in as bf16 and are widened to f32 in
// shared memory. When the grid is small (TINY's mixed step: 64 row tiles
// on 132 SMs) the wrapper splits each block's key tiles into nsplit
// ranges: each block writes its valid rows' un-normalised o, m and l, and
// a second kernel merges them (exp(scale (m_s - M)) weights). Every split
// range holds whole key tiles, so the per-Q-head grid, split the same way,
// still agrees bit for bit.
//
// f32 query over an int8 pool, those head dims: the same kernel; int8
// tiles come in by cp.async into a staging ring and are widened to f32 in
// shared memory as x * (s / 127) (s / 127 divided once per token), bit
// for bit the values of dequantize(), so the route is bit-equal to the f32
// route over the dequantized pool, norms included.
//
// At any other head dim, CUDA cores: an f32 query over an int8 pool takes
// the page walk below reading the int8 values and dequantizing in
// registers as x * (s / 127); an f32 query over an f32 or bf16 pool, or a
// bf16 query over an f32 pool, the page walk of paged_common.cuh (one page
// of keys per step, f32 dot products from shared memory, rows in the g * T
// + t order).
//
// What bounds it on an H100: at chunk 256 the work is about 4 * rows * hd
// FLOPs per key and the pool is read once per row tile, from L2 after the
// first; the bytes (the pages reached, q and the output once each) bound it
// on paper. The tensor-core routes keep the products off the CUDA cores and
// skip every key tile and row tile no row can use, which in a mixed step
// is most of the decode rows' T - 1 padding tokens.
//
// The f32 routes' bound: the same bytes (4 bytes a value of an f32 pool);
// 4 hd operations per valid pair at 165 TFLOP/s (495 TF32 / 3 products),
// 67 on the CUDA cores. At TINY's mixed step (hd 32, 8 x 256 rows, 49
// slots) the bytes bound it (0.0024 ms against 0.0007 of operations).
//
// The int8 routes' bound: the int8 K / V of the pages the tables reach (1
// byte a value) and their scales (4 bytes a (token, head)), positions,
// tables, q and the output, at 3.35 TB/s; 4 hd operations per valid pair
// at 989 TFLOP/s (bf16 query) or 165 (f32 query, split TF32). At
// llama-3.2-1b's mixed step
// (B 8, T 256, 49 slots of page 16) q and the output are most of it. What
// they replace: a pass over the WHOLE pool per layer and step (1 byte read,
// 4 written per value: k_dequant / v_dequant), then the CUDA-core walk
// reading 4 bytes a value of the pages reached, with f32 FMAs. The int8
// routes write no copy and read a quarter of the walk's pool bytes.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "attn_tile_f32.cuh"
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

// Shared memory of the tensor-core kernel: a bf16 pool's K / V tiles are
// the cp.async ring itself (two stages); an int8 pool's ring holds int8
// tiles and their scale factors, and one bf16 tile each of K and V is
// widened from the stage being computed.
inline size_t tc_smem_bytes(int D, int ntiles, bool int8_pool) {
  const size_t tiles =
      int8_pool ? (size_t)(kRowsP + 2 * tc::kKeys) * D * 2 +
                      (size_t)4 * tc::kKeys * D
                : (size_t)(kRowsP + 4 * tc::kKeys) * D * 2;
  const size_t words =
      (size_t)(int8_pool ? 6 : 2) * tc::kKeys + 3 * kRowsP + ntiles;
  return tiles + words * sizeof(int);
}

template <int D, typename TP>
__global__ void __launch_bounds__(kThreadsP)
    paged_prefill_tc_kernel(const tc::bf16* __restrict__ q,
                            const TP* __restrict__ kpool,
                            const TP* __restrict__ vpool,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ pos,
                            const int* __restrict__ bt,
                            const int* __restrict__ q_pos,
                            tc::bf16* __restrict__ out, float* kn, float* vn,
                            int Tq, int KV, int G, int P, int page,
                            long long s_n, long long s_page, long long s_kv,
                            int window, float scale, int per_qhead) {
  constexpr bool kInt8 = std::is_same_v<TP, int8_t>;
  constexpr int kBf16Stages = kInt8 ? 1 : 2;  // bf16 K / V tiles
  constexpr int kI8 = kInt8 ? 2 * tc::kKeys : 0;  // int8 ring: keys
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tc::bf16* sQ = reinterpret_cast<tc::bf16*>(smem_raw);  // kRowsP x D
  tc::bf16* sK = sQ + kRowsP * D;               // kBf16Stages x kKeys x D
  tc::bf16* sV = sK + kBf16Stages * tc::kKeys * D;
  int8_t* s8K = reinterpret_cast<int8_t*>(sV + kBf16Stages * tc::kKeys * D);
  int8_t* s8V = s8K + kI8 * D;                  // int8: 2 x kKeys x D each
  float* s_kf = reinterpret_cast<float*>(s8V + kI8 * D);  // int8: s_k / 127
  float* s_vf = s_kf + kI8;                     // int8: s_v / 127
  int* s_kpos = reinterpret_cast<int*>(s_vf + kI8);  // 2 x kKeys
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
    auto row = [&](const TP* base) {
      return [=](int j) -> const TP* {
        const int key = k0 + j;
        if (key >= nkeys) return nullptr;
        const int p = key / page;
        const long long phys = max(btr[p], 0);
        return base + phys * s_n + (long long)(key - p * page) * s_page +
               (long long)kv * s_kv;
      };
    };
    if constexpr (kInt8) {
      tc::load_tile_i8<D>(s8K + stage * tc::kKeys * D, tc::kKeys, kpool,
                          row(kpool));
      tc::load_tile_i8<D>(s8V + stage * tc::kKeys * D, tc::kKeys, vpool,
                          row(vpool));
    } else {
      tc::load_tile<D>(sK + stage * tc::kKeys * D, tc::kKeys, kpool,
                       row(kpool));
      tc::load_tile<D>(sV + stage * tc::kKeys * D, tc::kKeys, vpool,
                       row(vpool));
    }
    if (tid < tc::kKeys) {
      const int key = k0 + tid;
      int kq = -1;  // unmapped slots and keys past the table: masked
      float kf = 0.f, vf = 0.f;
      if (key < nkeys) {
        const int p = key / page, phys = btr[p];
        if (phys >= 0) kq = pos[(long long)phys * page + (key - p * page)];
        if constexpr (kInt8) {  // the page the values come from (norms)
          const long long si =
              ((long long)max(phys, 0) * page + (key - p * page)) * KV + kv;
          kf = kscale[si] / 127.f;
          vf = vscale[si] / 127.f;
        }
      }
      s_kpos[stage * tc::kKeys + tid] = kq;
      if constexpr (kInt8) {
        s_kf[stage * tc::kKeys + tid] = kf;
        s_vf[stage * tc::kKeys + tid] = vf;
      }
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
    const tc::bf16* tK = sK + (kInt8 ? 0 : stage) * tc::kKeys * D;
    const tc::bf16* tV = sV + (kInt8 ? 0 : stage) * tc::kKeys * D;
    if constexpr (kInt8) {
      tc::widen_tile<D>(sK, s8K + stage * tc::kKeys * D, tc::kKeys);
      tc::widen_tile<D>(sV, s8V + stage * tc::kKeys * D, tc::kKeys);
      __syncthreads();
    }
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
        float nk = sqrtf(sk), nv = sqrtf(sv);
        if constexpr (kInt8) {  // sums of integer squares: exact in f32
          nk *= s_kf[stage * tc::kKeys + j];
          nv *= s_vf[stage * tc::kKeys + j];
        }
        kn[at] = nk;
        vn[at] = nv;
      }
    }
    if (attend && warp_rows) {
      const int* kpos = s_kpos + stage * tc::kKeys;
      auto valid = [&](int hh, int j) {
        return paged::pair_valid(true, kpos[j], qp[hh], window);
      };
      float s[8][4];
      tc::qk<D>(s, sQ, r0, tK);
      if constexpr (kInt8) {
        const float* vf = s_vf + stage * tc::kKeys;
        tc::scale_cols(s, s_kf + stage * tc::kKeys);
        tc::softmax_pv<D>(st, s, tV, scale, valid,
                          [&](int j, float p) { return p * vf[j]; });
      } else {
        tc::softmax_pv<D>(st, s, tV, scale, valid);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();
  store(st);
}

template <int D, typename TP>
int launch_tc(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* pos, const int* bt,
              const int* q_pos, void* out, float* kn, float* vn, int B,
              int Tq, int KV, int G, int P, int page, long long s_n,
              long long s_page, long long s_kv, int window, float scale,
              int per_qhead, cudaStream_t stream) {
  const int ntiles = (P * page + tc::kKeys - 1) / tc::kKeys;
  const size_t smem =
      tc_smem_bytes(D, ntiles, std::is_same_v<TP, int8_t>);
  cudaError_t err =
      paged::allow_smem(paged_prefill_tc_kernel<D, TP>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = per_qhead ? Tq : G * Tq;
  const dim3 grid((rows + kRowsP - 1) / kRowsP, per_qhead ? KV * G : KV, B);
  paged_prefill_tc_kernel<D, TP><<<grid, kThreadsP, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const TP*>(k),
      static_cast<const TP*>(v), ks, vs, pos, bt, q_pos,
      static_cast<tc::bf16*>(out), per_qhead ? nullptr : kn,
      per_qhead ? nullptr : vn, Tq, KV, G, P, page, s_n, s_page, s_kv,
      window, scale, per_qhead);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on tensor cores (split TF32): an f32 query over an f32, bf16 or int8
// pool, or a bf16 query over an f32 pool
// ---------------------------------------------------------------------------

constexpr int kRowsF = 128;                   // rows per block
constexpr int kThreadsF = 32 * kRowsF / 16;   // a warp per 16 rows
constexpr int kNormLanes = kThreadsF / tf::kKeys;  // lanes per key's norms

// Shared memory of the f32 tensor-core kernel: the f32 query tile; an f32
// pool's K / V tiles are the cp.async ring itself (two stages); a bf16 or
// int8 pool's ring holds its tiles as they are (and an int8 pool's s / 127
// factors), and one f32 tile each of K and V is widened from the stage
// being computed.
inline size_t f32_smem_bytes(int D, int ntiles, int pool_bytes) {
  const bool staged = pool_bytes != 4;
  const size_t floats = (size_t)kRowsF * D +
                        (size_t)(staged ? 1 : 2) * tf::kKeys * (2 * D + 4);
  const size_t stage = staged ? (size_t)4 * tf::kKeys * D * pool_bytes : 0;
  const size_t words =
      (size_t)(pool_bytes == 1 ? 6 : 2) * tf::kKeys + 3 * kRowsF + ntiles;
  return floats * sizeof(float) + stage + words * sizeof(int);
}

// Sum of squares of a row's D / kNormLanes values from column c0.
template <int D, bool V>
__device__ __forceinline__ float part_row_squares(const float* tile, int r,
                                                  int c0) {
  static_assert(D % (4 * kNormLanes) == 0, "whole 4-column chunks per lane");
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / kNormLanes; c += 4) {
    const float4 x =
        *reinterpret_cast<const float4*>(tile + tf::at<D, V>(r, c0 + c));
    s += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
  }
  return s;
}

// Row r's D / 4 chunks of 4 query values: cp.async for an f32 query,
// widened from bf16 (exactly) by plain loads otherwise.
template <int D, class RowPtr>
__device__ __forceinline__ void load_q(float* sQ, int rows, const float* q,
                                       RowPtr row_ptr) {
  tf::load_tile<D, false>(sQ, rows, q, row_ptr);
}
template <int D, class RowPtr>
__device__ __forceinline__ void load_q(float* sQ, int rows,
                                       const tc::bf16* q, RowPtr row_ptr) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c = 4 * (i - r * (D / 4));
    const tc::bf16* src = row_ptr(r);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src) {
      const uint2 u = *reinterpret_cast<const uint2*>(src + c);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      x = make_float4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<float4*>(sQ + tf::kidx<D>(r, c)) = x;
  }
}

__device__ __forceinline__ void put4(float* p, float x0, float x1, float x2,
                                     float x3) {
  *reinterpret_cast<float4*>(p) = make_float4(x0, x1, x2, x3);
}
__device__ __forceinline__ void put4(tc::bf16* p, float x0, float x1,
                                     float x2, float x3) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p);
  o[0] = __floats2bfloat162_rn(x0, x1);
  o[1] = __floats2bfloat162_rn(x2, x3);
}

// The f32 tensor-core kernel (G-fold, or per-Q-head on request): the bf16
// kernel's key tiles and tile marking on the split-TF32 tile routine
// (attn_tile_f32.cuh), in blocks of 128 rows on 8 warps of one m-tile
// (flash_attention's shape: twice the bf16 kernel's rows halves the K / V
// each block re-reads, and at D <= 64 two blocks fit an SM; two m-tiles a
// warp spilled here, at 255 registers). A grid of nsplit > 1 splits each
// block's key tiles into nsplit ranges (blockIdx.x = row tile * nsplit +
// split) and writes each valid row's un-normalised o, m and l of its range
// to `part` (merge_splits_kernel combines them); nsplit 1 writes the
// output itself.
template <int D, typename TQ, typename TP>
__global__ void __launch_bounds__(kThreadsF, D <= 64 ? 2 : 1)
    paged_prefill_f32_kernel(const TQ* __restrict__ q,
                             const TP* __restrict__ kpool,
                             const TP* __restrict__ vpool,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale,
                             const int* __restrict__ pos,
                             const int* __restrict__ bt,
                             const int* __restrict__ q_pos,
                             TQ* __restrict__ out, float* __restrict__ part,
                             float* kn, float* vn, int B, int Tq, int KV,
                             int G, int P, int page, long long s_n,
                             long long s_page, long long s_kv, int window,
                             float scale, int per_qhead, int nsplit) {
  constexpr bool kInt8 = std::is_same_v<TP, int8_t>;
  constexpr bool kStaged = !std::is_same_v<TP, float>;
  constexpr int kStages = kStaged ? 1 : 2;       // f32 K / V tiles
  constexpr int kStg = kStaged ? 2 * tf::kKeys : 0;  // staging ring: keys
  constexpr int kF = kInt8 ? 2 * tf::kKeys : 0;      // int8: s / 127
  constexpr int kVRow = D + 4;
  constexpr int MT = 1;  // 16-row m-tiles a warp owns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // kRowsF x D
  float* sK = sQ + kRowsF * D;                     // kStages x kKeys x D
  float* sV = sK + kStages * tf::kKeys * D;        // kStages x kKeys x kVRow
  TP* stK = reinterpret_cast<TP*>(sV + kStages * tf::kKeys * kVRow);
  TP* stV = stK + kStg * D;                        // staged: 2 x kKeys x D
  float* s_kf = reinterpret_cast<float*>(stV + kStg * D);
  float* s_vf = s_kf + kF;
  int* s_kpos = reinterpret_cast<int*>(s_vf + kF);  // 2 x kKeys
  int* s_qpos = s_kpos + 2 * tf::kKeys;  // per row; -1 == padding
  int* s_tok = s_qpos + kRowsF;          // per row: token, -1 past the chunk
  int* s_head = s_tok + kRowsF;          // per row: query head
  int* s_tiles = s_head + kRowsF;        // live flag per key tile, then list
  __shared__ int s_qmin, s_qmax, s_count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / nsplit, split = blockIdx.x - tile * nsplit;
  const int b = blockIdx.z;
  const int H = KV * G;
  const int kv = per_qhead ? blockIdx.y / G : blockIdx.y;
  const int nkeys = P * page;
  const int ntiles = (nkeys + tf::kKeys - 1) / tf::kKeys;
  const int per = (ntiles + nsplit - 1) / nsplit;  // key tiles per split
  const int kt0 = split * per, kt1 = min(ntiles, kt0 + per);
  const bool norms = kn != nullptr && tile == 0;
  const int* btr = bt + (long long)b * P;

  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = -1;
  }
  for (int i = kt0 + tid; i < kt1; i += blockDim.x) s_tiles[i - kt0] = norms;
  __syncthreads();
  if (tid < kRowsF) {
    const int r = tile * kRowsF + tid;
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
  const int r0 = warp * 16 * MT, g = lane >> 2;  // row 16 mt + g + 8 h
  tf::Rows<D, MT> st;
  st.init();
  auto store = [&]() {
    if (nsplit == 1) {
      st.store([&](int mt, int hh, int c, float x0, float x1, float x2,
                   float x3) {
        const int r = r0 + 16 * mt + g + 8 * hh, t = s_tok[r];
        if (t >= 0)
          put4(out + (((long long)b * Tq + t) * H + s_head[r]) * D + c, x0,
               x1, x2, x3);
      });
      return;
    }
    // a split: the valid rows' o, m, l at their folded row (g * T + t)
    auto slot = [&](int r) {
      return (((long long)split * B + b) * KV + kv) * G * Tq +
             (long long)(s_head[r] - kv * G) * Tq + s_tok[r];
    };
    st.store_raw([&](int mt, int hh, int c, float x0, float x1, float x2,
                     float x3) {
      const int r = r0 + 16 * mt + g + 8 * hh;
      if (s_qpos[r] >= 0) put4(part + slot(r) * D + c, x0, x1, x2, x3);
    });
    if ((lane & 3) == 0) {
      float* ml = part + (long long)nsplit * B * KV * G * Tq * D;
      for (int mt = 0; mt < MT; ++mt)
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 16 * mt + g + 8 * hh;
          if (s_qpos[r] >= 0) {
            ml[2 * slot(r)] = st.m[mt][hh];
            ml[2 * slot(r) + 1] = st.l[mt][hh];
          }
        }
    }
  };
  if (!attend && !norms) {  // padding rows only
    if (nsplit == 1) store();
    return;
  }

  // mark the key tiles of this split that hold a key some row can see
  if (attend && !norms) {
    for (int key = kt0 * tf::kKeys + tid; key < min(nkeys, kt1 * tf::kKeys);
         key += blockDim.x) {
      const int p = key / page, phys = btr[p];
      if (phys < 0) continue;
      const int kq = pos[(long long)phys * page + (key - p * page)];
      if (kq >= 0 && kq <= qmax && (window <= 0 || kq > qmin - window))
        s_tiles[key / tf::kKeys - kt0] = 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int n = 0;
    for (int i = kt0; i < kt1; ++i)
      if (s_tiles[i - kt0]) s_tiles[n++] = i;
    s_count = n;
  }
  __syncthreads();
  const int n = s_count;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * tf::kKeys;
    auto row = [&](const TP* base) {
      return [=](int j) -> const TP* {
        const int key = k0 + j;
        if (key >= nkeys) return nullptr;
        const int p = key / page;
        const long long phys = max(btr[p], 0);
        return base + phys * s_n + (long long)(key - p * page) * s_page +
               (long long)kv * s_kv;
      };
    };
    if constexpr (kStaged) {
      tf::stage_tile<D>(stK + stage * tf::kKeys * D, tf::kKeys, kpool,
                        row(kpool));
      tf::stage_tile<D>(stV + stage * tf::kKeys * D, tf::kKeys, vpool,
                        row(vpool));
    } else {
      tf::load_tile<D, false>(sK + stage * tf::kKeys * D, tf::kKeys, kpool,
                              row(kpool));
      tf::load_tile<D, true>(sV + stage * tf::kKeys * kVRow, tf::kKeys,
                             vpool, row(vpool));
    }
    if (tid < tf::kKeys) {
      const int key = k0 + tid;
      int kq = -1;  // unmapped slots and keys past the table: masked
      float kf = 0.f, vf = 0.f;
      if (key < nkeys) {
        const int p = key / page, phys = btr[p];
        if (phys >= 0) kq = pos[(long long)phys * page + (key - p * page)];
        if constexpr (kInt8) {  // the page the values come from (norms)
          const long long si =
              ((long long)max(phys, 0) * page + (key - p * page)) * KV + kv;
          kf = kscale[si] / 127.f;
          vf = vscale[si] / 127.f;
        }
      }
      s_kpos[stage * tf::kKeys + tid] = kq;
      if constexpr (kInt8) {
        s_kf[stage * tf::kKeys + tid] = kf;
        s_vf[stage * tf::kKeys + tid] = vf;
      }
    }
  };

  int qp[MT][2];
  bool mine = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      qp[mt][hh] = s_qpos[r0 + 16 * mt + g + 8 * hh];
      mine |= qp[mt][hh] >= 0;
    }
  const bool warp_rows = __any_sync(0xffffffffu, mine);
  if (attend)
    load_q<D>(sQ, kRowsF, q, [&](int r) -> const TQ* {
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
    const float* tK = sK + (kStaged ? 0 : stage) * tf::kKeys * D;
    const float* tV = sV + (kStaged ? 0 : stage) * tf::kKeys * kVRow;
    if constexpr (kStaged) {
      tf::widen_tile<D, false>(sK, stK + stage * tf::kKeys * D, tf::kKeys,
                               s_kf + stage * tf::kKeys);
      tf::widen_tile<D, true>(sV, stV + stage * tf::kKeys * D, tf::kKeys,
                              s_vf + stage * tf::kKeys);
      __syncthreads();
    }
    if (norms) {  // f32 sums of the f32 tile: kNormLanes lanes per key
      const int j = tid / kNormLanes, part = tid % kNormLanes;
      const int c0 = part * (D / kNormLanes);
      float sk = part_row_squares<D, false>(tK, j, c0);
      float sv = part_row_squares<D, true>(tV, j, c0);
#pragma unroll
      for (int o = 1; o < kNormLanes; o <<= 1) {
        sk += __shfl_xor_sync(0xffffffffu, sk, o);
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
      }
      const int key = kt * tf::kKeys + j;
      if (!part && key < nkeys) {
        const long long at = ((long long)b * KV + kv) * nkeys + key;
        kn[at] = sqrtf(sk);
        vn[at] = sqrtf(sv);
      }
    }
    if (attend && warp_rows) {
      const int* kpos = s_kpos + stage * tf::kKeys;
      float s[MT][8][4];
      tf::qk<D, MT>(s, sQ, r0, tK);
      tf::softmax_pv<D, MT>(st, s, tV, scale, [&](int mt, int hh, int j) {
        return paged::pair_valid(true, kpos[j], qp[mt][hh], window);
      });
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  tc::cp_async_wait<0>();
  store();
}

// Merge the key-range splits of paged_prefill_f32_kernel: per valid row,
// o = sum_s w_s o_s / max(sum_s w_s l_s, 1e-30), w_s = exp(scale (m_s -
// M)) (exactly 1 for the splits at the row max M); padding rows give 0.
// One thread per 4 columns of a (b, t, h) row.
template <typename TQ>
__global__ void merge_splits_kernel(const float* __restrict__ part,
                                    const int* __restrict__ q_pos,
                                    TQ* __restrict__ out, int B, int Tq,
                                    int KV, int G, int D, int nsplit,
                                    float scale) {
  const int H = KV * G, C = D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Tq * H * C) return;
  const int c = 4 * (int)(i % C);
  const long long row = i / C;  // (b, t, h)
  const int h = (int)(row % H);
  const int t = (int)(row / H % Tq), b = (int)(row / H / Tq);
  TQ* o = out + row * D + c;
  if (q_pos[(long long)b * Tq + t] < 0) {
    put4(o, 0.f, 0.f, 0.f, 0.f);
    return;
  }
  const long long rows = (long long)B * KV * G * Tq;
  const long long r =
      ((long long)b * KV + h / G) * G * Tq + (long long)(h % G) * Tq + t;
  const float* ml = part + (long long)nsplit * rows * D;
  float mx = tf::kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[2 * (s * rows + r)]);
  const float cc = scale * 1.4426950408889634f;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const float m = ml[2 * (s * rows + r)];
    const float w = m == mx ? 1.f : tc::exp2_approx((m - mx) * cc);
    l += w * ml[2 * (s * rows + r) + 1];
    const float4 x =
        *reinterpret_cast<const float4*>(part + (s * rows + r) * D + c);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float den = fmaxf(l, 1e-30f);
  put4(o, acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

template <int D, typename TQ, typename TP>
int launch_f32(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* pos, const int* bt,
               const int* q_pos, void* out, float* part, float* kn,
               float* vn, int B, int Tq, int KV, int G, int P, int page,
               long long s_n, long long s_page, long long s_kv, int window,
               float scale, int per_qhead, int nsplit, cudaStream_t stream) {
  const int ntiles = (P * page + tf::kKeys - 1) / tf::kKeys;
  if (nsplit < 1 || nsplit > ntiles || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes(D, ntiles, (int)sizeof(TP));
  cudaError_t err =
      paged::allow_smem(paged_prefill_f32_kernel<D, TQ, TP>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = per_qhead ? Tq : G * Tq;
  const dim3 grid((rows + kRowsF - 1) / kRowsF * nsplit,
                  per_qhead ? KV * G : KV, B);
  paged_prefill_f32_kernel<D, TQ, TP><<<grid, kThreadsF, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k),
      static_cast<const TP*>(v), ks, vs, pos, bt, q_pos,
      static_cast<TQ*>(out), part, per_qhead ? nullptr : kn,
      per_qhead ? nullptr : vn, B, Tq, KV, G, P, page, s_n, s_page, s_kv,
      window, scale, per_qhead, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long threads = (long long)B * Tq * KV * G * (D / 4);
  merge_splits_kernel<TQ><<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(part, q_pos, static_cast<TQ*>(out), B,
                                      Tq, KV, G, D, nsplit, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 query (f32, bf16 or int8 pool), or a bf16 query over an f32 pool, on
// CUDA cores (head dims without a tensor-core tile)
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

// CUDA-core route (a head dim without a tensor-core tile; the wrapper
// sends no other). q (B, T, H, hd) contiguous, H = KV * G; k/v pool
// (N, page, KV, hd) with element strides s_n, s_page, s_kv and hd
// contiguous; ks / vs the int8 pool's (N, page, KV) contiguous f32 scales
// (null for a float pool); pos (N, page) int32; bt (B, P) int32; q_pos
// (B, T) int32 (-1 == padding). out (B, T, H, hd) in q's type; kn / vn
// (B, KV, P, page) f32 when not null (G-fold only). tile_rows: the rows
// one block holds (folded rows, or one head's tokens when per_qhead).
// q_dtype / pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8; the pairs
// taken are f32 / f32, f32 / bf16, bf16 / f32 and f32 / int8 (the
// tensor-core routes' bf16 / bf16 and bf16 / int8 are paged_prefill_tc's
// and are refused here). Returns the CUDA error code of the launch
// (0 == success).
int paged_prefill(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* pos,
                  const int* bt, const int* q_pos, void* out, float* kn,
                  float* vn, int B, int T, int KV, int G, int hd, int P,
                  int page, long long s_n, long long s_page, long long s_kv,
                  int tile_rows, int window, float scale, int q_dtype,
                  int pool_dtype, int per_qhead, void* stream) {
  const paged::Pool pool{k,    v,    ks,   vs, pos, s_n,
                         s_page, s_kv, page, hd, KV};
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
  if (q_dtype == 0 && pool_dtype == 2 && ks != nullptr && vs != nullptr)
    return launch<float, int8_t>(pq, q, pool, bt, q_pos, out, kn, vn, B, T,
                                 KV, G, P, tile_rows, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-core routes: a bf16 query over a bf16 pool (pool_dtype 1) or over
// an int8 pool with its scales ks / vs (pool_dtype 2), hd 32, 64, 80, 96 or
// 128, every pool row 16-byte aligned (s_n, s_page, s_kv whole 16 bytes).
// Arguments as paged_prefill; folded row r is query head kv * G + r / T,
// token r % T.
int paged_prefill_tc(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* pos,
                     const int* bt, const int* q_pos, void* out, float* kn,
                     float* vn, int B, int T, int KV, int G, int hd, int P,
                     int page, long long s_n, long long s_page,
                     long long s_kv, int window, float scale, int pool_dtype,
                     int per_qhead, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8_pool = pool_dtype == 2;
  if (pool_dtype != 1 && !(int8_pool && ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
#define PREFILL_TC(D)                                                        \
  case D:                                                                    \
    return int8_pool                                                         \
               ? launch_tc<D, int8_t>(q, k, v, ks, vs, pos, bt, q_pos, out,  \
                                      kn, vn, B, T, KV, G, P, page, s_n,     \
                                      s_page, s_kv, window, scale,           \
                                      per_qhead, st)                         \
               : launch_tc<D, tc::bf16>(q, k, v, nullptr, nullptr, pos, bt,  \
                                        q_pos, out, kn, vn, B, T, KV, G, P,  \
                                        page, s_n, s_page, s_kv, window,     \
                                        scale, per_qhead, st);
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

// f32 tensor-core routes, hd 32, 64, 80, 96 or 128: an f32 query over an
// f32 or bf16 pool (pool_dtype 0 / 1) or over an int8 pool with its scales
// (pool_dtype 2), or a bf16 query (q_dtype 1) over an f32 pool; every pool
// row and q row 16-byte aligned. Arguments as paged_prefill; nsplit key
// ranges per block (1 <= nsplit <= the key tiles of 64), and for nsplit > 1
// `part`, nsplit * B * KV * G * T * (hd + 2) f32 of scratch.
int paged_prefill_f32tc(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* pos,
                        const int* bt, const int* q_pos, void* out,
                        float* kn, float* vn, int B, int T, int KV, int G,
                        int hd, int P, int page, long long s_n,
                        long long s_page, long long s_kv, int window,
                        float scale, int q_dtype, int pool_dtype,
                        int per_qhead, float* part, int nsplit,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PREFILL_F32(D, TQ, TP)                                               \
  launch_f32<D, TQ, TP>(q, k, v, ks, vs, pos, bt, q_pos, out, part, kn, vn, \
                        B, T, KV, G, P, page, s_n, s_page, s_kv, window,    \
                        scale, per_qhead, nsplit, st)
#define PREFILL_F32_HD(D)                                                    \
  case D:                                                                    \
    if (q_dtype == 0 && pool_dtype == 0) return PREFILL_F32(D, float, float); \
    if (q_dtype == 0 && pool_dtype == 1)                                     \
      return PREFILL_F32(D, float, tc::bf16);                                \
    if (q_dtype == 1 && pool_dtype == 0)                                     \
      return PREFILL_F32(D, tc::bf16, float);                                \
    if (q_dtype == 0 && pool_dtype == 2 && ks != nullptr && vs != nullptr)   \
      return PREFILL_F32(D, float, int8_t);                                  \
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    PREFILL_F32_HD(32)
    PREFILL_F32_HD(64)
    PREFILL_F32_HD(80)
    PREFILL_F32_HD(96)
    PREFILL_F32_HD(128)
  }
#undef PREFILL_F32_HD
#undef PREFILL_F32
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
