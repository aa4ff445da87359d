// Contiguous causal GQA flash attention with an optional sliding window.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` of the JAX
// package (src/repro/kernels/flash_prefill.py, body `_flash_kernel`), the
// attention of the one-shot prefill (`forward_prefill`).
//
// What it computes: q (B, S, H, hd), k and v (B, S, KV, hd), H = G * KV;
// query i of head h attends keys j <= i (and j > i - window when window > 0)
// of KV head h / G, causal by INDEX as in the JAX kernel. Online softmax with
// -1e30 for masked scores; the output is acc / max(l, 1e-30) in q's type.
//
// Three routes, chosen by the wrapper from the dtype and head dim (never a
// fallback):
//
// bf16, hd 32, 64, 80, 96 or 128: tensor cores (attn_tile.cuh: mma.sync
// m16n8k16 with ldmatrix, cp.async K/V ring of two stages). Block (head,
// b, query tile) holds 128 query rows on 8 warps of 16 rows; the query
// tiles are launched
// longest first (the last tiles of the causal triangle see the most keys).
// It walks the 64-key tiles the triangle and the window reach, loading tile
// i + 1 while it computes tile i; tiles wholly above the diagonal or below
// the window are never loaded, and a warp whose 16 rows see no key of a
// tile skips its products. Only those edge tiles get the index mask.
//
// f32, hd 32, 64, 80, 96 or 128: tensor cores in split TF32
// (attn_tile_f32.cuh: each f32 product as three TF32 mma.sync products,
// f32 accuracy, P kept in f32), on the bf16 route's blocks of 128 rows,
// longest first, and reachable 64-key tiles with the same skips and edge
// masks; K / V come by cp.async into a two-stage f32 ring.
//
// f32 at any other hd <= 128: CUDA cores. Block (q tile, head, b) holds a
// 64-row query tile and
// walks the same reachable 64-key tiles in order. 256 threads as a 16 x 16
// grid: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 of the tile, keys
// tx + 16 j of the key tile and output columns tx + 16 c, so its scores,
// its rows' running max / sum and its output accumulator stay in
// registers. A row's max and sum reduce over the 16 lanes of a half-warp
// with shuffles. Q, K, V and the probabilities of the tile are staged in
// shared memory (rows of Q and K padded to hd + 1 floats against bank
// conflicts).
//
// What bounds it on an H100: the causal half of the (S, S) products, about
// 2 * S^2 * hd * H FLOPs per sequence; the bytes (q, k, v, out once each)
// are far smaller. The bf16 route runs them on the tensor cores (989
// TFLOP/s dense peak with wgmma; mma.sync reaches a fraction of it), the
// f32 tensor-core route at 495 / 3 = 165 TFLOP/s (three TF32 products per
// f32 one), the CUDA-core route at 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "attn_tile_f32.cuh"
#include "paged_common.cuh"

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16

template <typename T, int NC>   // NC: 16-wide output column chunks, hd <= 16 NC
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                     // kTile x (hd + 1)
  float* Ks = Qs + kTile * ld;          // kTile x (hd + 1)
  float* Vs = Ks + kTile * ld;          // kTile x hd
  float* Ps = Vs + kTile * hd;          // kTile x (kTile + 1)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = blockIdx.x * kTile;
  for (int i = tid; i < kTile * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    Qs[r * ld + d] = s < S ? paged::to_float(
        q[(((long long)b * S + s) * H + h) * hd + d]) : 0.f;
  }
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = paged::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + kTile, S) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += kTile) {
    if (window > 0 && k0 + kTile - 1 <= q0 - window) continue;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int s = k0 + r;
      const long long off = (((long long)b * S + s) * KV + kvh) * hd + d;
      Ks[r * ld + d] = s < S ? paged::to_float(k[off]) : 0.f;
      Vs[r * hd + d] = s < S ? paged::to_float(v[off]) : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool valid[4];
      float mx = paged::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        valid[j] = kj < S && kj <= qi && (window <= 0 || kj > qi - window);
        sc[i][j] = valid[j] ? sc[i][j] * scale : paged::kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (kTile + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kTile + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < hd ? Vs[j * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        out[(((long long)b * S + s) * H + h) * hd + d] =
            paged::from_float<T>(acc[i][c] * inv_l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kRowsTC = 128;               // query rows per block
constexpr int kThreadsTC = 32 * kRowsTC / 16;

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_tc_kernel(const tc::bf16* __restrict__ q,
                    const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v, tc::bf16* __restrict__ out,
                    int S, int H, int KV, int window, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  tc::bf16* sQ = reinterpret_cast<tc::bf16*>(smem_raw);   // kRowsTC x D
  tc::bf16* sK = sQ + kRowsTC * D;                         // 2 x kKeys x D
  tc::bf16* sV = sK + 2 * tc::kKeys * D;                   // 2 x kKeys x D
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRowsTC;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const int i0 = q0 + r0 + (lane >> 2);   // this lane's rows: i0, i0 + 8

  const int kt_last = (min(q0 + kRowsTC, S) - 1) / tc::kKeys;
  const int kt_first =
      window > 0 ? max(0, q0 - window + 1) / tc::kKeys : 0;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * tc::kKeys;
    auto row = [&](const tc::bf16* base) {
      return [=](int j) -> const tc::bf16* {
        const int s = k0 + j;
        return s < S ? base + (((long long)b * S + s) * KV + kvh) * D
                     : nullptr;
      };
    };
    tc::load_tile<D>(sK + stage * tc::kKeys * D, tc::kKeys, k, row(k));
    tc::load_tile<D>(sV + stage * tc::kKeys * D, tc::kKeys, v, row(v));
  };
  tc::load_tile<D>(sQ, kRowsTC, q, [&](int r) -> const tc::bf16* {
    const int s = q0 + r;
    return s < S ? q + (((long long)b * S + s) * H + h) * D : nullptr;
  });
  load_kv(kt_first, 0);
  tc::cp_async_commit();

  tc::Rows<D> st;
  st.init();
  const int w_lo = q0 + r0, w_hi = w_lo + 15;   // the warp's query rows
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int stage = (kt - kt_first) & 1;
    if (kt < kt_last) {
      load_kv(kt + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * tc::kKeys;
    const bool live = w_lo < S && k0 <= w_hi &&
                      (window <= 0 || k0 + tc::kKeys - 1 > w_lo - window);
    if (live) {
      float s[8][4];
      tc::qk<D>(s, sQ, r0, sK + stage * tc::kKeys * D);
      const tc::bf16* tV = sV + stage * tc::kKeys * D;
      // only a tile that crosses the diagonal, the window's edge or the end
      // of the sequence for some row of the warp gets the index mask
      const bool inside = k0 + tc::kKeys - 1 <= w_lo && k0 + tc::kKeys <= S &&
                          (window <= 0 || k0 > w_hi - window);
      if (inside)
        tc::softmax_pv<D>(st, s, tV, scale, [](int, int) { return true; });
      else
        tc::softmax_pv<D>(st, s, tV, scale, [&](int hh, int j) {
          const int i = i0 + 8 * hh, kj = k0 + j;
          return kj < S && kj <= i && (window <= 0 || kj > i - window);
        });
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  st.store([&](int hh, int c, float x0, float x1) {
    const int i = i0 + 8 * hh;
    if (i < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((long long)b * S + i) * H + h) * D + c) =
          __floats2bfloat162_rn(x0, x1);
  });
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int window, float scale,
              cudaStream_t stream) {
  const size_t smem = (size_t)(kRowsTC + 4 * tc::kKeys) * D * 2;
  cudaError_t err = paged::allow_smem(flash_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kRowsTC - 1) / kRowsTC);
  flash_tc_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), S, H, KV,
      window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on tensor cores (split TF32)
// ---------------------------------------------------------------------------

// The bf16 kernel's blocks (128 query rows, launched longest first) and
// reachable 64-key tiles, on the split-TF32 tile routine: at D <= 64 4
// warps of two m-tiles (32 rows; two blocks then fit an SM, 253 registers
// and no spill at D 64), above 8 warps of one.
template <int D>
__host__ __device__ constexpr int f32_m_tiles() {
  return D <= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int f32_threads() {
  return 32 * kRowsTC / (16 * f32_m_tiles<D>());
}

template <int D>
__global__ void __launch_bounds__(f32_threads<D>(), D <= 64 ? 2 : 1)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int H, int KV, int window, float scale) {
  constexpr int kVRow = D + 4;
  constexpr int MT = f32_m_tiles<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // kRowsTC x D
  float* sK = sQ + kRowsTC * D;                      // 2 x kKeys x D
  float* sV = sK + 2 * tf::kKeys * D;                // 2 x kKeys x kVRow
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRowsTC;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 * MT;
  const int i0 = q0 + r0 + (lane >> 2);   // rows i0 + 16 mt + 8 h

  const int kt_last = (min(q0 + kRowsTC, S) - 1) / tf::kKeys;
  const int kt_first =
      window > 0 ? max(0, q0 - window + 1) / tf::kKeys : 0;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * tf::kKeys;
    auto row = [&](const float* base) {
      return [=](int j) -> const float* {
        const int s = k0 + j;
        return s < S ? base + (((long long)b * S + s) * KV + kvh) * D
                     : nullptr;
      };
    };
    tf::load_tile<D, false>(sK + stage * tf::kKeys * D, tf::kKeys, k, row(k));
    tf::load_tile<D, true>(sV + stage * tf::kKeys * kVRow, tf::kKeys, v,
                           row(v));
  };
  tf::load_tile<D, false>(sQ, kRowsTC, q, [&](int r) -> const float* {
    const int s = q0 + r;
    return s < S ? q + (((long long)b * S + s) * H + h) * D : nullptr;
  });
  load_kv(kt_first, 0);
  tc::cp_async_commit();

  tf::Rows<D, MT> st;
  st.init();
  const int w_lo = q0 + r0, w_hi = w_lo + 16 * MT - 1;  // the warp's rows
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int stage = (kt - kt_first) & 1;
    if (kt < kt_last) {
      load_kv(kt + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * tf::kKeys;
    const bool live = w_lo < S && k0 <= w_hi &&
                      (window <= 0 || k0 + tf::kKeys - 1 > w_lo - window);
    if (live) {
      float s[MT][8][4];
      tf::qk<D, MT>(s, sQ, r0, sK + stage * tf::kKeys * D);
      const float* tV = sV + stage * tf::kKeys * kVRow;
      // only a tile that crosses the diagonal, the window's edge or the end
      // of the sequence for some row of the warp gets the index mask
      const bool inside = k0 + tf::kKeys - 1 <= w_lo && k0 + tf::kKeys <= S &&
                          (window <= 0 || k0 > w_hi - window);
      if (inside)
        tf::softmax_pv<D, MT>(st, s, tV, scale,
                              [](int, int, int) { return true; });
      else
        tf::softmax_pv<D, MT>(st, s, tV, scale, [&](int mt, int hh, int j) {
          const int i = i0 + 16 * mt + 8 * hh, kj = k0 + j;
          return kj < S && kj <= i && (window <= 0 || kj > i - window);
        });
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  st.store([&](int mt, int hh, int c, float x0, float x1, float x2,
               float x3) {
    const int i = i0 + 16 * mt + 8 * hh;
    if (i < S)
      *reinterpret_cast<float4*>(out + (((long long)b * S + i) * H + h) * D +
                                 c) = make_float4(x0, x1, x2, x3);
  });
}

template <int D>
int launch_f32_tc(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem =
      ((size_t)kRowsTC * D + 2 * (size_t)tf::kKeys * (2 * D + 4)) *
      sizeof(float);
  cudaError_t err = paged::allow_smem(flash_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kRowsTC - 1) / kRowsTC);
  flash_f32_kernel<D><<<grid, f32_threads<D>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores (head dims without a tensor-core tile)
// ---------------------------------------------------------------------------

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, int hd, int window, float scale,
               cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kTile * (hd + 1) + kTile * hd + kTile * (kTile + 1)) *
      sizeof(float);
  cudaError_t err = paged::allow_smem(flash_kernel<float, NC>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_kernel<float, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV, hd,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k / v (B, S, KV, hd), out (B, S, H, hd), all contiguous
// and of one type; H % KV == 0. dtype 0 = float32, 1 = bfloat16;
// tensor_cores: the tensor-core route (bf16, or f32 in split TF32; hd 32,
// 64, 80, 96 or 128, 16-byte aligned rows), else f32 on the CUDA cores (hd
// <= 128). Returns the CUDA error code of the launch (0 == success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int KV, int hd, int window,
                    float scale, int dtype, int tensor_cores, void* stream) {
  if (H % KV) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
#define FLASH_TC(D)                                                          \
  case D:                                                                    \
    return dtype == 1                                                        \
               ? launch_tc<D>(q, k, v, out, B, S, H, KV, window, scale, st)  \
               : launch_f32_tc<D>(q, k, v, out, B, S, H, KV, window, scale,  \
                                  st);
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    switch (hd) {
      FLASH_TC(32)
      FLASH_TC(64)
      FLASH_TC(80)
      FLASH_TC(96)
      FLASH_TC(128)
    }
#undef FLASH_TC
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_f32<4>(q, k, v, out, B, S, H, KV, hd, window, scale, st);
  return launch_f32<8>(q, k, v, out, B, S, H, KV, hd, window, scale, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
