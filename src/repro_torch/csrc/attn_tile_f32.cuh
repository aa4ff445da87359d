// Tensor-core tile routine of the f32 attention kernels: the f32 routes of
// the G-fold and per-Q-head paged prefill (flash_prefill.cu, the
// f32_tensor_core and int8_f32_tensor_core routes) and of the contiguous
// causal flash attention (flash_attention.cu).
//
// Replaces: on those routes, the arithmetic of the Pallas TPU kernels
// `paged_flash_prefill_kernel`, `paged_flash_prefill_kernel_per_qhead` and
// `flash_attention_kernel` (src/repro/kernels/flash_prefill.py, bodies
// `_paged_prefill_kernel` and `_flash_kernel`) at f32 accuracy; before
// it, the CUDA-core page walk (paged_common.cuh) and flash body.
//
// What bounds it on an H100: 4 hd operations per valid (query, key) pair.
// On the CUDA cores that is 67 TFLOP/s of f32 FMAs, fed from shared memory
// at one load per one or two FMAs. Here every product runs on the TF32
// tensor cores (495 TFLOP/s dense) as three products, so the operations
// bound is 495 / 3 = 165 TFLOP/s; the bytes (the K / V reached, q, the
// output) at 3.35 TB/s bound the paged prefill at serving shapes.
//
// Split TF32 (3xTF32). Each f32 operand x is split as hi = tf32(x) (round
// to nearest, ties away: cvt.rna's rounding, done on the bits, `to_tf32`)
// and lo = tf32(x - hi), x - hi exact in f32, so x = hi + lo to about
// 2^-22 of x. a b is then lo_a hi_b + hi_a lo_b (first) + hi_a hi_b, each
// product of two 11-bit mantissas exact in the tensor core's f32
// accumulation; the dropped lo_a lo_b is below 2^-22 of |a b|. The error is
// about an f32 dot product's, not TF32's 2^-11 (the tensor core's f32 sums
// do not round to nearest, which softmax_pv keeps from growing with the
// key tiles). P V splits P the same way: P is never rounded to bf16.
//
// Instruction: `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`. A warp owns
// one m-tile of 16 query rows, or two (Rows' MT); in each, lane (g = lane
// / 4, t = lane % 4) of the A operand holds rows
// g, g + 8 at k-indices t and t + 4, its B operand k-indices t, t + 4 of
// column g, its accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1). A contraction may visit its index in any order as long as A
// and B agree, and the tile routine uses that twice:
//  - Q K^T: the 16 head-dim columns 16 kb .. 16 kb + 15 feed two k-steps;
//    k-index t is column 16 kb + 4 t (+ 2 in the second step) and t + 4 is
//    the column after it, so each lane reads Q and K as one 128-bit load
//    per row and 16 columns (no 32-bit transpose is needed: ldmatrix has
//    none).
//  - P V: k-index t is key 8 kk + 2 t and t + 4 is key 8 kk + 2 t + 1,
//    which is where the score accumulator already holds them: the
//    probabilities feed P V from registers with no shuffle. V's output
//    columns are permuted too: n-tile 2 j + e of the 16-column group j
//    holds column 16 j + 2 g + e at mma column g, so each lane reads V as
//    one 64-bit load per key and group, and after P V lane t holds the
//    four consecutive columns 16 j + 4 t .. + 3 of its rows.
//
// Shared-memory tiles: 64-key K / V tiles (and the query tile) come by
// 16-byte cp.async into a ring of two stages (attn_tile.cuh's copy
// helpers). Q and K rows are D floats with the 16-byte chunks of an odd
// row XOR-ed by 4 when a row holds a multiple of 8 chunks (D 32, 64, 96,
// 128; at D 80 an odd row already starts 4 bank groups on), so the two
// rows of a quarter warp's 128-bit loads use all 8 bank groups. V rows are
// padded to D + 4 floats, so the four key rows 2 t of a half warp's 64-bit
// loads fall 8 banks apart. An f32 tile of 64 keys takes twice bf16's
// shared memory: at D 128 one K + V stage is 66 KB.
//
// Softmax: as attn_tile.cuh's bf16 routine (m on the unscaled dot
// products, p = 2^(x c - m c), c = scale log2(e), by one FMA and
// `ex2.approx.ftz`): ex2.approx is within 2 ulp of 2^y, and the FMA's
// argument carries at most half an ulp of |x c| + |m c| against the plain
// version's exp(x scale - m scale), so p is within about 2^-23 (1 + |x c|
// + |m c|) of it relative, 4e-6 at scaled scores of 30. Masking keeps
// attn_tile.cuh's contract: the row max starts at -1e30 and a masked
// score never enters it, a masked key's p is set to exactly 0, and a tile
// with no valid key for a row leaves that row's state bit for bit
// unchanged (alpha exactly 1, l gains exact zeros, and P V is +0 since 0 =
// hi = lo and the pool's values are finite, so fma(o, 1, +0) is o).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace tf {

constexpr int kKeys = tc::kKeys;  // keys per key tile
constexpr float kNegInf = tc::kNegInf;

// Element offset of (row r, column c) in a Q or K tile of D-wide rows.
template <int D>
__device__ __forceinline__ int kidx(int r, int c) {
  static_assert(D % 16 == 0, "rows of whole 16-column groups");
  constexpr int kSwz = (D / 4) % 8 == 0 ? 4 : 0;
  return r * D + ((((c >> 2) ^ ((r & 1) * kSwz))) << 2) + (c & 3);
}
// Element offset of (row r, column c) in a V tile (rows padded to D + 4).
template <int D>
__device__ __forceinline__ int vidx(int r, int c) {
  return r * (D + 4) + c;
}
template <int D, bool V>
__device__ __forceinline__ int at(int r, int c) {
  return V ? vidx<D>(r, c) : kidx<D>(r, c);
}

// Copy `rows` f32 rows of D into a tile (V: the V layout, else Q / K's),
// one 16-byte chunk per thread and step: row_ptr(r) gives the row's global
// address, or nullptr for a row to zero-fill (then `fallback`, any valid
// address, is passed and not read).
template <int D, bool V, class RowPtr>
__device__ __forceinline__ void load_tile(float* tile, int rows,
                                          const float* fallback,
                                          RowPtr row_ptr) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const float* src = row_ptr(r);
    tc::cp_async16(tile + at<D, V>(r, 4 * c), src ? src + 4 * c : fallback,
                   src != nullptr);
  }
}

// Copy `rows` rows of D bf16 or int8 values as they are into a staging tile
// (row stride D values), one 16-byte chunk per thread and step; row_ptr as
// in load_tile.
template <int D, typename T, class RowPtr>
__device__ __forceinline__ void stage_tile(T* st, int rows, const T* fallback,
                                           RowPtr row_ptr) {
  constexpr int E = 16 / sizeof(T), C = D / E;
  static_assert(D % E == 0, "rows of whole 16-byte chunks");
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const T* src = row_ptr(r);
    tc::cp_async16(st + r * D + c * E, src ? src + c * E : fallback,
                   src != nullptr);
  }
}

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

// Widen a staging tile into an f32 tile: bf16 exactly; int8 as x * f[r]
// (f[r] = s / 127 of row r: the JAX package's x * (s / 127), so the tile
// holds bit for bit the values of dequantize()).
template <int D, bool V, typename T>
__device__ __forceinline__ void widen_tile(float* tile, const T* st, int rows,
                                           const float* f) {
  constexpr int E = 16 / sizeof(T), C = D / E;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const uint4 u = *reinterpret_cast<const uint4*>(st + r * D + c * E);
    const T* x = reinterpret_cast<const T*>(&u);
    float w[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      w[e] = widen(x[e]);
      if constexpr (std::is_same_v<T, int8_t>) w[e] *= f[r];
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(tile + at<D, V>(r, c * E + e)) =
          make_float4(w[e], w[e + 1], w[e + 2], w[e + 3]);
  }
}

// tf32(x): x rounded to 10 mantissa bits, to nearest with ties away from
// zero, the low 13 bits zero: cvt.rna.tf32.f32's value for every finite x
// (and inf), as an integer add of half the dropped range and a mask. On
// sm_90 cvt.rna.tf32.f32 compiles to about five instructions with its
// NaN guard, two of every split's instructions were its, and the splits
// are most of the kernels' instructions; the pools' values are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row fragment) * b (8 x 8, column fragment), TF32 in.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32, b split already: lo_a hi_b and hi_a lo_b first,
// then hi_a hi_b.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment of four f32 values, split.
__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       float a0, float a1, float a2,
                                       float a3) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}

// The online-softmax state of one warp's MT 16-row m-tiles (this lane's
// share): m-tile mt, rows g + 8 h. Every warp of a block splits the whole
// K / V tile again for its own products, and the splits are most of a
// warp's instructions; with two m-tiles a warp feeds each split K / V
// fragment to two products, where the registers hold both tiles' scores,
// o and P V (flash attention at D <= 64). o is in the permuted column
// order of P V:
// o[mt][2 j + e][0 / 1] are row g's columns 16 j + 4 t + e and 16 j + 4 t
// + 2 + e, [2 / 3] row g + 8's.
template <int D, int MT>
struct Rows {
  float o[MT][D / 8][4];
  float m[MT][2], l[MT][2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][d][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[mt][h] = kNegInf;
        l[mt][h] = 0.f;
      }
    }
  }

  // Row 16 mt + g + 8 h, columns c .. c + 3 (c = 16 j + 4 t) of the output,
  // each divided by den(mt, h), handed to put(mt, h, c, x0, x1, x2, x3).
  template <class Den, class Put>
  __device__ __forceinline__ void columns(Den den, Put put) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dv = den(mt, h);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          put(mt, h, 16 * j + 4 * t, o[mt][2 * j][2 * h] / dv,
              o[mt][2 * j + 1][2 * h] / dv, o[mt][2 * j][2 * h + 1] / dv,
              o[mt][2 * j + 1][2 * h + 1] / dv);
      }
  }
  // The normalised output acc / max(l, 1e-30).
  template <class Put>
  __device__ __forceinline__ void store(Put put) const {
    columns([&](int mt, int h) { return fmaxf(l[mt][h], 1e-30f); }, put);
  }
  // The un-normalised accumulator (a split of the key range).
  template <class Put>
  __device__ __forceinline__ void store_raw(Put put) const {
    columns([](int, int) { return 1.f; }, put);
  }
};

// s = Q K^T for the warp's rows row0 .. row0 + 16 MT - 1 of the query tile
// sQ against the kKeys keys of the key tile sK (both in kidx's layout).
template <int D, int MT>
__device__ __forceinline__ void qk(float (&s)[MT][8][4], const float* sQ,
                                   int row0, const float* sK) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {
    uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = row0 + 16 * mt + g;
      const float4 x = *reinterpret_cast<const float4*>(
          sQ + kidx<D>(r, 16 * kb + 4 * t));
      const float4 y = *reinterpret_cast<const float4*>(
          sQ + kidx<D>(r + 8, 16 * kb + 4 * t));
      split4(ah[mt][0], al[mt][0], x.x, y.x, x.y, y.y);
      split4(ah[mt][1], al[mt][1], x.z, y.z, x.w, y.w);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 k = *reinterpret_cast<const float4*>(
          sK + kidx<D>(8 * n + g, 16 * kb + 4 * t));
      uint32_t bh[4], bl[4];
      split(k.x, bh[0], bl[0]);
      split(k.y, bh[1], bl[1]);
      split(k.z, bh[2], bl[2]);
      split(k.w, bh[3], bl[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma3(s[mt][n], ah[mt][0], al[mt][0], bh[0], bh[1], bl[0], bl[1]);
        mma3(s[mt][n], ah[mt][1], al[mt][1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// Fold one key tile into the rows' state: mask the scores (valid(mt, h, j):
// row 16 mt + g + 8 h may see key j of the tile), update m and l in f32,
// and set o = alpha o + P V, P V in split TF32 with V from the value tile
// sV (vidx's layout). The softmax is attn_tile.cuh's, with p kept in f32.
// P V is summed into a fresh accumulator and folded into o by one FMA per
// element: the tensor core's f32 accumulation does not round to nearest,
// and summing every key tile's products into o directly would let its
// error grow with the number of tiles (to 2.5e-5 against the plain
// version at 13 tiles of hd 128 on the H100), where the fold keeps it to
// one tile's.
template <int D, int MT, class Valid>
__device__ __forceinline__ void softmax_pv(Rows<D, MT>& st,
                                           float (&s)[MT][8][4],
                                           const float* sV, float scale,
                                           Valid valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float c = scale * 1.4426950408889634f;
  float alpha[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t vm = 0;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (valid(mt, h, 8 * n + 2 * t + e)) {
            vm |= 1u << (2 * n + e);
            mx = fmaxf(mx, s[mt][n][2 * h + e]);
          }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = st.m[mt][h];
      const float m_new = fmaxf(m_old, mx);
      alpha[mt][h] =
          m_new == m_old ? 1.f : tc::exp2_approx((m_old - m_new) * c);
      const float mc = m_new * c;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][n][2 * h + e];
          x = (vm >> (2 * n + e)) & 1u ? tc::exp2_approx(fmaf(x, c, -mc))
                                       : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      st.l[mt][h] = alpha[mt][h] * st.l[mt][h] + sum;
      st.m[mt][h] = m_new;
    }
  float pv[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[mt][d][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKeys / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      split4(ah[mt], al[mt], s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
             s[mt][kk][3]);
    const float* v0 = sV + vidx<D>(8 * kk + 2 * t, 2 * g);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * j);
      const float2 y = *reinterpret_cast<const float2*>(v0 + D + 4 + 16 * j);
      uint32_t bh[4], bl[4];
      split(x.x, bh[0], bl[0]);
      split(y.x, bh[1], bl[1]);
      split(x.y, bh[2], bl[2]);
      split(y.y, bh[3], bl[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma3(pv[mt][2 * j], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
        mma3(pv[mt][2 * j + 1], ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st.o[mt][d][e] = fmaf(st.o[mt][d][e], alpha[mt][e >> 1], pv[mt][d][e]);
}

}  // namespace tf
