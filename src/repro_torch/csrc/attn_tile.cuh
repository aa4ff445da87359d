// Tensor-core tile routine of the bf16 attention kernels: the G-fold and
// per-Q-head paged prefill (flash_prefill.cu) and the contiguous causal
// flash attention (flash_attention.cu).
//
// Instruction choice: `mma.sync.m16n8k16` (bf16 in, f32 accumulate) fed by
// `ldmatrix` / `ldmatrix.trans` from shared memory, with K/V tiles brought
// in by `cp.async` 16-byte copies into a two-stage ring: FlashAttention-2's
// shape. `wgmma` is the only way to the card's full tensor-core rate, but it
// needs 64-row warpgroup tiles, descriptor-encoded shared-memory layouts and
// asynchronous accumulator fences; `mma.sync` keeps every fragment in a
// documented per-thread layout, so the online softmax and the masks work on
// registers directly, and the paged kernels' page gather (one 16-byte
// chunk per lane, any page size) stays simple. Moving the products to
// `wgmma` is later work.
//
// Layout. A warp owns 16 query rows; lane (g = lane / 4, t = lane % 4)
// holds rows g and g + 8. A key tile is kKeys = 64 keys. The score tile
// S = Q K^T of one warp is 8 mma n-tiles of 8 keys: s[n][0..1] are row g,
// keys 8n + 2t and 8n + 2t + 1, s[n][2..3] the same keys of row g + 8. The
// output accumulator o[d][..] has the same layout over 8-wide column
// blocks of the head dim. The scores, the online-softmax state (row max m
// and sum l, reduced over the four lanes of a row with shuffles) and o stay
// in registers; the probabilities are rounded to bf16 in registers and fed
// to P V as the A operand, without a trip through shared memory.
//
// Shared-memory tiles hold rows of D bf16 (D a multiple of 16: 32, 64, 80,
// 96 or 128) with the 16-byte chunks of row r XOR-swizzled by r % W, W the
// largest power of two up to 8 that divides the row's D / 8 chunks: the XOR
// then stays inside an aligned group of W chunks, so it never leaves the
// row. At D 64 and 128 (W 8) the eight row addresses of an ldmatrix phase
// fall in eight different bank groups; at D 32 (W 4), 80 (W 2) and 96 (W 4)
// some phases share a bank group, which costs time, not correctness.
//
// Masking: the row max starts at -1e30 and a masked score never enters it;
// its probability is set to 0 explicitly (never exp(-1e30 - m), which is 1
// for a row whose keys so far are all masked). A tile with no valid key for
// a row leaves that row's state bit for bit unchanged: m is unchanged,
// alpha is exactly 1, l gains exact zeros and the P V products add zeros.
// So a kernel may process a key tile for some rows that others could skip
// without changing their result.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;  // keys per key tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row r, column c) in a swizzled tile of D-wide rows.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(D % 16 == 0, "rows of whole 16-column mma steps");
  constexpr int C = D / 8;
  constexpr int W = C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : 2;
  return r * D + (((c >> 3) ^ (r & (W - 1))) << 3) + (c & 7);
}

// 16-byte asynchronous copy; zero-fills the destination when !valid (src
// must still be a valid global address, it is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of D bf16 into a swizzled tile, one 16-byte chunk per
// thread and step: row_ptr(r) gives the row's global address, or nullptr
// for a row to zero-fill (then `fallback`, any valid address, is passed).
template <int D, class RowPtr>
__device__ __forceinline__ void load_tile(bf16* tile, int rows,
                                          const bf16* fallback,
                                          RowPtr row_ptr) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const bf16* src = row_ptr(r);
    cp_async16(tile + swz<D>(r, c * 8), src ? src + c * 8 : fallback,
               src != nullptr);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, column fragment).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2 ulp; 2^-huge == +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online-softmax state of one warp's 16 rows (this lane's share).
template <int D>
struct Rows {
  float o[D / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
    }
  }

  // Row g + 8 h, columns 8 d + 2 t and 8 d + 2 t + 1 of the normalised
  // output acc / max(l, 1e-30), handed to put(h, column, x0, x1).
  template <class Put>
  __device__ __forceinline__ void store(Put put) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        put(h, 8 * d + 2 * t, o[d][2 * h] / den, o[d][2 * h + 1] / den);
    }
  }
};

// s = Q K^T for the warp's rows row0 .. row0 + 15 of the swizzled query
// tile sQ against the kKeys keys of the swizzled key tile sK.
template <int D>
__device__ __forceinline__ void qk(float (&s)[8][4], const bf16* sQ,
                                   int row0, const bf16* sK) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const int a_row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, sQ + swz<D>(a_row, kk * 16 + a_col));
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t b[4];
      ldsm4(b, sK + swz<D>(n2 * 16 + b_row, kk * 16 + b_col));
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// Fold one key tile into the rows' state: mask the scores (valid(h, j):
// row g + 8 h may see key j of the tile), update m and l in f32, rescale o,
// and add P V with P rounded to bf16 and V from the swizzled value tile sV.
// m is kept on the unscaled dot products (scale > 0 keeps the order), and
// exp(scale (x - m)) is computed as 2^(x c - m c), c = scale log2(e): one
// fused multiply-add and one special-function op per score.
template <int D, class Valid>
__device__ __forceinline__ void softmax_pv(Rows<D>& st, float (&s)[8][4],
                                           const bf16* sV, float scale,
                                           Valid valid) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const float c = scale * 1.4426950408889634f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t vm = 0;
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (valid(h, 8 * n + 2 * t + e)) {
          vm |= 1u << (2 * n + e);
          mx = fmaxf(mx, s[n][2 * h + e]);
        }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float alpha =
        m_new == st.m[h] ? 1.f : exp2_approx((st.m[h] - m_new) * c);
    const float mc = m_new * c;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * h + e];
        x = (vm >> (2 * n + e)) & 1u ? exp2_approx(fmaf(x, c, -mc)) : 0.f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    st.l[h] = alpha * st.l[h] + sum;
    st.m[h] = m_new;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      st.o[d][2 * h] *= alpha;
      st.o[d][2 * h + 1] *= alpha;
    }
  }
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t b[4];
      ldsm4_t(b, sV + swz<D>(kk * 16 + v_row, d2 * 16 + v_col));
      mma(st.o[2 * d2], a, b[0], b[1]);
      mma(st.o[2 * d2 + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace tc
