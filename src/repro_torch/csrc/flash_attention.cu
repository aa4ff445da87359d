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
// Design: block (q tile, head, b) holds a 64-row query tile and walks the
// 64-key tiles the causal triangle and the window can reach, in order; the
// tiles wholly above the diagonal or below the window are never loaded, as
// the Pallas kernel skips its fully masked blocks. 256 threads as a 16 x 16
// grid: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3 of the tile, keys
// tx + 16 j of the key tile and output columns tx + 16 c, so its scores,
// its rows' running max / sum and its output accumulator stay in
// registers. A row's max and sum reduce over the 16 lanes of a half-warp
// with shuffles. Q, K, V and the probabilities of the tile are staged in
// shared memory (rows of Q and K padded to hd + 1 floats against bank
// conflicts).
//
// What bounds it on an H100: the causal half of the (S, S) products, about
// 2 * S^2 * hd * H FLOPs per sequence, run here in f32 on the CUDA cores
// (67 TFLOP/s peak) and fed from shared memory at about one load per two
// FMAs; the bytes (q, k, v, out once each) are far smaller. wgmma on bf16
// tiles is the later work that moves it toward the tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * kTile * (hd + 1) + kTile * hd + kTile * (kTile + 1)) *
      sizeof(float);
  cudaError_t err = paged::allow_smem(flash_kernel<T, NC>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, hd, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, int window, float scale,
              cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, out, B, S, H, KV, hd, window, scale, st);
  return launch<T, 8>(q, k, v, out, B, S, H, KV, hd, window, scale, st);
}

}  // namespace

extern "C" {

// q (B, S, H, hd), k / v (B, S, KV, hd), out (B, S, H, hd), all contiguous
// and of one type (dtype 0 = float32, 1 = bfloat16); H % KV == 0,
// hd <= 128. Returns the CUDA error code of the launch (0 == success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int KV, int hd, int window,
                    float scale, int dtype, void* stream) {
  if (hd > 128 || H % KV) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, S, H, KV, hd, window, scale, st);
  return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, window,
                                  scale, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
