// Split-K paged decode attention with block-table indirection and the
// fused ||K|| / ||V|| score epilogue.
//
// Replaces: the Pallas TPU kernels `paged_attention_kernel` and
// `paged_attention_kernel_int8` of the JAX package
// (src/repro/kernels/paged_attention.py, bodies `_decode_step_body` /
// `_paged_attn_kernel` / `_paged_attn_kernel_int8`). The int8 variant is
// the same kernel instantiated on an int8 pool: each element is
// dequantized in registers with its (token, head) scale, so the pool is
// read at one byte per element plus one f32 scale per (token, head).
//
// What it computes: one query token per request, G query heads per KV head,
// attends over the shared page pool through the block table. Block
// (split, kv, b) folds its split's pages into an online softmax and writes
// the UN-normalised partials acc (B, KV, S, G, hd), m and l (B, KV, S, G);
// `combine_splits` in the wrapper merges the splits. With scores, every
// (b, kv, p) slot gets its per-token ||k||, ||v|| (page max(bt, 0) for
// unmapped slots, as in JAX), written by the one split that owns p.
//
// What bounds it on an H100: bytes. 2 * G FLOPs per element read is far
// below the 295 FLOP/byte of the tensor cores, so they would buy nothing;
// the design is about keeping enough bytes in flight and few instructions
// and barriers around them:
//  - Warps, not the block, walk the pages. The split's block-table entries
//    are read once into shared memory; the 4 warps then take the split's
//    pages round robin, each with its own online-softmax state (m, l, acc)
//    for up to GMAX query rows in registers. No block barrier runs inside
//    the walk; the warps' states merge through shared memory at the end.
//  - Lanes run along the head dim, one chunk each: 16 bytes of an f32 or
//    bf16 row (4 or 8 values), 8 bytes of an int8 row (8 values; 16 would
//    double the per-lane q and acc registers, 2 * GMAX * 16 floats). L =
//    hd / chunk lanes cover one token, so a warp step covers 32 / L tokens
//    of one page. q . k is reduced over the L lanes with shuffles; P V
//    accumulates per lane over its own columns.
//  - Each lane keeps its next kStages steps in flight with cp.async
//    (K and V chunks, the token's position, int8 scales) into its own
//    slots of a per-warp shared-memory ring; only the lane that copied a
//    slot reads it, so the ring needs no barrier either. At the serving
//    shape that is 8 KB (bf16) in flight per warp.
//  - int8: scale / 127 once per (token, head) and lane, then one multiply
//    per element in registers, the JAX package's x * (s / 127); the norms
//    are taken on those dequantized registers.
//  - The softmax runs in base 2: scores are scaled by scale * log2(e) and
//    exponentiated with exp2f; the row max is rescaled only when it grows.
//    m leaves the kernel in natural units (m2 * ln 2; -1e30 stays -1e30).
//  - Pages no query can see (unmapped, no position in [0, cur], out of the
//    window) are dropped from the walk before it starts, unless the score
//    epilogue needs their norms (the serving path always does).
//
// Every instantiation: q f32 or bf16; pool f32, bf16 or int8; hd 64 or 128;
// G <= 8 (rows padded to GMAX 4 or 8, the padding rows computed on q = 0
// and never written); page <= 128. The wrapper refuses anything else.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "paged_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kStages = 8;  // warp steps in flight per lane (power of 2)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  paged::Pool pool;
  const int* bt;
  const int* cur_pos;
  float* acc;
  float* m;
  float* l;
  float* kn;
  float* vn;
  int KV, G, P, S, pps, window;
  float scale;
};

// Per-lane chunk geometry of a pool type at head dim HD.
template <typename TK, int HD>
struct Chunk {
  static constexpr int E = sizeof(TK) == 1 ? 8 : 16 / (int)sizeof(TK);
  static constexpr int BYTES = E * (int)sizeof(TK);  // 16 (f32, bf16), 8
  static constexpr int L = HD / E;                   // lanes per token
  static constexpr int TPS = 32 / L;                 // tokens per warp step
};

// Asynchronous copy of BYTES (4, 8 or 16) into shared memory; zero-fills
// when !valid (src must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    tc::cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     tc::smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  }
}

// One lane's chunk from shared memory, as floats.
template <typename TK, int E>
__device__ __forceinline__ void unpack(const unsigned char* src,
                                       float (&x)[E]) {
  if constexpr (std::is_same_v<TK, float>) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
  } else if constexpr (std::is_same_v<TK, __nv_bfloat16>) {
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of an f32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(src);
    const uint32_t w[2] = {a.x, a.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)  // sign-extend byte i
      x[i] = (float)((int)(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
  }
}

template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TK, int HD, int GMAX>
__host__ __device__ constexpr size_t ring_bytes() {
  using C = Chunk<TK, HD>;
  constexpr int scales = std::is_same_v<TK, int8_t> ? 8 : 0;
  constexpr size_t ring =
      (size_t)kWarps * kStages * 32 * (2 * C::BYTES + 4 + scales);
  constexpr size_t merge = (size_t)kWarps * GMAX * (HD + 2) * 4;
  return ring > merge ? ring : merge;
}

template <typename TQ, typename TK, int HD, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const Args a) {
  using C = Chunk<TK, HD>;
  constexpr int E = C::E, L = C::L, TPS = C::TPS, BYTES = C::BYTES;
  constexpr int SLOTS = kWarps * kStages * 32;
  constexpr bool kInt8 = std::is_same_v<TK, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const paged::Pool& pool = a.pool;
  const int sp = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int grp = lane / L, c = lane % L;
  const int page = pool.page, pps = a.pps;
  const bool norms = a.kn != nullptr;
  const int cur = a.cur_pos[b];
  const long long bk = (long long)b * a.KV + kv;
  const int p0 = sp * pps;
  const int n = max(0, min(a.P, p0 + pps) - p0);

  // ring slots of this lane: stage s at [s * 32]
  const int slot = w * kStages * 32 + lane;
  unsigned char* k_ring = smem + (size_t)slot * BYTES;
  unsigned char* v_ring = smem + (size_t)(SLOTS + slot) * BYTES;
  int* pos_base = reinterpret_cast<int*>(smem + 2 * SLOTS * BYTES);
  int* pos_ring = pos_base + slot;
  float* ks_ring = reinterpret_cast<float*>(pos_base + SLOTS) + slot;
  float* vs_ring = ks_ring + SLOTS;  // int8 pools only
  int* s_bt = reinterpret_cast<int*>(smem + ring_bytes<TK, HD, GMAX>());
  int* s_list = s_bt + pps;  // local indices of the pages to walk
  int* s_count = s_list + pps;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_bt[i] = a.bt[(long long)b * a.P + p0 + i];
    s_list[i] = norms ? i : 0;
  }
  float qr[GMAX][E];
  const TQ* qb = static_cast<const TQ*>(a.q) + bk * a.G * HD + c * E;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = g < a.G ? paged::to_float(qb[g * HD + e]) * (a.scale * kLog2e)
                         : 0.f;
  __syncthreads();
  int n_list = n;
  if (!norms) {
    // keep only the pages holding a token the query can see
    for (int i = threadIdx.x; i < n * page; i += blockDim.x) {
      const int pi = i / page, phys = s_bt[pi];
      if (phys >= 0 &&
          paged::pair_valid(true, pool.pos[(long long)phys * page + i -
                                           pi * page],
                            cur, a.window))
        s_list[pi] = 1;
    }
    __syncthreads();
    if (w == 0) {  // compact the flags into the list, in place
      int cnt = 0;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool live = i < n && s_list[i];
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        if (live) s_list[cnt + __popc(bal & ((1u << lane) - 1))] = i;
        cnt += __popc(bal);
        __syncwarp();
      }
      if (lane == 0) *s_count = cnt;
    }
    __syncthreads();
    n_list = *s_count;
  }

  // this warp's pages: list entries w, w + kWarps, ...; kStages-deep ring
  const int my_pages = n_list > w ? (n_list - w + kWarps - 1) / kWarps : 0;
  const int spp = (page + TPS - 1) / TPS;
  const int n_units = my_pages * spp;
  const TK* kp = static_cast<const TK*>(pool.k);
  const TK* vp = static_cast<const TK*>(pool.v);
  int li_in = 0, st_in = 0;  // next step to load: (my page, step)
  auto fetch = [&](int stage) {
    if (li_in < my_pages) {
      const int phys = s_bt[s_list[w + li_in * kWarps]];
      const long long pg = phys >= 0 ? phys : 0;
      const int j = st_in * TPS + grp;
      const bool in = j < page;
      const long long row = pg * page + (in ? j : 0);
      const long long off = pg * pool.s_n +
                            (long long)(in ? j : 0) * pool.s_page +
                            (long long)kv * pool.s_kv + c * E;
      cp_async<BYTES>(k_ring + stage * 32 * BYTES, kp + off, in);
      cp_async<BYTES>(v_ring + stage * 32 * BYTES, vp + off, in);
      cp_async<4>(pos_ring + stage * 32, pool.pos + row, in);
      if constexpr (kInt8) {
        const long long si = row * pool.kv_heads + kv;
        cp_async<4>(ks_ring + stage * 32, pool.k_scale + si, in);
        cp_async<4>(vs_ring + stage * 32, pool.v_scale + si, in);
      }
      if (++st_in == spp) {
        st_in = 0;
        ++li_in;
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) fetch(s);

  float m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = paged::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  float* kn_b = norms ? a.kn + bk * a.P * page : nullptr;
  float* vn_b = norms ? a.vn + bk * a.P * page : nullptr;
  int li = 0, st = 0;  // step being consumed
  for (int u = 0; u < n_units; ++u) {
    const int stage = u & (kStages - 1);
    tc::cp_async_wait<kStages - 1>();
    const int local = s_list[w + li * kWarps];
    const int p = p0 + local;
    const bool mapped = s_bt[local] >= 0;
    const int j = st * TPS + grp;
    const bool in = j < page;
    float kx[E], vx[E];
    unpack<TK, E>(k_ring + stage * 32 * BYTES, kx);
    unpack<TK, E>(v_ring + stage * 32 * BYTES, vx);
    const int kpos = pos_ring[stage * 32];
    if constexpr (kInt8) {
      const float ksc = ks_ring[stage * 32] / 127.f;
      const float vsc = vs_ring[stage * 32] / 127.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kx[e] *= ksc;
        vx[e] *= vsc;
      }
    }
    if (norms) {
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sk = fmaf(kx[e], kx[e], sk);
        sv = fmaf(vx[e], vx[e], sv);
      }
      sk = group_sum<L>(sk);
      sv = group_sum<L>(sv);
      if (c == 0 && in) {
        kn_b[(long long)p * page + j] = sqrtf(sk);
        vn_b[(long long)p * page + j] = sqrtf(sv);
      }
    }
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kx[e], d);
      s[g] = group_sum<L>(d);
    }
    if (in && paged::pair_valid(mapped, kpos, cur, a.window)) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (s[g] > m[g]) {  // the max grows: rescale (m = -1e30 gives 0)
          const float alpha = exp2f(m[g] - s[g]);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
          m[g] = s[g];
        }
        const float pr = exp2f(s[g] - m[g]);
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr, vx[e], acc[g][e]);
      }
    }
    if (++st == spp) {
      st = 0;
      ++li;
    }
    fetch(stage);  // after this lane's reads of the stage
  }
  tc::cp_async_wait<0>();

  // merge the token groups of the warp (lanes c, c + L, ...)
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], m2);
      const float a1 = exp2f(m[g] - mn), a2 = exp2f(m2 - mn);
      l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x2 = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a1 + x2 * a2;
      }
      m[g] = mn;
    }
  }
  // then the warps, through shared memory (over the ring, now idle)
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);   // kWarps x GMAX x HD
  float* s_m = s_acc + kWarps * GMAX * HD;         // kWarps x GMAX
  float* s_l = s_m + kWarps * GMAX;
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        s_acc[(w * GMAX + g) * HD + c * E + e] = acc[g][e];
      if (lane == 0) {
        s_m[w * GMAX + g] = m[g];
        s_l[w * GMAX + g] = l[g];
      }
    }
  }
  __syncthreads();
  const long long part = (bk * a.S + sp) * a.G;
  for (int i = threadIdx.x; i < a.G * HD; i += blockDim.x) {
    const int g = i / HD;
    float mx = paged::kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, s_m[v * GMAX + g]);
    float x = 0.f, lt = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float f = exp2f(s_m[v * GMAX + g] - mx);
      x += s_acc[(v * GMAX + g) * HD + i - g * HD] * f;
      lt += s_l[v * GMAX + g] * f;
    }
    a.acc[part * HD + i] = x;
    if (i - g * HD == 0) {
      a.m[part + g] = mx == paged::kNegInf ? mx : mx * kLn2;
      a.l[part + g] = lt;
    }
  }
}

template <typename TQ, typename TK, int HD, int GMAX>
int launch_shape(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = ring_bytes<TK, HD, GMAX>() + (2 * (size_t)a.pps + 1) *
                                                       sizeof(int);
  cudaError_t err =
      paged::allow_smem(paged_decode_kernel<TQ, TK, HD, GMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.S, a.KV, B);
  paged_decode_kernel<TQ, TK, HD, GMAX><<<grid, kWarps * 32, smem, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int hd = a.pool.hd;
  if (a.G < 1 || a.G > 8 || a.pool.page < 1 || a.pool.page > 128 ||
      (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return a.G <= 4 ? launch_shape<TQ, TK, 64, 4>(a, B, stream)
                    : launch_shape<TQ, TK, 64, 8>(a, B, stream);
  return a.G <= 4 ? launch_shape<TQ, TK, 128, 4>(a, B, stream)
                  : launch_shape<TQ, TK, 128, 8>(a, B, stream);
}

template <typename TQ>
int launch_q(int pool_dtype, const Args& a, int B, cudaStream_t stream) {
  if (pool_dtype == 0) return launch<TQ, float>(a, B, stream);
  if (pool_dtype == 1) return launch<TQ, __nv_bfloat16>(a, B, stream);
  return launch<TQ, int8_t>(a, B, stream);
}

}  // namespace

extern "C" {

// q (B, KV, G, hd) contiguous; k/v pool (N, page, KV, hd) with element
// strides s_n, s_page, s_kv (multiples of the chunk: 4 f32, 8 bf16 or int8
// values; bases aligned to it) and hd contiguous; k_scale / v_scale (N,
// page, KV) f32 contiguous for an int8 pool, else null; pos (N, page)
// int32; bt (B, P) int32; cur_pos (B,) int32. hd 64 or 128, 1 <= G <= 8,
// page <= 128. Outputs f32: acc (B, KV, S, G, hd), m and l (B, KV, S, G),
// and when kn / vn are not null (B, KV, P, page) norms. q_dtype: 0 =
// float32, 1 = bfloat16; pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8.
// Returns the CUDA error code of the launch (0 == success).
int paged_decode(const void* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale, const int* pos,
                 const int* bt, const int* cur_pos, float* acc, float* m,
                 float* l, float* kn, float* vn, int B, int KV, int G, int hd,
                 int P, int page, long long s_n, long long s_page,
                 long long s_kv, int num_splits, int pages_per_split,
                 int window, float scale, int q_dtype, int pool_dtype,
                 void* stream) {
  const Args a{q,  {k, v, k_scale, v_scale, pos, s_n, s_page, s_kv, page, hd,
                    KV},
               bt, cur_pos, acc, m, l, kn, vn, KV, G, P, num_splits,
               pages_per_split, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_q<float>(pool_dtype, a, B, st);
  return launch_q<__nv_bfloat16>(pool_dtype, a, B, st);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
