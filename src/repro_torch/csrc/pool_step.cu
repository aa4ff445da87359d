// Alg. 3's per-layer pool bookkeeping of one decode step, in two launches.
//
// Replaces: nothing of the JAX package's kernels. There the bookkeeping is
// plain jnp inside the step's jitted program (src/repro/core/decode.py,
// paged_cache.py, policies.py); the port ran it as ~380 eager aten ops a
// layer and decode step, each a launch, and the host issuing them set the
// pace of the step.
//
// What it computes, bit for bit as the port's plain torch version
// (core/paged_cache.py, core/policies.py) on equal inputs:
//  - pool_append: the lazy rollover of rows whose head page is full
//    (`rollover_to_free_page` under the gate `any(need)`: reclaim of
//    emptied pages, first unmapped slot, forced eviction of the
//    fewest-token non-current page with a 1e6 penalty on shared pages,
//    the i-th needing row taking the i-th lowest free page), then the
//    write of each active row's token at its head (`write_token`: K, V,
//    the int8 absmax scales, pos, score; cur_off + 1). The token's score is
//    given, or Alg. 1's mean_h ||V|| / max(mean_h ||K||, 1e-6), computed
//    here in the order of torch's CUDA reductions.
//  - paged_evict: `PagedEviction.post_write`: the victim is the first index
//    of the argmin of the page scores over full pages (the head's page
//    excluded under protect_recent; torch's order: NaN lowest, -0 == +0),
//    evicted where the head page is full and the row holds more than the
//    budget, then the same rollover.
//  - The devstats counts, when a stats vector is given.
//
// What bounds it on an H100: the launch. At the nemo cell's shape (B 6,
// P 129, ~800 pages of 16 tokens) it touches ~60 KB: the positions of the
// mapped pages, the tables, one token's K and V. Its phases are serial
// barriers, each a few hundred ns: pool_append took 0.0176 ms and
// paged_evict 0.0097 ms of device time there, against a launch floor of
// 0.0049 ms (chip_smoke phase 2).
//
// Design: one block of 1024 threads, so that every step of the protocol
// (a scan over the free list, an OR over the rows, a count over the pool)
// is a block-wide barrier and not a launch. Phases over (row, slot) pairs
// or over pages run one element per thread; per-row state lives in shared
// memory, argmins as 64-bit keys (ordered value bits, then the index) under
// atomicMin, releases with repeats as counts in a global scratch of N
// ints that the kernel zeroes first and each release pass zeroes again.
// Nothing here is a float sum but the score, whose head norms take a warp
// each; every count is an integer, so the order of atomics cannot change
// a result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr float kPenalty = 1e6f;   // forced eviction: a shared page's penalty
constexpr unsigned long long kNoKey = ~0ull;

// core/devstats.py
enum Stat {
  kAllocated = 0, kFreed, kReleased, kAdopted, kForked, kEvicted,
  kTokensEvicted, kForced, kWritten, kNStats
};

struct Pool {
  int* bt;         // (B, P) logical -> physical, -1 unmapped
  int* ref;        // (N,)
  int* cur_page;   // (B,)
  int* cur_off;    // (B,)
  int* pos;        // (N + 1, page)
  float* score;    // (N + 1, page)
  int* tpp;        // scratch (B, P): live tokens per slot
  int* dec;        // scratch (N,): releases per page, zero between passes
  int B, P, N, page;
};

// Per-row state in shared memory (B entries each) and the block's counts.
struct Rows {
  unsigned long long* fkey;   // forced-eviction candidate argmin
  unsigned long long* vkey;   // the policy's victim argmin
  int* need;
  int* slot;                  // first unmapped slot before a forced eviction
  int* slot2;                 // ... after it
  int* rank;                  // inclusive count of needing rows - 1
  int* force;
  int* freelist;              // the r-th free page, r < needing rows
  int* tgt;                   // write: physical page, -1 == no landing
  int* off;
  int* total;                 // live tokens per row
  float* sc;                  // the token's score
  int* stats;                 // kNStats
  int* misc;                  // 0: freed in this pass, 1: forced rows
};

__device__ __forceinline__ unsigned ordered(float v) {
  // torch.argmin's order: NaN below everything, -0 equal to +0
  if (isnan(v)) return 0u;
  if (v == 0.f) v = 0.f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long arg_key(float v, int i) {
  return ((unsigned long long)ordered(v) << 32) | (unsigned)i;
}

__device__ void count_tokens(const Pool& p) {
  for (int i = threadIdx.x; i < p.B * p.P; i += kThreads) {
    const int ph = p.bt[i];
    int c = 0;
    if (ph >= 0) {
      const int* row = p.pos + (long long)ph * p.page;
      if ((p.page & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(p.pos) & 15) == 0) {
        for (int j = 0; j < p.page; j += 4) {
          const int4 q = *reinterpret_cast<const int4*>(row + j);
          c += (q.x >= 0) + (q.y >= 0) + (q.z >= 0) + (q.w >= 0);
        }
      } else {
        for (int j = 0; j < p.page; ++j) c += row[j] >= 0;
      }
    }
    p.tpp[i] = c;
  }
}

// `_unref_pages` of the counts in p.dec: clamp at 0, invalidate the pages
// whose count reaches 0, count releases and frees. Zeroes p.dec again.
// Call between barriers.
__device__ void release(const Pool& p, const Rows& r) {
  for (int n = threadIdx.x; n < p.N; n += kThreads) {
    const int d = p.dec[n];
    if (d == 0) continue;
    p.dec[n] = 0;
    const int ref = p.ref[n];
    const int nr = max(ref - d, 0);
    atomicAdd(&r.stats[kReleased], min(d, ref));
    if (ref > 0 && nr == 0) {
      atomicAdd(&r.stats[kFreed], 1);
      atomicAdd(&r.misc[0], 1);
      for (int j = 0; j < p.page; ++j) {
        p.pos[(long long)n * p.page + j] = -1;
        p.score[(long long)n * p.page + j] = -__int_as_float(0x7f800000);
      }
    }
    p.ref[n] = nr;
  }
}

// rank[b] = (needing rows up to b) - 1; returns the needing rows. Warp 0
// scans the rows 32 at a time; every thread must call it.
__device__ int rank_rows(const Pool& p, const Rows& r) {
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int b0 = 0; b0 < p.B; b0 += 32) {
      const int b = b0 + lane;
      const int x = b < p.B ? r.need[b] : 0;
      int incl = x;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (b < p.B) r.rank[b] = carry + incl - 1;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_total = carry;
  }
  __syncthreads();
  return s_total;
}

// The free pages in index order: freelist[r] for r < want; returns how many
// pages are free. Every thread must call it.
__device__ int free_list(const Pool& p, const Rows& r, int want) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_chunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < p.N; base += kThreads) {
    const int n = base + threadIdx.x;
    const bool f = n < p.N && p.ref[n] == 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int c = s_warp[lane];
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      s_warp[lane] = incl - c;
      if (lane == 31) s_chunk = incl;
    }
    __syncthreads();
    if (f) {
      const int k = carry + s_warp[warp] + __popc(m & ((1u << lane) - 1u));
      if (k < want) r.freelist[k] = n;
    }
    carry += s_chunk;
    __syncthreads();
  }
  return carry;
}

// `rollover_to_free_page(need)` with the reclaim gated by any(need); the
// caller skips it when no row needs it (then it is the identity). Leaves
// force[b] set. Every thread must call it.
__device__ void rollover(const Pool& p, const Rows& r) {
  const int BP = p.B * p.P;
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    r.slot[b] = p.P;
    r.slot2[b] = p.P;
    r.fkey[b] = kNoKey;
    r.force[b] = 0;
  }
  if (threadIdx.x < 2) r.misc[threadIdx.x] = 0;
  const int needing = rank_rows(p, r);      // barrier
  // reclaim: unmap every mapped slot holding no live token, the current
  // one only where the row rolls over; release its page
  count_tokens(p);
  __syncthreads();
  for (int i = threadIdx.x; i < BP; i += kThreads) {
    const int b = i / p.P, s = i - b * p.P;
    const int ph = p.bt[i];
    if (ph >= 0 && p.tpp[i] == 0 && (s != p.cur_page[b] || r.need[b])) {
      atomicAdd(&p.dec[ph], 1);
      p.bt[i] = -1;
    }
  }
  __syncthreads();
  release(p, r);
  __syncthreads();
  if (r.misc[0] > 0) {     // a freed page lost its positions
    count_tokens(p);
    __syncthreads();
  }
  // first unmapped slot; the forced-eviction candidate (fewest live
  // tokens, > 0, not the head's, shared pages last)
  for (int i = threadIdx.x; i < BP; i += kThreads) {
    const int b = i / p.P, s = i - b * p.P;
    const int ph = p.bt[i];
    if (ph < 0) atomicMin(&r.slot[b], s);
    const int t = p.tpp[i];
    float c = __int_as_float(0x7f800000);
    if (t > 0 && s != p.cur_page[b])
      c = (float)t + ((ph >= 0 && p.ref[ph] > 1) ? kPenalty : 0.f);
    atomicMin(&r.fkey[b], arg_key(c, s));
  }
  int nfree = 0;
  for (int base = 0; base < p.N; base += kThreads) {
    const int n = base + threadIdx.x;
    nfree += __syncthreads_count(n < p.N && p.ref[n] == 0);
  }
  // forced eviction where a needing row has no unmapped slot or no page
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    if (!r.need[b] || (r.slot[b] < p.P && r.rank[b] < nfree)) continue;
    r.force[b] = 1;
    atomicAdd(&r.stats[kForced], 1);
    atomicAdd(&r.misc[1], 1);
    const int v = (int)(r.fkey[b] & 0xffffffffu);
    const int ph = p.bt[b * p.P + v];
    if (ph >= 0) {
      atomicAdd(&p.dec[ph], 1);
      p.bt[b * p.P + v] = -1;
      atomicAdd(&r.stats[kEvicted], 1);
    }
  }
  __syncthreads();
  if (r.misc[1] > 0) {
    release(p, r);
    __syncthreads();
    for (int i = threadIdx.x; i < BP; i += kThreads)
      if (p.bt[i] < 0) atomicMin(&r.slot2[i / p.P], i % p.P);
    __syncthreads();
  }
  // the i-th needing row takes the i-th lowest free page
  const int avail = free_list(p, r, needing);
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    if (!r.need[b] || r.rank[b] >= avail) continue;
    const int ph = r.freelist[r.rank[b]];
    const int s0 = r.force[b] ? r.slot2[b] : r.slot[b];
    const int s = s0 < p.P ? s0 : 0;
    p.ref[ph] += 1;
    atomicAdd(&r.stats[kAllocated], 1);
    p.bt[b * p.P + s] = ph;
    p.cur_page[b] = s;
    p.cur_off[b] = 0;
  }
  __syncthreads();
}

__device__ Rows carve(void* smem, int B) {
  Rows r;
  auto* u = static_cast<unsigned long long*>(smem);
  r.fkey = u;
  r.vkey = u + B;
  int* i = reinterpret_cast<int*>(u + 2 * B);
  r.need = i;
  r.slot = i + B;
  r.slot2 = i + 2 * B;
  r.rank = i + 3 * B;
  r.force = i + 4 * B;
  r.freelist = i + 5 * B;
  r.tgt = i + 6 * B;
  r.off = i + 7 * B;
  r.total = i + 8 * B;
  r.sc = reinterpret_cast<float*>(i + 9 * B);
  r.stats = i + 10 * B;
  r.misc = r.stats + kNStats;
  return r;
}

__device__ void begin(const Pool& p, const Rows& r) {
  for (int n = threadIdx.x; n < p.N; n += kThreads) p.dec[n] = 0;
  if (threadIdx.x < kNStats) r.stats[threadIdx.x] = 0;
}

__device__ void end(const Rows& r, int* stats) {
  __syncthreads();
  if (stats != nullptr && threadIdx.x < kNStats && r.stats[threadIdx.x])
    stats[threadIdx.x] += r.stats[threadIdx.x];
}

__device__ __forceinline__ float load(const void* x, long long i, int dt) {
  if (dt == 0) return static_cast<const float*>(x)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// One head's ||x|| by a warp, in the order of torch's CUDA norm reduction
// (ATen's Reduce.cuh, as torch 2.11 builds it), so that the score equals
// `vk_ratio_score` on the card: a row of 128 or more reads as 4-wide
// vectors over 32 lanes, one accumulator per vector element; a shorter row
// over min(last_pow2(hd), 32) lanes, 4 accumulators at a stride of that
// width; each lane's accumulators summed in order (each square fused into
// its sum), then the lanes at decreasing shuffle offsets. Lane 0 holds the
// norm.
__device__ float head_norm(const void* x, long long base, int hd, int dt) {
  const int lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int width = 32;
  if (hd >= 128) {
    int idx = lane;
    for (; idx * 4 + 3 < hd; idx += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = load(x, base + idx * 4 + i, dt);
        acc[i] = fmaf(a, a, acc[i]);
      }
    }
    const int tail = hd - hd % 4;
    if (tail + lane < hd) {
      const float a = load(x, base + tail + lane, dt);
      acc[0] = fmaf(a, a, acc[0]);
    }
  } else {
    width = 1;
    while (2 * width <= hd && width < 32) width *= 2;
    if (lane < width) {
      int idx = lane;
      for (; idx + 3 * width < hd; idx += 4 * width) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = load(x, base + idx + i * width, dt);
          acc[i] = fmaf(a, a, acc[i]);
        }
      }
      for (int i = 0; i < 4 && idx < hd; ++i, idx += width) {
        const float a = load(x, base + idx, dt);
        acc[i] = fmaf(a, a, acc[i]);
      }
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  for (int o = width / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
  return sqrtf(s);
}

// torch's CUDA mean over the last dim of a (rows, n) tensor, by one
// thread: min(last_pow2(n), 32) lanes, each summing its elements at that
// stride in up to 4 accumulators, the lanes at decreasing offsets, times
// rows / (rows * n) as torch computes the factor.
__device__ float head_mean(const float* x, int n, int rows) {
  float lanes[32];
  int width = 1;
  while (2 * width <= n && width < 32) width *= 2;
  for (int l = 0; l < width; ++l) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int i = 0;
    for (int idx = l; idx < n; idx += width, ++i)
      acc[i & 3] = __fadd_rn(acc[i & 3], x[idx]);
    lanes[l] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]),
                         acc[3]);
  }
  for (int o = width / 2; o > 0; o >>= 1)
    for (int l = 0; l < o; ++l) lanes[l] = __fadd_rn(lanes[l], lanes[l + o]);
  return __fmul_rn(lanes[0],
                   __fdiv_rn((float)rows, (float)((long long)rows * n)));
}

struct Tokens {
  const void* k;
  const void* v;
  long long kb, kh, vb, vh;   // element strides of (B, KV, hd), hd unit
  int dt;                     // 0 f32, 1 bf16
  const int* pos;             // (B,)
  const float* score;         // (B,) or null: Alg. 1 here
  const bool* active;         // (B,) or null: every row
  float* norms;               // scratch (B, 2, KV): Alg. 1's head norms
};

struct KVPool {
  void* k;
  void* v;
  float* ks;                  // int8 pools: (N + 1, page, KV) scales
  float* vs;
  long long sn, sp, skv;      // element strides of k / v, hd unit
  int dt;                     // 0 f32, 1 bf16, 2 int8
  int KV, hd;
};

// One head of one token into the pool, by warp: converted to the pool's
// type, or quantized per (token, head) as quantize_absmax (divide, scale
// by 127, round half to even, clip), no contraction.
__device__ void put_head(const void* x, long long xi, int tdt, void* pool,
                         float* scales, long long pi, long long si,
                         const KVPool& kv) {
  const int lane = threadIdx.x & 31;
  if (kv.dt == 2) {
    float amax = 0.f;
    for (int d = lane; d < kv.hd; d += 32)
      amax = fmaxf(amax, fabsf(load(x, xi + d, tdt)));
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = amax < 1e-8f ? 1e-8f : amax;
    for (int d = lane; d < kv.hd; d += 32) {
      float q = rintf(__fmul_rn(__fdiv_rn(load(x, xi + d, tdt), s), 127.f));
      q = fminf(fmaxf(q, -127.f), 127.f);
      static_cast<int8_t*>(pool)[pi + d] = (int8_t)q;
    }
    if (lane == 0) scales[si] = amax;
  } else if (kv.dt == 1) {
    for (int d = lane; d < kv.hd; d += 32)
      static_cast<__nv_bfloat16*>(pool)[pi + d] =
          __float2bfloat16_rn(load(x, xi + d, tdt));
  } else {
    for (int d = lane; d < kv.hd; d += 32)
      static_cast<float*>(pool)[pi + d] = load(x, xi + d, tdt);
  }
}

__global__ void __launch_bounds__(kThreads)
    pool_append_kernel(Pool p, KVPool kv, Tokens tok, int* stats) {
  extern __shared__ unsigned long long smem[];
  const Rows r = carve(smem, p.B);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  begin(p, r);
  if (tok.score == nullptr) {
    // Alg. 1 (importance.vk_ratio_score): mean_h ||V|| over the mean of
    // ||K|| clamped at 1e-6; a warp per (row, head, K or V) norm, then a
    // thread per row
    for (int t = warp; t < 2 * p.B * kv.KV; t += kWarps) {
      const int which = t & 1, bh = t >> 1;
      const int b = bh / kv.KV, h = bh - b * kv.KV;
      const float n = which ? head_norm(tok.v, b * tok.vb + h * tok.vh,
                                        kv.hd, tok.dt)
                            : head_norm(tok.k, b * tok.kb + h * tok.kh,
                                        kv.hd, tok.dt);
      if (lane == 0) tok.norms[(2LL * b + which) * kv.KV + h] = n;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < p.B; b += kThreads) {
      const float km = head_mean(tok.norms + 2LL * b * kv.KV, kv.KV, p.B);
      const float vm = head_mean(tok.norms + (2LL * b + 1) * kv.KV, kv.KV,
                                 p.B);
      r.sc[b] = __fdiv_rn(vm, km < kEps ? kEps : km);
    }
  } else {
    for (int b = threadIdx.x; b < p.B; b += kThreads) r.sc[b] = tok.score[b];
  }
  int any = 0;
  for (int b0 = 0; b0 < p.B; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    int nd = 0;
    if (b < p.B) {
      nd = (tok.active == nullptr || tok.active[b]) &&
           p.cur_off[b] >= p.page;
      r.need[b] = nd;
    }
    any |= __syncthreads_or(nd);
  }
  if (any) rollover(p, r);
  // the write at the head: lands where the head page is mapped and has room;
  // the head advances wherever it is mapped
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    const int ph = p.bt[b * p.P + p.cur_page[b]];
    const bool ok = (tok.active == nullptr || tok.active[b]) && ph >= 0;
    const int off = p.cur_off[b];
    const bool land = ok && off < p.page;
    r.tgt[b] = land ? ph : -1;
    r.off[b] = off;
    if (ok) {
      p.cur_off[b] = off + 1;
      atomicAdd(&r.stats[kWritten], 1);
    }
    if (land) {
      p.pos[(long long)ph * p.page + off] = tok.pos[b];
      p.score[(long long)ph * p.page + off] = r.sc[b];
    }
  }
  __syncthreads();
  for (int t = warp; t < 2 * p.B * kv.KV; t += kWarps) {
    const int which = t & 1, bh = t >> 1;
    const int b = bh / kv.KV, h = bh - b * kv.KV;
    const int ph = r.tgt[b];
    if (ph < 0) continue;
    const long long pi = ph * kv.sn + r.off[b] * kv.sp + h * kv.skv;
    const long long si = ((long long)ph * p.page + r.off[b]) * kv.KV + h;
    if (which == 0)
      put_head(tok.k, b * tok.kb + h * tok.kh, tok.dt, kv.k, kv.ks, pi, si,
               kv);
    else
      put_head(tok.v, b * tok.vb + h * tok.vh, tok.dt, kv.v, kv.vs, pi, si,
               kv);
  }
  end(r, stats);
}

struct Outcome {
  bool* pages_evicted;
  bool* tokens_evicted;
  bool* forced;
  int* victim;
  float* victim_score;
};

__global__ void __launch_bounds__(kThreads)
    paged_evict_kernel(Pool p, const bool* active, const float* ps,
                       int budget, int protect, Outcome out, int* stats) {
  extern __shared__ unsigned long long smem[];
  const Rows r = carve(smem, p.B);
  const int BP = p.B * p.P;
  begin(p, r);
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    r.vkey[b] = kNoKey;
    r.total[b] = 0;
  }
  count_tokens(p);
  __syncthreads();
  // live tokens per row; the victim: the lowest page score among full
  // pages (+inf elsewhere), first index on ties
  for (int i = threadIdx.x; i < BP; i += kThreads) {
    const int b = i / p.P, s = i - b * p.P;
    const int t = p.tpp[i];
    if (t) atomicAdd(&r.total[b], t);
    const bool full = t >= p.page && !(protect && s == p.cur_page[b]);
    atomicMin(&r.vkey[b],
              arg_key(full ? ps[i] : __int_as_float(0x7f800000), s));
  }
  __syncthreads();
  int any = 0;
  for (int b0 = 0; b0 < p.B; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    int nd = 0;
    if (b < p.B) {
      nd = (active == nullptr || active[b]) && p.cur_off[b] >= p.page;
      r.need[b] = nd;
      const bool ev = nd && r.total[b] > budget;
      const int v = (int)(r.vkey[b] & 0xffffffffu);
      out.pages_evicted[b] = ev;
      out.tokens_evicted[b] = false;
      out.victim[b] = v;
      out.victim_score[b] = ps[b * p.P + v];
      const int ph = p.bt[b * p.P + v];
      if (ev && ph >= 0) {
        atomicAdd(&p.dec[ph], 1);
        p.bt[b * p.P + v] = -1;
        atomicAdd(&r.stats[kEvicted], 1);
      }
    }
    any |= __syncthreads_or(nd);
  }
  release(p, r);
  __syncthreads();
  if (any) rollover(p, r);
  for (int b = threadIdx.x; b < p.B; b += kThreads)
    out.forced[b] = any && r.force[b];
  end(r, stats);
}

size_t smem_bytes(int B) {
  return (size_t)B * (2 * sizeof(unsigned long long) + 10 * sizeof(int)) +
         (kNStats + 2) * sizeof(int);
}

}  // namespace

extern "C" {

// The shared memory a launch of either kernel takes for B rows (the
// wrapper refuses a batch beyond the device's 48 KB default).
int pool_step_smem(int B) { return (int)smem_bytes(B); }

// One layer's append of one decode token per row. Pool tensors as in
// core/paged_cache.py, contiguous int32 tables (bt (B, P), ref (N,),
// cur_page / cur_off (B,)), pos_buf (N + 1, page) int32, score_buf
// (N + 1, page) f32; k / v pool (N + 1, page, KV, hd) of pool_dtype
// (0 f32, 1 bf16, 2 int8 with contiguous (N + 1, page, KV) f32 scales ks /
// vs) with element strides s_n, s_page, s_kv and hd contiguous; tokens k / v
// (B, KV, hd) of tok_dtype (0 f32, 1 bf16) with strides kb, kh / vb, vh and
// hd contiguous; pos_tok (B,) int32; score (B,) f32 or null (Alg. 1 here);
// active (B,) bool or null (every row); stats (9,) int32 or null; scratch
// B * P + N + 2 * B * KV int32. Returns the CUDA error code of the launch.
int pool_append(int* bt, int* ref, int* cur_page, int* cur_off, int* pos,
                float* score_buf, void* kp, void* vp, float* ks, float* vs,
                const void* k, const void* v, const int* pos_tok,
                const float* score, const bool* active, int* stats,
                int* scratch, int B, int P, int N, int page, int KV, int hd,
                long long s_n, long long s_page, long long s_kv,
                long long kb, long long kh, long long vb, long long vh,
                int pool_dtype, int tok_dtype, void* stream) {
  const Pool p{bt, ref, cur_page, cur_off, pos, score_buf, scratch,
               scratch + (long long)B * P, B, P, N, page};
  const KVPool kv{kp, vp, ks, vs, s_n, s_page, s_kv, pool_dtype, KV, hd};
  const Tokens tok{k,     v,     kb,     kh,     vb,
                   vh,    tok_dtype, pos_tok, score, active,
                   reinterpret_cast<float*>(scratch + (long long)B * P + N)};
  pool_append_kernel<<<1, kThreads, smem_bytes(B),
                       static_cast<cudaStream_t>(stream)>>>(p, kv, tok,
                                                            stats);
  return (int)cudaGetLastError();
}

// PagedEviction's decode hook for one layer. Pool tables as pool_append;
// active (B,) bool or null; page_scores (B, P) f32 contiguous; outputs
// (B,) each: pages_evicted, tokens_evicted, forced (bool), victim (int32),
// victim_score (f32); stats (9,) int32 or null; scratch B * P + N int32.
// Returns the CUDA error code of the launch.
int paged_evict(int* bt, int* ref, int* cur_page, int* cur_off, int* pos,
                float* score_buf, const bool* active, const float* page_scores,
                int budget, int protect, bool* pages_evicted,
                bool* tokens_evicted, bool* forced, int* victim,
                float* victim_score, int* stats, int* scratch, int B, int P,
                int N, int page, void* stream) {
  const Pool p{bt, ref, cur_page, cur_off, pos, score_buf, scratch,
               scratch + (long long)B * P, B, P, N, page};
  const Outcome out{pages_evicted, tokens_evicted, forced, victim,
                    victim_score};
  paged_evict_kernel<<<1, kThreads, smem_bytes(B),
                       static_cast<cudaStream_t>(stream)>>>(
      p, active, page_scores, budget, protect, out, stats);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
