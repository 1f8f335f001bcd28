// Split-KV block-paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention_kernel.  For each slot b it computes one query token's
// softmax(q K^T / sqrt(D)) V straight from the (NB, bs, Hkv, D) KV block
// pool, following the slot's row of the block table; no gathered copy of
// the cache is ever written.
//
// Bound: bytes.  A decode token does 4*D flops per KV element it reads, far
// below the card's ~295 flops per byte, so the time floor is reading the
// K/V blocks the slot's length needs (at qwen2-0.5b's serving shape, 8
// slots of up to 1024 tokens, ~1.8 MB: about half a microsecond).  What
// keeps a decode step from that floor is latency, not bandwidth: one block
// per (slot, KV head) is 16 blocks on 132 SMs, each walking its blocks in
// turn.  Design (flash-decoding):
//   * grid (B * Hkv, S): split s of (slot b, KV head h) walks the logical
//     blocks [s*c, (s+1)*c), cut at ceil(cache_len / bs) and, with a
//     window, at the first block that reaches into it.  S and c come from
//     the wrapper's shape-only rule (kernels/paged_attention.py::splits;
//     no host sync on cache_len): at the serving shape 16 splits of 2
//     blocks, 256 thread blocks.  The table entries of a split's first
//     blocks are read before its length, so the two loads overlap;
//   * the G = Hq / Hkv query heads of the group share every K/V tile, so
//     each K/V byte is read from device memory once;
//   * K/V tiles stay in the pool's type in shared memory, rows padded by
//     16 bytes (conflict-free 16-byte reads of a row a lane, and
//     conflict-free ldmatrix), filled by cp.async, 16 bytes a thread,
//     through a ring of kStages stages: the split's next blocks are in
//     flight while this one computes;
//   * bf16 pools with G <= 16, D in {64, 128} and bs in {16, 32, 64} (the
//     serving path's) compute on the tensor cores (the mma kernel): a warp
//     holds the G heads, padded to 16 rows, as mma.m16n8k16 A fragments;
//     scores q K^T from ldmatrix'd K, the softmax on the accumulators, p
//     rounded to bf16 as the A fragments of P V (ldmatrix.trans'd V), the
//     f32 accumulator in registers.  Two warps compute, each every other
//     block of the split with its own (m, l, acc), merged at the end by
//     the combine's rule, so a split of two blocks computes them at once.
//     Other pools (the f32 route, other shapes) compute on the CUDA cores
//     (the simt kernel): one warp a head, lane t scores key t, lane d
//     accumulates dims d, d + 1 (+ 64, ...);
//   * the online softmax is the reference's base-2 one with an integer
//     running max: s = q.k * log2(e)/sqrt(D), masked to NEG_INF, m_new =
//     max(m, ceil(rowmax)), p = exp2(s - m_new), corr = pow2_int(m - m_new),
//     an exact power of two built from the exponent bits, so the carry
//     update never rounds on the multiply.  p is rounded to the pool's type
//     before the PV product, as the reference does;
//   * S > 1: each split writes its (m, l, acc[D]) of each head to an f32
//     workspace, and a second kernel, one block per (b, h), combines them:
//     m = max_s m_s, w_s = pow2_int(m_s - m), l = sum_s w_s l_s, acc =
//     sum_s w_s acc_s, out = acc / max(l, 1e-20).  Every rescale is an
//     exact power of two, as in the sequential walk.  Lane s of a head's
//     warp takes split s (S <= 32).  The combine is launched as a
//     programmatic dependent of the split kernel, so its launch overlaps
//     the splits' work and it waits (griddepcontrol.wait) only for their
//     results.  A split that enters no block writes (NEG_INF, 0, 0) and
//     never runs the exp2 step (on a row of NEG_INF scores it would give
//     p = 1), so the combine's pow2_int(NEG_INF - m) wipes it exactly.
//     S = 1 writes the output directly, in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kStages = 3;
constexpr int kMaxThreads = 256;
constexpr int kMmaThreads = 128;    // four warps copy
constexpr int kMmaWarps = 2;        // two of them compute, a block each
constexpr int kMmaStages = 4;       // two blocks computed, two in flight
constexpr int kMaxSplits = 32;      // a warp's lanes: lane u combines split u

__device__ __forceinline__ float pow2_int(float delta) {
  // exact 2^delta for integer-valued delta <= 0; 0 below -126
  const int k = static_cast<int>(fmaxf(delta, -150.0f));
  const int kc = min(max(k, -126), 0);
  const float val = __int_as_float((kc + 127) << 23);
  return k < -126 ? 0.0f : val;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round p to the pool's type and back (the reference's p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// One 16-byte vector of T from shared memory, as f32 (a bf16 is the high
// half of its f32, so the conversion is a shift; no local copy is made).
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dst[2 * e] = __uint_as_float(w[e] << 16);
    dst[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}

// Two consecutive elements of T from shared memory, as f32.
__device__ __forceinline__ float2 load_pair(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* src) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Elements of a K or V row in shared memory: D and 16 bytes of padding.
template <typename T> __host__ __device__ constexpr int padded_row(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Start the copy of one logical block's K and V rows of head h (physical
// block `phys`) into a ring stage, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void copy_block(T* k_st, const T* __restrict__ k_pool,
                                           const T* __restrict__ v_pool,
                                           long long phys, int h, int Hkv,
                                           int D, int bs, int row) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs_per_row = D / VEC;
  const int tile_vecs = bs * vecs_per_row;
  const long long at = (phys * bs * Hkv + h) * (long long)D;
  const long long row_stride = (long long)Hkv * D;   // between positions t
  T* v_st = k_st + bs * row;
  for (int e = threadIdx.x; e < 2 * tile_vecs; e += blockDim.x) {
    const bool is_v = e >= tile_vecs;
    const int ee = is_v ? e - tile_vecs : e;
    const int t = ee / vecs_per_row;
    const int d = (ee - t * vecs_per_row) * VEC;
    cp_async16((is_v ? v_st : k_st) + t * row + d,
               (is_v ? v_pool : k_pool) + at + t * row_stride + d);
  }
}

// A split's walk: blocks [j0, j0 + n) of slot b (none if n <= 0).
struct Walk {
  int clen, j0, n;
};

// Find split blockIdx.y's blocks and start the copies of its first
// STAGES into the ring (one commit group each, empty past n).  The table
// entries of the split's first blocks are read before the slot's length
// (every entry names a real block), so the two loads overlap.
template <int STAGES, typename T>
__device__ __forceinline__ Walk start_walk(T* ring, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int32_t* __restrict__ tb,
                                          const int32_t* __restrict__ cache_len,
                                          int b, int h, int Hkv, int D, int bs,
                                          int nb, int window, int chunk, int row) {
  const int jb = blockIdx.y * chunk;
  int ids[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    ids[i] = i < chunk && jb + i < nb ? tb[jb + i] : 0;
  }
  Walk w;
  w.clen = cache_len[b];
  const int n_blocks = (w.clen + bs - 1) / bs;
  w.j0 = jb;
  if (window && w.clen - window > 0) w.j0 = max(jb, (w.clen - window) / bs);
  w.n = min(jb + chunk, n_blocks) - w.j0;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < w.n) {
      copy_block(ring + (size_t)i * 2 * bs * row, k_pool, v_pool,
                  w.j0 == jb ? ids[i] : tb[w.j0 + i], h, Hkv, D, bs, row);
    }
    cp_async_commit();
  }
  return w;
}

// This split's partial: acc [B*Hkv][S][G][D], then m, then l
// [B*Hkv][S][G], in one f32 workspace; head g's at acc + g * D, m + g, l + g.
struct Partials {
  float* acc;
  float* m;
  float* l;
  __device__ Partials(float* ws, int G, int D) {
    const long long part = ((long long)blockIdx.x * gridDim.y + blockIdx.y) * G;
    const long long n_part = (long long)gridDim.x * gridDim.y * G;
    acc = ws + part * D;
    m = ws + n_part * D + part;
    l = ws + n_part * (D + 1) + part;
  }
};

// The CUDA-core kernel: one warp a query head.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
paged_attention_simt_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ cache_len,
                            T* __restrict__ out, float* __restrict__ ws,
                            int Hq, int Hkv, int D, int bs, int nb,
                            int window, int chunk, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row = padded_row<T>(D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);     // [kStages][K, V][bs][row]
  float* q_s = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * bs * row);
  float* acc_s = q_s + G * D;                   // [G][D]
  float* p_s = acc_s + G * D;                   // [G][bs] scores, then p
  float* m_s = p_s + G * bs;                    // [G]
  float* l_s = m_s + G;                         // [G]

  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may launch
  const int32_t* tb = table + (long long)b * nb;
  const Walk w = start_walk<kStages>(ring, k_pool, v_pool, tb, cache_len, b, h,
                                     Hkv, D, bs, nb, window, chunk, row);
  const T* q_b = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_f(q_b[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }

  for (int i = 0; i < w.n; ++i) {
    cp_async_wait<kStages - 1>();             // block i has landed
    __syncthreads();
    const T* k_st = ring + (size_t)(i % kStages) * 2 * bs * row;
    const T* v_st = k_st + bs * row;
    const int first = (w.j0 + i) * bs;
    for (int g = warp; g < G; g += n_warps) {
      const float* qg = q_s + g * D;
      float* pg = p_s + g * bs;
      // scores s[t] = (q_g . k_t) * scale, masked to NEG_INF
      float mx = -INFINITY;
      for (int t = lane; t < bs; t += 32) {
        const T* kt = k_st + t * row;
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;   // four chains
#pragma unroll 4
        for (int d = 0; d < D; d += VEC) {
          float kv[VEC];
          load_vec(kt + d, kv);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + d + e);
            d0 = fmaf(qv.x, kv[e], d0);
            d1 = fmaf(qv.y, kv[e + 1], d1);
            d2 = fmaf(qv.z, kv[e + 2], d2);
            d3 = fmaf(qv.w, kv[e + 3], d3);
          }
        }
        const float dot = (d0 + d1) + (d2 + d3);
        const int pos = first + t;
        bool valid = pos < w.clen;
        if (window) valid = valid && pos >= w.clen - window;
        const float sc = valid ? dot * scale : kNegInf;
        pg[t] = sc;
        mx = fmaxf(mx, sc);
      }
      // integer running max, exp2, exact rescale
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, ceilf(mx));
      float sum = 0.0f;
      for (int t = lane; t < bs; t += 32) {
        const float p = exp2f(pg[t] - m_new);
        sum += p;
        pg[t] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      const float corr = pow2_int(m_prev - m_new);
      __syncwarp();                             // every lane's p is stored
      // acc[d] = acc * corr + sum_t round(p[t]) * v[t][d], two dims a lane
      float* ag = acc_s + g * D;
      for (int d = 2 * lane; d < D; d += 64) {
        float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;   // even, odd t
        int t = 0;
#pragma unroll 4
        for (; t + 1 < bs; t += 2) {
          const float2 v = load_pair(v_st + t * row + d);
          const float2 u = load_pair(v_st + (t + 1) * row + d);
          a0 = fmaf(pg[t], v.x, a0);
          a1 = fmaf(pg[t], v.y, a1);
          b0 = fmaf(pg[t + 1], u.x, b0);
          b1 = fmaf(pg[t + 1], u.y, b1);
        }
        if (t < bs) {
          const float2 v = load_pair(v_st + t * row + d);
          a0 = fmaf(pg[t], v.x, a0);
          a1 = fmaf(pg[t], v.y, a1);
        }
        ag[d] = ag[d] * corr + (a0 + b0);
        ag[d + 1] = ag[d + 1] * corr + (a1 + b1);
      }
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
      }
    }
    __syncthreads();                            // the stage is free again
    if (i + kStages < w.n) {
      copy_block(ring + (size_t)(i % kStages) * 2 * bs * row, k_pool, v_pool,
                  tb[w.j0 + i + kStages], h, Hkv, D, bs, row);
    }
    cp_async_commit();
  }
  __syncthreads();

  if (gridDim.y == 1) {
    T* o_b = out + ((long long)b * Hq + (long long)h * G) * D;
    for (int i = tid; i < G * D; i += blockDim.x) {
      o_b[i] = from_f<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-20f));
    }
    return;
  }
  const Partials part(ws, G, D);
  for (int i = tid; i < G * D; i += blockDim.x) part.acc[i] = acc_s[i];
  for (int g = tid; g < G; g += blockDim.x) {
    part.m[g] = m_s[g];
    part.l[g] = l_s[g];
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a b: mma.m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor-core kernel (bf16, G <= 16).  The block's four warps copy;
// warps 0 and 1 compute, each the split's blocks of its own parity with
// its own (m, l, acc), which warp 0 then merges with warp 1's by the
// combine's rule.  A thread of a computing warp holds rows r0 = lane / 4
// and r0 + 8 (query heads of the group; rows >= G are zero queries, never
// written) and columns c0 = 2 * (lane % 4) and c0 + 1 of each 8-wide tile.
template <int D, int BS>
__global__ void __launch_bounds__(kMmaThreads)
paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k_pool,
                           const __nv_bfloat16* __restrict__ v_pool,
                           const int32_t* __restrict__ table,
                           const int32_t* __restrict__ cache_len,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ ws, int Hq, int Hkv, int nb,
                           int window, int chunk, float scale) {
  using T = __nv_bfloat16;
  constexpr int ROW = padded_row<T>(D);
  constexpr int KS = D / 16;                    // k-steps of q K^T
  constexpr int NK = BS / 8;                    // 8-key tiles of a block
  constexpr int ND = D / 8;                     // 8-dim tiles of P V
  constexpr int STAGE = 2 * BS * ROW;           // a block's K and V
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = lane >> 2;
  const int c0 = 2 * (lane & 3);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);     // [kMmaStages][K, V][BS][ROW]
  T* q_s = ring + kMmaStages * STAGE;           // [16][ROW]

  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may launch
  const int32_t* tb = table + (long long)b * nb;
  const Walk w = start_walk<kMmaStages>(ring, k_pool, v_pool, tb, cache_len, b,
                                        h, Hkv, D, BS, nb, window, chunk, ROW);
  const T* q_b = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < 16 * D; i += blockDim.x) {
    const int r = i / D;
    q_s[r * ROW + i - r * D] = r < G ? q_b[i] : __float2bfloat16(0.0f);
  }

  uint32_t qa[KS][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int i0 = 0; i0 < w.n; i0 += kMmaWarps) {
    cp_async_wait<kMmaStages - kMmaWarps>();  // blocks i0, i0 + 1 have landed
    __syncthreads();
    const int i = i0 + warp;
    if (warp < kMmaWarps && i < w.n) {
      const T* k_st = ring + (i % kMmaStages) * STAGE;
      const T* v_st = k_st + BS * ROW;
      if (i0 == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(qa[kk], q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                              kk * 16 + (lane >> 4) * 8);
        }
      }
      // scores, 8 keys a tile
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t kb[4];
          ldsm_x4(kb, k_st + (j * 8 + (lane & 7)) * ROW + kk * 16 +
                          (lane >> 3) * 8);
          mma_bf16(s[j], qa[kk], kb[0], kb[1]);
          mma_bf16(s[j], qa[kk + 1], kb[2], kb[3]);
        }
      }
      // masked, scaled; integer running max, exp2, exact rescale
      const int first = (w.j0 + i) * BS;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = first + j * 8 + c0 + (e & 1);
          bool valid = pos < w.clen;
          if (window) valid = valid && pos >= w.clen - window;
          s[j][e] = valid ? s[j][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float corr[2], sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], ceilf(mx[r]));
        corr[r] = pow2_int(m[r] - m_new);
        m[r] = m_new;
        sum[r] = 0.0f;
      }
      uint32_t pa[NK / 2][4];                   // p as the A fragments of P V
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[j][e] - m[e >> 1]);
          sum[e >> 1] += p[e];
        }
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      // o += P V, 16 keys a k-step, 16 dims an ldmatrix
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, v_st + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * ROW +
                                j * 8 + (lane >> 4) * 8);
          mma_bf16(o[j], pa[kk], vb[0], vb[1]);
          mma_bf16(o[j + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                            // the two stages are free again
#pragma unroll
    for (int k = 0; k < kMmaWarps; ++k) {
      const int next = i0 + kMmaStages + k;
      if (next < w.n) {
        copy_block(ring + ((i0 + k) % kMmaStages) * STAGE, k_pool, v_pool,
                    tb[w.j0 + next], h, Hkv, D, BS, ROW);
      }
      cp_async_commit();
    }
  }

  // warp 1 hands its (m, l, acc) to warp 0 through the (now idle) ring
  float* hand = reinterpret_cast<float*>(ring);   // [4 + 4 * ND][32]
  if (warp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hand[r * 32 + lane] = m[r];
      hand[(2 + r) * 32 + lane] = l[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hand[(4 + 4 * j + e) * 32 + lane] = o[j][e];
    }
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = hand[r * 32 + lane];
    const float mm = fmaxf(m[r], m1);
    const float w0 = pow2_int(m[r] - mm);
    const float w1 = pow2_int(m1 - mm);
    l[r] = w0 * l[r] + w1 * hand[(2 + r) * 32 + lane];
    m[r] = mm;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        o[j][e] = w0 * o[j][e] + w1 * hand[(4 + 4 * j + e) * 32 + lane];
      }
    }
  }

  if (gridDim.y == 1) {
    T* o_b = out + ((long long)b * Hq + (long long)h * G) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = r0 + 8 * r;
      if (g >= G) continue;
      const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(o_b + g * D + j * 8 + c0) =
            __floats2bfloat162_rn(o[j][2 * r] / den, o[j][2 * r + 1] / den);
      }
    }
    return;
  }
  const Partials part(ws, G, D);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = r0 + 8 * r;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<float2*>(part.acc + g * D + j * 8 + c0) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
    }
    if (c0 == 0) {
      part.m[g] = m[r];
      part.l[g] = l[r];
    }
  }
}

// Combine the S <= kMaxSplits partials (m, l, acc) of one (slot, KV head)
// into its G heads' outputs: m = max_s m_s, w_s = pow2_int(m_s - m), l =
// sum_s w_s l_s, acc = sum_s w_s acc_s, out = acc / max(l, 1e-20).  One
// block per (b, h), a warp per head; lane u reads split u's (m, l), and
// every lane its two dims of all S accumulators.  Launched as a
// programmatic dependent of the split kernel: it waits for that grid's
// results before reading them.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
paged_attention_combine_kernel(const float* __restrict__ ws,
                               T* __restrict__ out, int S, int Hq, int Hkv,
                               int D) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bh = blockIdx.x;
  const int G = Hq / Hkv;
  const long long n_part = (long long)gridDim.x * S * G;
  const float* ws_m = ws + n_part * D;
  const float* ws_l = ws_m + n_part;
  const long long part0 = (long long)bh * S * G;
  T* o_b = out + ((long long)(bh / Hkv) * Hq + (long long)(bh % Hkv) * G) * D;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += blockDim.x >> 5) {
    const float m_u = lane < S ? __ldcg(ws_m + part0 + (long long)lane * G + g)
                               : kNegInf;
    const float l_u = lane < S ? __ldcg(ws_l + part0 + (long long)lane * G + g)
                               : 0.0f;
    for (int d0 = 0; d0 < D; d0 += 64) {        // two dims a lane
      const int d = d0 + 2 * lane;
      const bool on = d < D;
      const float* ag = ws + (part0 + g) * D + d;
      float2 v[kMaxSplits];
#pragma unroll
      for (int u = 0; u < kMaxSplits; ++u) {
        v[u] = on && u < S ? __ldcg(reinterpret_cast<const float2*>(
                                 ag + (long long)u * G * D))
                           : make_float2(0.0f, 0.0f);
      }
      const float m = warp_max(m_u);
      const float w_u = pow2_int(m_u - m);
      const float den = fmaxf(warp_sum(w_u * l_u), 1e-20f);
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int u = 0; u < kMaxSplits; ++u) {
        const float w = __shfl_sync(0xffffffffu, w_u, u);
        a0 += w * v[u].x;
        a1 += w * v[u].y;
      }
      if (on) {
        o_b[g * D + d] = from_f<T>(a0 / den);
        o_b[g * D + d + 1] = from_f<T>(a1 / den);
      }
    }
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it is above the 48 KB default.
template <typename K, typename... Args>
cudaError_t launch_split(K kernel, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, int BS>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* table, const void* cache_len, void* out,
                       void* ws, int Hq, int Hkv, int nb, int window,
                       int chunk, float scale) {
  using T = __nv_bfloat16;
  const size_t smem =
      sizeof(T) * (size_t)(kMmaStages * 2 * BS + 16) * padded_row<T>(D);
  return launch_split(paged_attention_mma_kernel<D, BS>, grid, kMmaThreads,
                      smem, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k_pool),
                      static_cast<const T*>(v_pool),
                      static_cast<const int32_t*>(table),
                      static_cast<const int32_t*>(cache_len),
                      static_cast<T*>(out), static_cast<float*>(ws), Hq, Hkv,
                      nb, window, chunk, scale);
}

// The tensor-core kernel's instantiations for one D, by block size.
template <int D>
cudaError_t launch_mma_bs(int bs, dim3 grid, cudaStream_t st, const void* q,
                          const void* k, const void* v, const void* table,
                          const void* cache_len, void* out, void* ws, int Hq,
                          int Hkv, int nb, int window, int chunk, float scale) {
  switch (bs) {
    case 16:
      return launch_mma<D, 16>(grid, st, q, k, v, table, cache_len, out, ws,
                               Hq, Hkv, nb, window, chunk, scale);
    case 32:
      return launch_mma<D, 32>(grid, st, q, k, v, table, cache_len, out, ws,
                               Hq, Hkv, nb, window, chunk, scale);
    default:
      return launch_mma<D, 64>(grid, st, q, k, v, table, cache_len, out, ws,
                               Hq, Hkv, nb, window, chunk, scale);
  }
}

bool mma_route(int dtype, int G, int D, int bs) {
  return dtype == 1 && G <= 16 && (D == 64 || D == 128) &&
         (bs == 16 || bs == 32 || bs == 64);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* cache_len, void* out,
                   void* ws, int B, int Hq, int Hkv, int D, int bs, int nb,
                   int window, int S, int chunk, float scale, bool mma,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int warps = G < 4 ? 4 : (G > 8 ? 8 : G);
  const dim3 grid(B * Hkv, S);
  cudaError_t e;
  if (mma) {
    e = D == 64 ? launch_mma_bs<64>(bs, grid, stream, q, k_pool, v_pool, table,
                                    cache_len, out, ws, Hq, Hkv, nb, window,
                                    chunk, scale)
                : launch_mma_bs<128>(bs, grid, stream, q, k_pool, v_pool,
                                     table, cache_len, out, ws, Hq, Hkv, nb,
                                     window, chunk, scale);
  } else {
    const size_t smem = sizeof(T) * (size_t)kStages * 2 * bs * padded_row<T>(D) +
                        sizeof(float) * (size_t)(2 * G * D + G * bs + 2 * G);
    e = launch_split(paged_attention_simt_kernel<T>, grid, 32 * warps, smem,
                     stream, static_cast<const T*>(q),
                     static_cast<const T*>(k_pool),
                     static_cast<const T*>(v_pool),
                     static_cast<const int32_t*>(table),
                     static_cast<const int32_t*>(cache_len),
                     static_cast<T*>(out), static_cast<float*>(ws), Hq, Hkv,
                     D, bs, nb, window, chunk, scale);
  }
  if (e != cudaSuccess || S == 1) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attention_combine_kernel<T>,
                         static_cast<const float*>(ws), static_cast<T*>(out),
                         S, Hq, Hkv, D);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, 1, Hq, D); k_pool, v_pool: (NB, bs, Hkv, D); table: (B, nb)
// int32, every entry < NB; cache_len: (B,) int32, each <= nb * bs.  All
// contiguous, 16-byte aligned, D a multiple of 16 / itemsize.  S <= 32
// splits of `chunk` logical blocks each, S * chunk >= nb; for S > 1, ws
// holds B * Hkv * S * G * (D + 2) floats and a second kernel combines the
// splits.  dtype: 0 for float32, 1 for bfloat16.  Returns
// cudaGetLastError() after the launches.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* table,
                               const void* cache_len, void* out, void* ws,
                               int B, int Hq, int Hkv, int D, int bs, int nb,
                               int window, int S, int chunk, float scale,
                               int dtype, void* stream) {
  if (B == 0) return 0;
  if (S < 1 || S > kMaxSplits || chunk < 1 || (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = mma_route(dtype, Hq / Hkv, D, bs);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, cache_len, out, ws,
                                 B, Hq, Hkv, D, bs, nb, window, S, chunk,
                                 scale, mma, st);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, cache_len, out, ws, B, Hq,
                         Hkv, D, bs, nb, window, S, chunk, scale, mma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
