// Fused block-paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention_kernel.  For each slot b it computes one query token's
// softmax(q K^T / sqrt(D)) V straight from the (NB, bs, Hkv, D) KV block
// pool, following the slot's row of the block table; no gathered copy of
// the cache is ever written.
//
// Bound: bytes.  A decode token does 4*D flops per KV element it reads, far
// below the card's ~295 flops per byte, so the time floor is reading the
// K/V blocks the slot's length needs.  Design:
//   * one thread block per (slot b, KV head h): the G = Hq / Hkv query
//     heads of the group share every K/V tile the block loads, so each K/V
//     byte is read from device memory once;
//   * the block walks only the logical blocks j < ceil(cache_len / bs)
//     (and, with a window, only those that reach into it), loading its own
//     table entries -- on the TPU the wrapper's effective table and the
//     revisit skip did this, here the loop bound does;
//   * K/V tiles go through shared memory as f32 with 16-byte vector loads;
//     the running max m, denominator l and accumulator acc stay in f32;
//   * the online softmax is the reference's base-2 one with an integer
//     running max: s = q.k * log2(e)/sqrt(D), m_new = max(m, ceil(rowmax)),
//     p = exp2(s - m_new), corr = pow2_int(m - m_new), an exact power of two
//     built from the exponent bits, so the carry update never rounds on the
//     multiply.  p is rounded to the pool's type before the PV product, as
//     the reference does.
// The grid is small (B * Hkv blocks): a later change can split the KV walk
// over more blocks.  This kernel is the plain, correct first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

// Load one 16-byte vector of T from `src` (16-byte aligned) into f32 `dst`.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < VEC; ++e) dst[e] = to_f(t[e]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ cache_len,
                       T* __restrict__ out, int Hq, int Hkv, int D, int bs,
                       int nb, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const int KD = D + 1;                         // padded K row: no bank conflicts

  extern __shared__ float smem[];
  float* q_s = smem;                            // [G][D]
  float* k_s = q_s + G * D;                     // [bs][D + 1]
  float* v_s = k_s + bs * KD;                   // [bs][D]
  float* s_s = v_s + bs * D;                    // [G][bs]
  float* acc_s = s_s + G * bs;                  // [G][D]
  float* m_s = acc_s + G * D;                   // [G]
  float* l_s = m_s + G;                         // [G]
  float* c_s = l_s + G;                         // [G] this step's rescale

  const T* q_b = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(q_b[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }

  const int clen = cache_len[b];
  const int n_blocks = (clen + bs - 1) / bs;
  const long long row_stride = (long long)Hkv * D;   // between positions t
  const int vecs_per_row = D / VEC;

  for (int j = 0; j < n_blocks; ++j) {
    const int first = j * bs;
    if (window && first + bs <= clen - window) continue;   // before the window
    const long long phys = table[(long long)b * nb + j];
    const T* k_blk = k_pool + (phys * bs * Hkv + h) * (long long)D;
    const T* v_blk = v_pool + (phys * bs * Hkv + h) * (long long)D;
    __syncthreads();                          // previous step done with tiles
    for (int i = tid; i < bs * vecs_per_row; i += kThreads) {
      const int t = i / vecs_per_row;
      const int d = (i % vecs_per_row) * VEC;
      float kv[VEC];
      load_vec(k_blk + t * row_stride + d, kv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) k_s[t * KD + d + e] = kv[e];
      load_vec(v_blk + t * row_stride + d, v_s + t * D + d);
    }
    __syncthreads();
    // scores s[g][t] = (q_g . k_t) * scale, masked to NEG_INF
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs;
      const int t = i % bs;
      const float* qg = q_s + g * D;
      const float* kt = k_s + t * KD;
      float dot = 0.0f;
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kt[d], dot);
      const int pos = first + t;
      bool valid = pos < clen;
      if (window) valid = valid && pos >= clen - window;
      s_s[i] = valid ? dot * scale : kNegInf;
    }
    __syncthreads();
    // per query head: integer running max, exp2, exact rescale
    for (int g = warp; g < G; g += n_warps) {
      float mx = -INFINITY;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, s_s[g * bs + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, ceilf(mx));
      float sum = 0.0f;
      for (int t = lane; t < bs; t += 32) {
        const float p = exp2f(s_s[g * bs + t] - m_new);
        s_s[g * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = pow2_int(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc[g][d] = acc * corr + sum_t round(p[g][t]) * v[t][d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pg = s_s + g * bs;
      float a = 0.0f;
      for (int t = 0; t < bs; ++t) a = fmaf(round_to<T>(pg[t]), v_s[t * D + d], a);
      acc_s[i] = acc_s[i] * c_s[g] + a;
    }
  }
  __syncthreads();
  T* o_b = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    o_b[i] = from_f<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-20f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* cache_len, void* out, int B,
                   int Hq, int Hkv, int D, int bs, int nb, int window,
                   float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      (size_t)(2 * G * D + bs * (2 * D + 1) + G * bs + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(cache_len), static_cast<T*>(out), Hq, Hkv,
      D, bs, nb, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, 1, Hq, D); k_pool, v_pool: (NB, bs, Hkv, D); table: (B, nb)
// int32, every entry < NB; cache_len: (B,) int32, each <= nb * bs.  All
// contiguous, 16-byte aligned, D a multiple of 16 / itemsize.  dtype: 0 for
// float32, 1 for bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* table,
                               const void* cache_len, void* out, int B, int Hq,
                               int Hkv, int D, int bs, int nb, int window,
                               float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, cache_len, out, B,
                                 Hq, Hkv, D, bs, nb, window, scale, s);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, cache_len, out, B, Hq, Hkv,
                         D, bs, nb, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
