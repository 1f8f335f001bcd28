// Flash attention (online softmax) for Hopper (sm_90a): causal and local
// windows, GQA, a kv_len / offset alignment.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_kernel and its padded wrapper.  q (B, Sq, Hq, D) attends
// to k, v (B, Skv, Hkv, D); query head h reads KV head h / (Hq / Hkv)
// straight from k and v (no repeated copy).  Row i sits at position
// i + offset and sees key j when j < kv_len, j <= i + offset (causal) and
// j > i + offset - window (window > 0).
//
// The arithmetic is the TPU kernel's: scores q.k in f32 times 1/sqrt(D),
// masked scores exactly -1e30 (never -inf), the running max m starting at
// -1e30, p = exp(s - m_new) and corr = exp(m - m_new) in f32, l = l * corr +
// sum(p), acc = acc * corr + round(p) V with p rounded to V's type, and the
// output acc / max(l, 1e-20).  A key a row does not see, met before the
// row's first visible key, adds exp(0) = 1 to l and v to acc; the first
// visible key makes corr = exp(-1e30 - m) exactly 0, which wipes them.  So a
// tile that lies wholly outside every row's visible range changes nothing
// and is skipped.  A row that sees no key at all keeps what the masked keys
// it walked add up to: the mean of v over them.  Such a row walks every key
// j < kv_pad, the kv length padded to the caller's tile (the padding reads
// as zeros), as the reference's chunked scan does.  Rows with a visible key
// do not depend on kv_pad.
//
// Bound: operations at the shapes of the main path (4 * D flops per visible
// (query, key) pair against 2 * D * itemsize bytes per key), but this first
// version runs on the CUDA cores in f32, not the tensor cores.  Design:
//   * one thread block per (64 query rows, query head, batch row); each row
//     is held by D / 32 threads (D / 16 for D = 16), each owning 32 of its
//     dims of q and of the f32 accumulator in registers;
//   * K and V tiles of 32 keys staged in shared memory as f32, rows padded
//     so the threads of one row read different banks;
//   * per tile: 32 scores per row (a shuffle sum across the row's threads),
//     the tile max, one rescale, then p V -- the online softmax per tile;
//   * the block walks only the keys some row of it needs: from the first
//     visible key of its first row to the last of its last row (the causal
//     frontier), or from 0 to kv_pad when a row sees none.
// Tensor cores (mma / wgmma), TMA and double buffering come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round p to V's type and back (the reference's p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Load one 16-byte vector of T from `src` into f32 `dst`.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < VEC; ++e) dst[e] = to_f(t[e]);
}

template <int D>
struct Shape {
  static constexpr int DPT = D < 32 ? D : 32;   // dims of a row per thread
  static constexpr int TPR = D / DPT;           // threads per query row
  static constexpr int THREADS = kBQ * TPR;
  static constexpr int PART = DPT + 4;          // a thread's dims in smem,
                                                // padded: 16-byte aligned,
                                                // 4 banks apart
  static constexpr int ROW = TPR * PART;        // floats per staged key
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int Hq, int Hkv, int kv_len, int offset,
                       int causal, int window, int kv_pad, float scale) {
  using S = Shape<D>;
  constexpr int DPT = S::DPT, TPR = S::TPR, PART = S::PART, ROW = S::ROW;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                  // 16-byte vectors per key row
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int r = blockIdx.x * kBQ + tid / TPR;   // this thread's query row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool live = r < Sq;
  const int qp = r + offset;                    // its position

  extern __shared__ float smem[];
  float* k_s = smem;                            // [kBK][ROW]
  float* v_s = smem + kBK * ROW;                // [kBK][ROW]
  __shared__ int lo_s, hi_s;

  float qr[DPT];
  float acc[DPT];
  {
    const T* src = q + (((long long)b * Sq + (live ? r : 0)) * Hq + h) * D +
                   part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += VEC) load_vec(src + d, qr + d);
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;
  }

  // the row's visible keys [vis_lo, vis_hi)
  const int vis_lo = window ? max(qp - window + 1, 0) : 0;
  const int vis_hi = causal ? min(qp + 1, kv_len) : kv_len;
  const bool visible = vis_lo < vis_hi;
  // the keys this block walks: the union of its rows' needs
  if (tid == 0) {
    lo_s = INT_MAX;
    hi_s = 0;
  }
  __syncthreads();
  if (live && part == 0) {
    atomicMin(&lo_s, visible ? vis_lo : 0);
    atomicMax(&hi_s, visible ? vis_hi : kv_pad);
  }
  __syncthreads();
  const int lo = (lo_s / kBK) * kBK;
  const int hi = hi_s;

  float m = kNegInf, l = 0.0f;
  for (int kv0 = lo; kv0 < hi; kv0 += kBK) {
    __syncthreads();                            // the last tile is consumed
    for (int i = tid; i < kBK * VPR; i += S::THREADS) {
      const int j = i / VPR;
      const int d = (i % VPR) * VEC;
      float* kd = k_s + j * ROW + (d / DPT) * PART + d % DPT;
      float* vd = v_s + j * ROW + (d / DPT) * PART + d % DPT;
      const int kv = kv0 + j;
      if (kv < Skv) {
        const long long at = (((long long)b * Skv + kv) * Hkv + hk) * D + d;
        load_vec(k + at, kd);
        load_vec(v + at, vd);
      } else {                                  // past the array: zeros
#pragma unroll
        for (int e = 0; e < VEC; ++e) kd[e] = vd[e] = 0.0f;
      }
    }
    __syncthreads();
    float s[kBK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* kr = k_s + j * ROW + part * PART;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < DPT; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int kv = kv0 + j;
      bool valid = kv < kv_len;
      if (causal) valid = valid && kv <= qp;
      if (window) valid = valid && kv > qp - window;
      float x = valid ? dot * scale : kNegInf;
      x = kv < kv_pad ? x : -INFINITY;          // not walked: adds nothing
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      s[j] = round_to<T>(p);
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* vr = v_s + j * ROW + part * PART;
#pragma unroll
      for (int d = 0; d < DPT; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-20f);
  T* dst = out + (((long long)b * Sq + r) * Hq + h) * D + part * DPT;
#pragma unroll
  for (int d = 0; d < DPT; d += VEC) {
    alignas(16) T o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = from_f<T>(acc[d + e] / denom);
    *reinterpret_cast<uint4*>(dst + d) = *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int Hq, int Hkv, int kv_len,
                   int offset, int causal, int window, int kv_pad,
                   float scale, cudaStream_t stream) {
  using S = Shape<D>;
  const size_t smem = sizeof(float) * 2 * kBK * S::ROW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, S::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      kv_len, offset, causal, window, kv_pad, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                     int kv_len, int offset, int causal, int window,
                     int kv_pad, float scale, cudaStream_t s) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, out, B, Sq, Skv, Hq, Hkv, kv_len, offset, \
                         causal, window, kv_pad, scale, s);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// q, out: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); all contiguous and
// 16-byte aligned, one dtype (0 float32, 1 bfloat16); D in {16, 32, 64,
// 128, 256}; Hq % Hkv == 0.  kv_len <= Skv keys are real; row i sits at
// i + offset.  kv_pad >= Skv: the keys a row that sees none walks (see the
// note at the top).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int Hq,
                               int Hkv, int D, int kv_len, int offset,
                               int causal, int window, int kv_pad,
                               float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv,
                                   kv_len, offset, causal, window, kv_pad,
                                   scale, s);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, kv_len,
                           offset, causal, window, kv_pad, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
