// int8 x int8 -> int32 matmul with a power-of-two dequant, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul.py::qmatmul_kernel
// and its padded wrapper repro/kernels/ops.py::qmatmul:
//
//   y[m, n] = f32(sum_k x[m, k] * w[k, n]) * 2^-e[n],
//
// x (M, K) int8 row-major, w (K, N) int8 row-major (quantize_pot(w, axis=0)
// gives it so), e (N,) int32, y (M, N) float32 or bfloat16.  The sum is an
// int32 accumulator that wraps modulo 2^32, as the reference's int32 does;
// it is converted to f32 rounded to nearest even (__int2float_rn), then
// multiplied by 2^-e built from exponent bits with ops.exp2_int's clamp,
// so the scale is exact and the product rounds only when it leaves the
// normal range.  bf16 output rounds that f32 to nearest even.  Built
// without --use_fast_math: no flush to zero.
//
// Bound: with f32 output, bytes at every qwen2-0.5b width (x, w, e and
// the 4-byte outputs against ~3.35 TB/s), at M = 512 as at M = 8; only a
// K = 151936 product at prefill-sized M is bound by its operations (two
// int8 operations per multiply-add against ~1979 TOP/s).
//
// Design, a simple one that is right first.  The int8 tensor cores take
// the products through mma.sync.m16n8k32.s32.s8.s8.s32, exact in int32,
// the Hopper counterpart of the MXU's int8 path.  A block of 128 threads
// owns a 64 x 64 output tile and walks K in steps of 64: it stages the
// (64 m, 64 k) tile of x and the (64 k, 64 n) tile of w in shared memory,
// the latter transposed to (n, k), because mma's B operand wants four
// K-consecutive bytes of one column while w is N-contiguous (ldmatrix.trans
// moves 16-bit elements only).  Each thread loads four rows of 8 n-bytes
// and transposes them in registers into 8 words of 4 k-bytes.  Rows of
// both tiles are 80 bytes apart, so the fragment reads of a warp hit 32
// distinct banks.  The next K step's tiles are loaded into registers while
// the tensor cores work on the current one.  Each warp computes a 32 x 32
// quarter of the tile as 2 x 4 mma tiles.  Past M, N and K the tiles are
// zero-filled, so any shape is taken and nothing is padded by the caller;
// 8-byte loads are used where K (for x) and N (for w) are multiples of 8,
// byte loads elsewhere.  wgmma, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // output rows per block
constexpr int kBN = 64;              // output columns per block
constexpr int kBK = 64;              // K step
constexpr int kRow = kBK + 16;       // shared-memory row pitch, bytes
constexpr int kThreads = 128;        // 4 warps, 2 x 2, 32 x 32 each

// Eight bytes of row-major int8 starting at p[0], the ones at or past
// `valid` zero.  kVec: p is 8-byte aligned and valid is 0 or >= 8.
template <bool kVec>
__device__ __forceinline__ uint64_t load8(const int8_t* p, int valid) {
  if (kVec) {
    return valid >= 8 ? *reinterpret_cast<const uint64_t*>(p) : 0ull;
  }
  uint64_t v = 0ull;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < valid) v |= static_cast<uint64_t>(static_cast<uint8_t>(p[j]))
                        << (8 * j);
  }
  return v;
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <bool kVecX, bool kVecW, typename OutT>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ e, OutT* __restrict__ y, int M,
               int N, int K) {
  __shared__ __align__(16) int8_t xs[kBM * kRow];   // (m, k)
  __shared__ __align__(16) int8_t ws[kBN * kRow];   // (n, k): w transposed
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma's groupID, thread
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // x tile: 512 runs of 8 k-bytes, 4 per thread, run r = tid + 128 i at
  // row r / 8, k-bytes 8 (r % 8).  w tile: thread tid owns k-rows
  // 4 (tid / 8) .. +3 and n-bytes 8 (tid % 8) .. +7.
  const int wk = 4 * (tid >> 3), wc = 8 * (tid & 7);
  uint64_t xr[4], wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid + kThreads * i;
      const long long m = m0 + (r >> 3);
      const int k = k0 + 8 * (r & 7);
      xr[i] = m < M ? load8<kVecX>(x + m * K + k, K - k) : 0ull;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + wk + i;
      const int n = n0 + wc;
      wr[i] = k < K ? load8<kVecW>(w + (long long)k * N + n, N - n) : 0ull;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid + kThreads * i;
      *reinterpret_cast<uint64_t*>(xs + (r >> 3) * kRow + 8 * (r & 7)) =
          xr[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {          // column wc + j: 4 k-bytes
      uint32_t v = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v |= static_cast<uint32_t>((wr[i] >> (8 * j)) & 0xffu) << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(ws + (wc + j) * kRow + wk) = v;
    }
  };

  int32_t acc[2][4][4] = {};
  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                       // the previous step is read
    stage();
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);      // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = xs + (wm + 16 * mi + g) * kRow + kk + 4 * t;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kRow);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = ws + (wn + 8 * ni + g) * kRow + kk + 4 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                 b[ni][0], b[ni][1]);
        }
      }
    }
  }

  // epilogue: acc[mi][ni][i] is row g (+8 for i >= 2), column 2t + (i & 1)
  // of mma tile (mi, ni)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + 8 * ni + 2 * t + c;
      if (n >= N) continue;
      // exp2_int(-e): the exponent bits of 2^-e, -e clamped to
      // [-126, 127]; -e wraps like torch's int32 negation
      int ne = static_cast<int>(0u - static_cast<uint32_t>(e[n]));
      ne = ne < -126 ? -126 : (ne > 127 ? 127 : ne);
      const float scale = __int_as_float((ne + 127) << 23);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm + 16 * mi + g + 8 * h;
          if (m < M) {
            store(y + m * N + n,
                  __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + c]), scale));
          }
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* e, void* y, int M,
           int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool vx = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const bool vw = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto ep = static_cast<const int32_t*>(e);
  auto yp = static_cast<OutT*>(y);
  if (vx && vw) {
    qmatmul_kernel<true, true><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                         N, K);
  } else if (vx) {
    qmatmul_kernel<true, false><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                          N, K);
  } else if (vw) {
    qmatmul_kernel<false, true><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                          N, K);
  } else {
    qmatmul_kernel<false, false><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp,
                                                           M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) int8; w: (K, N) int8; e: (N,) int32; y: (M, N), float32 when
// bf16 is 0, bfloat16 otherwise; all contiguous on one device.  Returns
// cudaGetLastError() after the launch.
extern "C" int qmatmul(const void* x, const void* w, const void* e, void* y,
                       int M, int N, int K, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(x, w, e, y, M, N, K, stream)
              : launch<float>(x, w, e, y, M, N, K, stream);
}

extern "C" const char* qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
