// CSD digit-plane shift-add matvec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/csd_matvec.py::
// csd_matvec_kernel and ::csd_qsweep_kernel.  Both compute the bit-exact
// shift-add datapath of the paper's multiplierless designs,
//
//   y[q, m, n] = sum_d ( sum_k x[q, m, k] * p[q, d, k, n] ) << d   (int32),
//
// with x (Q, M, K) int32 activations, p (Q, D, K, N) int8 CSD digit planes
// in {-1, 0, 1}, least-significant plane first, and y (Q, M, N) int32.
// csd_matvec is the Q = 1 case.  All arithmetic wraps modulo 2^32, as the
// reference's int32 does: sums and products run in uint32 (a signed
// overflow or a left shift of a negative int32 is undefined in C++17), and
// a plane d >= 32 adds 0 mod 2^32, as XLA's shift does.  Modulo 2^32 the
// sum may be taken in any order, so the result is bit-identical to the
// reference's plane-by-plane sum.  The callers' int32 guards keep real
// results in range, so the wrap never shows.
//
// Bound: bytes.  At the paper's shapes each output costs D*K multiply-adds
// on 8-bit values, a few hundred, against 4*K bytes of x read and 4 bytes
// of y written; the planes are tiny.
//
// Design, a simple one that is right first.  The TPU kernel runs one MXU
// pass per plane and shifts each pass's sum.  On CUDA cores a pass per
// plane costs D loads and multiply-adds per (k, output), so here the
// shift-add runs once per block instead: the block combines the planes of
// its (BK, BN) tile into the tile's weights, sum_d p_d << d in uint32, in
// shared memory, and each thread then takes K multiply-adds per output.
// A block covers BN = min(N, 32) columns and R passes of BM = 256 / BN
// rows (at the paper's N = 10: 25 rows, one contiguous run of y, per
// pass); a thread owns one column of R rows.  K is walked in chunks of BK.
// M, N, K and D are runtime values with no tile constraint; the ragged
// edges are masked.  int8 tensor-core MMA would carry the products once
// the kernel is not bound by its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPasses = 4;                 // row passes per block
constexpr int kSmemBudget = 40 * 1024;        // bytes of shared memory

__global__ void csd_planes_kernel(const int32_t* __restrict__ x,
                                  const int8_t* __restrict__ planes,
                                  int32_t* __restrict__ out,
                                  int M, int K, int N, int D,
                                  int bm, int bn, int bk, int passes) {
  extern __shared__ uint32_t sw[];            // (bk, bn) combined weights
  const long long q = blockIdx.z;
  const int n0 = blockIdx.y * bn;
  const int t = threadIdx.x;
  const int ml = t / bn;
  const int nl = t - ml * bn;
  const int n = n0 + nl;
  const long long m0 = (long long)blockIdx.x * bm * passes + ml;
  const bool lane = ml < bm && n < N;
  const int dmax = D < 32 ? D : 32;           // planes d >= 32 add 0

  const int32_t* xq = x + q * (long long)M * K;
  const int8_t* pq = planes + q * (long long)D * K * N;
  uint32_t acc[kMaxPasses] = {0u, 0u, 0u, 0u};

  for (int k0 = 0; k0 < K; k0 += bk) {
    const int kc = (K - k0) < bk ? (K - k0) : bk;
    __syncthreads();                          // the previous chunk is used
    for (int i = t; i < bk * bn; i += blockDim.x) {
      const int kk = i / bn;
      const int nc = n0 + (i - kk * bn);
      uint32_t w = 0u;
      if (kk < kc && nc < N) {
        const int8_t* p = pq + (long long)(k0 + kk) * N + nc;
        for (int d = 0; d < dmax; ++d) {      // the shift-add of one weight
          w += static_cast<uint32_t>(static_cast<int32_t>(
                   p[(long long)d * K * N])) << d;
        }
      }
      sw[i] = w;
    }
    __syncthreads();
    if (lane) {
#pragma unroll
      for (int r = 0; r < kMaxPasses; ++r) {
        const long long m = m0 + (long long)r * bm;
        if (r < passes && m < M) {
          const int32_t* xr = xq + m * K + k0;
          uint32_t s = 0u;
          for (int kk = 0; kk < kc; ++kk) {
            s += static_cast<uint32_t>(xr[kk]) * sw[kk * bn + nl];
          }
          acc[r] += s;
        }
      }
    }
  }
  if (lane) {
#pragma unroll
    for (int r = 0; r < kMaxPasses; ++r) {
      const long long m = m0 + (long long)r * bm;
      if (r < passes && m < M) {
        out[q * (long long)M * N + m * N + n] = static_cast<int32_t>(acc[r]);
      }
    }
  }
}

int launch(const void* x, const void* planes, void* out, int Q, int M, int K,
           int N, int D, void* stream) {
  if (Q <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || D <= 0) {                     // an empty sum: y = 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(int32_t) * (size_t)Q * M * N, s));
  }
  const int bn = N < 32 ? N : 32;
  const int bm = kThreads / bn;
  int bk = kSmemBudget / (4 * bn);
  if (bk > K) bk = K;
  const long long row_tiles = (M + bm - 1) / bm;
  // several row passes per block where there are rows enough to keep
  // every SM busy with them; one where there are not
  const int passes = row_tiles * Q >= 8LL * 132 * kMaxPasses ? kMaxPasses : 1;
  const long long rows_per_block = (long long)bm * passes;
  dim3 grid((unsigned)((M + rows_per_block - 1) / rows_per_block),
            (N + bn - 1) / bn, Q);
  csd_planes_kernel<<<grid, kThreads, sizeof(uint32_t) * bk * bn, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int8_t*>(planes),
      static_cast<int32_t*>(out), M, K, N, D, bm, bn, bk, passes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) int32; planes: (D, K, N) int8; out: (M, N) int32; all
// contiguous on one device.  Returns cudaGetLastError() after the launch.
extern "C" int csd_matvec(const void* x, const void* planes, void* out,
                          int M, int K, int N, int D, void* stream) {
  return launch(x, planes, out, 1, M, K, N, D, stream);
}

// x: (Q, M, K) int32; planes: (Q, D, K, N) int8, every network's planes
// zero-padded to the shared depth D; out: (Q, M, N) int32.
extern "C" int csd_qsweep(const void* x, const void* planes, void* out,
                          int Q, int M, int K, int N, int D, void* stream) {
  return launch(x, planes, out, Q, M, K, N, D, stream);
}

extern "C" const char* csd_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* csd_qsweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
