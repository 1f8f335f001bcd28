// First-order linear recurrence h_t = a_t * h_{t-1} + x_t, h_{-1} = 0, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/linear_scan.py::
// linear_scan_kernel and its padded wrapper linear_scan: the inner loop of
// RG-LRU.  a, x, h: (B, S, W) float32, contiguous.
//
// The step is written __fadd_rn(__fmul_rn(a, h), x): nvcc would otherwise
// contract a * h + x into one FMA, which rounds once instead of twice and
// so differs from the plain version (a multiply, then an add) in the last
// bit.  Each (b, w) channel is walked in order of t by one thread, so the
// f32 operations are exactly the plain version's, bit for bit.
//
// Bound: bytes.  Each step reads 8 bytes and writes 4 and does two flops.
// The work is sequential in t, so parallelism comes only from the B * W
// channels: at B = 1, W = 4096 that is 128 warps, about one per SM, and a
// warp that waited on each load in turn would see the memory's latency on
// every step.  Design: one block per (32 channels, batch row) with
// kThreads threads.  All of them copy (kBT steps x 32 channels) tiles of a
// and x into shared memory with cp.async (one warp per time step, 128
// contiguous bytes), two stages deep, so the next tile is in flight while
// warp 0 walks the current one.  h stays in warp 0's registers across
// tiles; each output row of 32 channels is one coalesced 128-byte store.
// Ragged edges (S % kBT, W % 32) are zero-filled copies and masked stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBW = 32;        // channels per block: one warp walks them
constexpr int kBT = 64;        // time steps per shared-memory tile
constexpr int kThreads = 256;  // copy threads per block

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;   // 0 source bytes: the 4 bytes are zeroed
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                   float* __restrict__ h_out, int S, int W) {
  __shared__ float a_s[2][kBT][kBW];
  __shared__ float x_s[2][kBT][kBW];
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * kBW;
  const long long base = (long long)blockIdx.y * S * W;
  const int n_tiles = (S + kBT - 1) / kBT;

  // thread tid copies column tid % kBW of rows tid / kBW, + kThreads/kBW, ...
  const int col = tid % kBW;
  const bool col_ok = w0 + col < W;
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kBT;
    for (int r = tid / kBW; r < kBT; r += kThreads / kBW) {
      const int t = t0 + r;
      const bool ok = col_ok && t < S;
      const long long at = base + (long long)(ok ? t : 0) * W +
                           (col_ok ? w0 + col : 0);
      cp_async4(&a_s[stage][r][col], a + at, ok);
      cp_async4(&x_s[stage][r][col], x + at, ok);
    }
    cp_async_commit();
  };

  float h = 0.0f;
  load_tile(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();          // this thread's copies of `tile` landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // ... and every other thread's
    if (tid < kBW) {
      const int t0 = tile * kBT;
      const int steps = min(kBT, S - t0);
      float* dst = h_out + base + (long long)t0 * W + w0 + tid;
#pragma unroll 8
      for (int r = 0; r < steps; ++r) {
        h = __fadd_rn(__fmul_rn(a_s[stage][r][tid], h), x_s[stage][r][tid]);
        if (col_ok) dst[(long long)r * W] = h;
      }
    }
    __syncthreads();               // the stage is free to refill
  }
}

}  // namespace

// a, x, h: (B, S, W) float32, contiguous, on one device.  Returns
// cudaGetLastError() after the launch.
extern "C" int linear_scan(const void* a, const void* x, void* h, int B,
                           int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + kBW - 1) / kBW, B);
  linear_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(h), S, W);
  return cudaGetLastError();
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
