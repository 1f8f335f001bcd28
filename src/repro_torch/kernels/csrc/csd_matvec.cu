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
// Two kernels.  The TPU kernel runs one MXU pass per plane and shifts each
// pass's sum.  On CUDA cores a pass per plane costs D loads and
// multiply-adds per (k, output), so both kernels run the shift-add once
// per weight instead, combining planes into weights sum_d p_d << d in
// uint32 in shared memory; each output then takes K multiply-adds.
//
// csd_planes_kernel (csd_matvec, and csd_qsweep's "chunked" route for
// weights too large for one block's shared memory): a block covers BN =
// min(N, 32) columns and R passes of BM = 256 / BN rows (at the paper's N =
// 10: 25 rows, one contiguous run of y, per pass); a thread owns one column
// of R rows and reads x from global memory.  K is walked in chunks of BK
// whose (BK, BN) weights the block combines.  M, N, K and D are runtime
// values with no tile constraint; the ragged edges are masked.
//
// csd_resident_kernel (csd_qsweep's "resident" route, every layer of the
// paper's sweeps: K, N in {10, 16}): the sweep's shapes are small (at
// (4, 2248, 16) x (16, 16), 1.15 MB of x and y), so its time is a launch
// and one round trip to memory.  A block takes kResRows rows of one q;
// their x and y are each one contiguous run of memory, and so are the q's
// planes.  The block copies x's run and the planes d < 32 into shared
// memory together by cp.async (16 bytes a thread where aligned), so their
// latencies overlap; combines the q's whole (K, N) weight matrix there;
// then each thread takes one row and 4 columns: 4 sums in registers, one
// 16-byte shared load of weights a k.  y is stored 16 bytes a thread: from
// registers where N is a multiple of 4, else staged in shared memory and
// stored as one contiguous run.
//
// csd_stream_kernel (csd_matvec's "streaming" route, every shape whose
// combined (K, N) weights and its tiles fit shared memory: the paper's
// dense-tail layers, K, N in {10, 16}): one network of many rows, e.g.
// (287744, 10) x (8, 10, 10) in one polish call, 23 MB of x and y.  A
// persistent grid of a few blocks an SM; each block combines the weights
// once into shared memory, then streams its tiles (kStreamRows rows, tiles
// blockIdx.x, + gridDim.x, ...) through a kStreamStages-deep ring: one
// thread asks for a tile's x, one contiguous run, as one cp.async.bulk
// completed on the stage's mbarrier, kStreamStages tiles ahead.  A bulk
// copy needs 16-byte boundaries, so it copies the run widened to them and
// the threads read past the few words it adds: x off a 16-byte boundary
// takes the same path.  Each thread takes one row and every column, 4
// columns to a 16-byte shared load of weights (a broadcast) a k, its x
// row and y row in 16-byte shared accesses where K and N are multiples of
// 4 (at 16 a warp's rows would meet in one bank 16 times over a word at a
// time); y is staged in shared memory, two tiles deep, and stored as one
// bulk copy a tile while the next tiles' loads are in flight.  The paper's K (10, 16) are template arguments, so
// the k loop unrolls.
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

constexpr int kResRows = 64;                  // rows per resident block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Start the copy of n bytes from global `src` to shared `dst` (16-byte
// aligned): 16-byte pieces where src is 16-byte aligned, else 4-byte
// pieces where it is 4-byte aligned; the rest by plain loads.
__device__ __forceinline__ void copy_async(unsigned char* dst,
                                           const unsigned char* src, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int piece = (a & 15) == 0 ? 16 : ((a & 3) == 0 ? 4 : 1);
  int done = 0;
  if (piece == 16) {
    done = n & ~15;
    for (int i = 16 * threadIdx.x; i < done; i += 16 * kThreads)
      cp_async16(dst + i, src + i);
  } else if (piece == 4) {
    done = n & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads)
      cp_async4(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
csd_resident_kernel(const int32_t* __restrict__ x,
                    const int8_t* __restrict__ planes,
                    int32_t* __restrict__ out, int M, int K, int N, int D) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int NG = (N + 3) / 4;                 // 4-column groups
  const int NP = 4 * NG;                      // padded weight row
  const int KN = K * N;
  const int dmax = D < 32 ? D : 32;           // planes d >= 32 add 0
  uint32_t* w_s = sm;                         // [K][NP] combined weights
  uint32_t* x_s = w_s + K * NP;               // [kResRows][K] this block's x
  uint32_t* y_s = x_s + kResRows * K;         // [kResRows][N] its y
  int8_t* p_s = reinterpret_cast<int8_t*>(y_s + kResRows * N);  // [dmax][K][N]
  const long long q = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * kResRows;
  const int rows = (M - r0) < kResRows ? (int)(M - r0) : kResRows;
  const int tid = threadIdx.x;

  // x's run of rows * K int32 and the q's planes d < 32, on their way
  const int32_t* xg = x + (q * M + r0) * K;
  copy_async(reinterpret_cast<unsigned char*>(x_s),
             reinterpret_cast<const unsigned char*>(xg), 4 * rows * K);
  copy_async(reinterpret_cast<unsigned char*>(p_s),
             reinterpret_cast<const unsigned char*>(planes + q * (long long)D * KN),
             dmax * KN);
  cp_async_wait_all();
  __syncthreads();

  // the q's weights, sum_d p_d << d, zero in the padded columns
  for (int i = tid; i < K * NP; i += kThreads) {
    const int k = i / NP;
    const int n = i - k * NP;
    uint32_t w = 0u;
    if (n < N) {
#pragma unroll 8
      for (int d = 0; d < dmax; ++d) {
        w += static_cast<uint32_t>(static_cast<int32_t>(p_s[d * KN + k * N + n]))
             << d;
      }
    }
    w_s[i] = w;
  }
  __syncthreads();

  // One row and 4 columns a thread.  Where N is a multiple of 4 a thread's
  // 4 sums are 16 consecutive bytes of y and the block's threads cover its
  // run in order, so they are stored at once; else y is staged in shared
  // memory and stored as one run.
  int32_t* yg = out + (q * M + r0) * N;
  const bool direct = N % 4 == 0 && (reinterpret_cast<uintptr_t>(yg) & 15) == 0;
  for (int it = tid; it < rows * NG; it += kThreads) {
    const int r = it / NG;
    const int c = (it - r * NG) * 4;
    const uint32_t* xr = x_s + r * K;
    uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const uint32_t xv = xr[k];
      const uint4 wv = *reinterpret_cast<const uint4*>(w_s + k * NP + c);
      a0 += xv * wv.x;
      a1 += xv * wv.y;
      a2 += xv * wv.z;
      a3 += xv * wv.w;
    }
    if (direct) {
      *reinterpret_cast<uint4*>(yg + r * N + c) = make_uint4(a0, a1, a2, a3);
      continue;
    }
    uint32_t* yr = y_s + r * N + c;
    yr[0] = a0;
    if (c + 1 < N) yr[1] = a1;
    if (c + 2 < N) yr[2] = a2;
    if (c + 3 < N) yr[3] = a3;
  }
  if (direct) return;
  __syncthreads();

  // y's run of rows * N int32
  const int ny = rows * N;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(yg) & 15) == 0) {
    done = ny & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kThreads)
      *reinterpret_cast<uint4*>(yg + i) = *reinterpret_cast<const uint4*>(y_s + i);
  }
  for (int i = done + tid; i < ny; i += kThreads) {
    yg[i] = static_cast<int32_t>(y_s[i]);
  }
}

// Shared memory of the resident route: weights, x and y tiles, and room
// for 32 planes (a deeper stack adds 0 past plane 31).
size_t resident_smem(int K, int N) {
  return sizeof(uint32_t) * ((size_t)K * 4 * ((N + 3) / 4) +
                             (size_t)kResRows * (K + N)) +
         32 * (size_t)K * N;
}

constexpr int kStreamThreads = 128;
constexpr int kStreamRows = 128;              // one row a thread
constexpr int kStreamStages = 3;              // tiles of x in flight a block
constexpr int kStreamBlocksPerSm = 4;
constexpr int kStreamHeader = 64;             // bytes: the ring's mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Words of one x stage: a tile's run, widened to 16-byte boundaries.
__host__ __device__ __forceinline__ int stream_x_words(int K) {
  return kStreamRows * K + 8;
}

size_t stream_smem(int K, int N) {
  const int NP = 4 * ((N + 3) / 4);
  return kStreamHeader +
         sizeof(uint32_t) * ((size_t)K * NP +
                             (size_t)kStreamStages * stream_x_words(K) +
                             2 * (size_t)kStreamRows * N);
}

// kNG: 4-column groups held in registers (N <= 4 kNG); 0 for any N, one
// group at a time.  kK: K fixed at compile time (the k loop unrolled), 0
// for any K.
template <int kNG, int kK>
__global__ void __launch_bounds__(kStreamThreads)
csd_stream_kernel(const int32_t* __restrict__ x,
                  const int8_t* __restrict__ planes,
                  int32_t* __restrict__ out, int M, int K_, int N, int D) {
  const int K = kK > 0 ? kK : K_;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm_raw);
  const int NG = (N + 3) / 4;
  const int NP = 4 * NG;
  const int xw = stream_x_words(K);
  const int yw = kStreamRows * N;
  uint32_t* w_s = reinterpret_cast<uint32_t*>(sm_raw + kStreamHeader);
  uint32_t* x_s = w_s + K * NP;               // [kStreamStages][xw]
  uint32_t* y_s = x_s + kStreamStages * xw;   // [2][yw]
  const int tid = threadIdx.x;
  const int tiles = (M + kStreamRows - 1) / kStreamRows;
  const int G = gridDim.x;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / G + 1
                       : 0;
  // every tile's run starts at the same offset from a 16-byte boundary
  const int lead = (int)((reinterpret_cast<uintptr_t>(x) & 15) >> 2);

  auto fetch = [&](int j) {                   // the block's j-th tile
    const long long r0 = ((long long)blockIdx.x + (long long)j * G) *
                         kStreamRows;
    const long long rows = M - r0 < kStreamRows ? M - r0 : kStreamRows;
    const uintptr_t a = reinterpret_cast<uintptr_t>(x + r0 * K);
    const uintptr_t a0 = a & ~uintptr_t(15);
    const uintptr_t a1 = (a + 4 * rows * K + 15) & ~uintptr_t(15);
    const uint32_t bytes = (uint32_t)(a1 - a0);
    uint64_t* bar = full + j % kStreamStages;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(x_s + (j % kStreamStages) *
                                                         xw)),
        "l"(a0), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  };

  if (tid == 0) {
    for (int s = 0; s < kStreamStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(full + s)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < kStreamStages && j < mine; ++j) fetch(j);
  }
  // the weights, sum_d p_d << d, zero in the padded columns, while the
  // first tiles are on their way
  const int dmax = D < 32 ? D : 32;           // planes d >= 32 add 0
  const int KN = K * N;
  for (int i = tid; i < K * NP; i += kStreamThreads) {
    const int k = i / NP;
    const int n = i - k * NP;
    uint32_t w = 0u;
    if (n < N) {
      for (int d = 0; d < dmax; ++d) {
        w += static_cast<uint32_t>(static_cast<int32_t>(
                 planes[(long long)d * KN + k * N + n])) << d;
      }
    }
    w_s[i] = w;
  }
  __syncthreads();

  for (int j = 0; j < mine; ++j) {
    const int s = j % kStreamStages;
    const long long r0 = ((long long)blockIdx.x + (long long)j * G) *
                         kStreamRows;
    const int rows = M - r0 < kStreamRows ? (int)(M - r0) : kStreamRows;
    mbar_wait(full + s, (j / kStreamStages) & 1);
    const uint32_t* xr = x_s + s * xw + lead + tid * K;
    uint32_t* yb = y_s + (j & 1) * yw;
    if constexpr (kNG > 0) {
      uint32_t acc[kNG][4] = {};
      // one k of the row: 4 kNG products, the weights a broadcast
      auto add = [&](uint32_t xv, int k) {
        const uint4* wr = reinterpret_cast<const uint4*>(w_s + k * NP);
#pragma unroll
        for (int g = 0; g < kNG; ++g) {
          const uint4 wv = wr[g];
          acc[g][0] += xv * wv.x;
          acc[g][1] += xv * wv.y;
          acc[g][2] += xv * wv.z;
          acc[g][3] += xv * wv.w;
        }
      };
      if (tid < rows) {
        // the row's x in 16-byte pieces where K and the run's offset allow:
        // a warp's rows at a stride of 16 words meet in 4 times fewer
        // banks so (8-byte pieces at K = 10 measured slower than words)
        if (K % 4 == 0 && lead == 0) {
#pragma unroll
          for (int k = 0; k < K; k += 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
            add(v.x, k);
            add(v.y, k + 1);
            add(v.z, k + 2);
            add(v.w, k + 3);
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) add(xr[k], k);
        }
      }
      // the y buffer's last store has read it; every thread is done with
      // stage s, which may then take the tile kStreamStages ahead
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();
      if (tid == 0 && j + kStreamStages < mine) fetch(j + kStreamStages);
      if (tid < rows) {                       // y in 16-byte pieces or words
        uint32_t* yr = yb + tid * N;
#pragma unroll
        for (int g = 0; g < kNG; ++g) {
          if (N % 4 == 0) {
            if (4 * g < N)
              *reinterpret_cast<uint4*>(yr + 4 * g) =
                  make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (4 * g + c < N) yr[4 * g + c] = acc[g][c];
            }
          }
        }
      }
    } else {
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncthreads();                        // the y buffer is free
      if (tid < rows) {
        for (int g = 0; g < NG; ++g) {
          uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
          for (int k = 0; k < K; ++k) {
            const uint32_t xv = xr[k];
            const uint4 wv = *reinterpret_cast<const uint4*>(w_s + k * NP +
                                                             4 * g);
            a0 += xv * wv.x;
            a1 += xv * wv.y;
            a2 += xv * wv.z;
            a3 += xv * wv.w;
          }
          uint32_t* yr = yb + tid * N + 4 * g;
          yr[0] = a0;
          if (4 * g + 1 < N) yr[1] = a1;
          if (4 * g + 2 < N) yr[2] = a2;
          if (4 * g + 3 < N) yr[3] = a3;
        }
      }
      __syncthreads();                        // every thread is done with s
      if (tid == 0 && j + kStreamStages < mine) fetch(j + kStreamStages);
    }
    // y's run of rows * N int32: its whole 16-byte pieces as one bulk
    // copy, the few words past them by the threads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const long long y0 = r0 * N;
    const int ny = rows * N;
    const int nbulk = ny & ~3;
    if (tid == 0) {
      if (nbulk > 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
            ::"l"(out + y0), "r"(smem_u32(yb)), "r"(4 * nbulk)
            : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (tid < ny - nbulk) out[y0 + nbulk + tid] = static_cast<int32_t>(
        yb[nbulk + tid]);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int launch_stream(const void* x, const void* planes, void* out, int M, int K,
                  int N, int D, cudaStream_t s) {
  const size_t smem = stream_smem(K, N);
  const int NG = (N + 3) / 4;
  // the paper's layers (K in {10, 16}, N <= 16) unrolled; any other K
  // loops, any N > 16 takes the column-group loop
  void (*kernel)(const int32_t*, const int8_t*, int32_t*, int, int, int,
                 int) = NG == 1   ? csd_stream_kernel<1, 0>
                        : NG == 2 ? csd_stream_kernel<2, 0>
                        : NG == 3 ? (K == 10   ? csd_stream_kernel<3, 10>
                                     : K == 16 ? csd_stream_kernel<3, 16>
                                               : csd_stream_kernel<3, 0>)
                        : NG == 4 ? (K == 10   ? csd_stream_kernel<4, 10>
                                     : K == 16 ? csd_stream_kernel<4, 16>
                                               : csd_stream_kernel<4, 0>)
                                  : csd_stream_kernel<0, 0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kStreamThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (per_sm > kStreamBlocksPerSm) per_sm = kStreamBlocksPerSm;
  const long long tiles = ((long long)M + kStreamRows - 1) / kStreamRows;
  const long long grid = tiles < (long long)sms * per_sm ? tiles
                                                         : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kStreamThreads, smem, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int8_t*>(planes),
      static_cast<int32_t*>(out), M, K, N, D);
  return static_cast<int>(cudaGetLastError());
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
// contiguous on one device, out on a 16-byte boundary.  route 0: the
// streaming kernel (refused where its shared memory passes the card's);
// route 1: csd_planes_kernel.  Returns cudaGetLastError() after the launch.
extern "C" int csd_matvec(const void* x, const void* planes, void* out,
                          int M, int K, int N, int D, int route,
                          void* stream) {
  if (route != 0 || M <= 0 || N <= 0 || K <= 0 || D <= 0)
    return launch(x, planes, out, 1, M, K, N, D, stream);
  return launch_stream(x, planes, out, M, K, N, D,
                       static_cast<cudaStream_t>(stream));
}

// x: (Q, M, K) int32; planes: (Q, D, K, N) int8, every network's planes
// zero-padded to the shared depth D; out: (Q, M, N) int32.  The "chunked"
// route: csd_planes_kernel.
extern "C" int csd_qsweep(const void* x, const void* planes, void* out,
                          int Q, int M, int K, int N, int D, void* stream) {
  return launch(x, planes, out, Q, M, K, N, D, stream);
}

// The same contract on the "resident" route: csd_resident_kernel, for
// shapes whose weights and tiles fit one block's shared memory (the
// wrapper's route rule; refused past 227 KB).
extern "C" int csd_qsweep_resident(const void* x, const void* planes,
                                   void* out, int Q, int M, int K, int N,
                                   int D, void* stream) {
  if (Q <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || D <= 0) {                     // an empty sum: y = 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(int32_t) * (size_t)Q * M * N, s));
  }
  const size_t smem = resident_smem(K, N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((unsigned)((M + kResRows - 1) / kResRows), Q);
  csd_resident_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int8_t*>(planes),
      static_cast<int32_t*>(out), M, K, N, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csd_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* csd_qsweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* csd_qsweep_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
