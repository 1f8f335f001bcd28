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
// without --use_fast_math: no flush to zero.  Integer sums associate
// exactly modulo 2^32, so every route, tiling and split of K below gives
// the same bits.
//
// Bound: with f32 output, bytes at every qwen2-0.5b width (x, w, e and
// the 4-byte outputs against ~3.35 TB/s), at M = 512 as at M = 8; only a
// K = 151936 product at prefill-sized M is bound by its operations (two
// int8 operations per multiply-add against ~1979 TOP/s).  At M = 8 the
// bytes are w's; at M = 512 mostly the output's.
//
// Two routes; the wrapper (qmatmul.py::route) picks one by a plain rule.
//
// TMA route (qmatmul_tma_kernel), taken when K > 0, K and N are multiples
// of 16 and x and w start 16-byte aligned (a tensor map's rule): every
// qwen2-0.5b width.  wgmma takes 8-bit operands K-major only (the
// transpose bits exist for 16-bit types alone), and w (K, N) is N-major.
// So the block computes its output tile transposed, y^T = w^T x^T:
//   A = 128 channels of w^T, two 64-row slabs, from registers.  Each
//     consumer thread owns 4 consecutive channels (32 warp + 4 g .. +3 for
//     lane g = lane / 4, t = lane % 4) and builds its A fragments from w's
//     N-major tile with 32-bit shared loads of 4 k-rows x 4 channels and a
//     4 x 4 byte transpose by prmt.  Slab s's fragment row g (g + 8) is
//     channel 4 g + 2 s (+ 1): a permutation of A's rows that the epilogue
//     undoes for free, since it gives each thread 4 consecutive channels.
//     Threads t and t ^ 2 read their 4 k-rows in XOR'd order, so with the
//     128-byte swizzle a warp's loads hit 32 distinct banks.
//   B = x's (BM rows, 128 k) tile, K-major as it lies, 128-byte swizzled:
//     wgmma's N is the M tile, 8 at decode up to 64 at prefill, so M = 8
//     is not padded to 64.
// One block: one consumer warpgroup (128 x BM int32 accumulators, BM / 2
// registers a thread per slab) and one producer warp whose lane 0 keeps a
// ring of 4 (BM <= 16) or 3 stages of TMA loads in flight on full / empty
// mbarriers: a stage is w's (128 k, 128 channels) tile, 16 KiB, and x's
// (BM, 128 k) tile, 1-8 KiB; 61-73 KiB a block, three blocks an SM within
// 128 registers a thread.  BM is 8 to 64; the wrapper takes 32 where 64
// leaves fewer output tiles than SMs.  A stage is 4 k32 steps: the
// consumer builds all 32 A registers of the stage, then issues its 8
// wgmma.m64nBMk32.s32.s8.s8 and waits once.  (Building the next step's
// fragments while the last step's products run makes ptxas serialize
// every wgmma, C7513, and ran slower; the other blocks of the SM fill the
// tensor cores while one builds.)  Where the output tiles are fewer than
// the SMs and K has enough 128-byte k-tiles, K is split across blocks
// (grid.z, from qmatmul.py::tiling, a pure function of M, K, N; BM = 64
// is never split): each split stores its int32 partial tile into its own
// slice of a workspace, fences and bumps the tile's counter; the last one
// to arrive adds the other slices to its registers (wrapping), 8 loads of
// 16 bytes in flight, and finishes.  The epilogue is fused and coalesced
// without shared memory: each thread holds 4 consecutive channels of
// each of its rows, so it scales them and writes 16 bytes (f32) or 8
// (bf16) at once; a warp's store covers 4 rows x 128 (64) contiguous
// bytes.  Past M, N and K the tensor maps fill zeros and the epilogue
// masks the stores.
//
// mma route (qmatmul_mma_kernel), everything else (a row pitch or a base
// address a tensor map cannot describe, K = 0): the first version, kept.
// mma.sync.m16n8k32.s32.s8.s8.s32, a block of 128 threads owns a 64 x 64
// output tile and walks K in steps of 64: it stages the (64 m, 64 k) tile
// of x and the (64 k, 64 n) tile of w in shared memory, the latter
// transposed to (n, k) in registers (four rows of 8 n-bytes into 8 words
// of 4 k-bytes), rows 80 bytes apart so a warp's fragment reads hit 32
// distinct banks; the next K step's tiles are loaded into registers while
// the tensor cores work on the current one; each warp computes a 32 x 32
// quarter as 2 x 4 mma tiles; zero-filled past M, N and K; 8-byte loads
// where K (for x) and N (for w) are multiples of 8 and aligned, byte loads
// elsewhere.

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// exp2_int(-e): the exponent bits of 2^-e, -e clamped to [-126, 127]; -e
// wraps like torch's int32 negation
__device__ __forceinline__ float pot_scale(int32_t e) {
  int ne = static_cast<int>(0u - static_cast<uint32_t>(e));
  ne = ne < -126 ? -126 : (ne > 127 ? 127 : ne);
  return __int_as_float((ne + 127) << 23);
}

// ------------------------------------------------------------- mma route

namespace mma {


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

template <bool kVecX, bool kVecW, typename OutT>
__global__ void __launch_bounds__(kThreads)
qmatmul_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
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
      const float scale = pot_scale(e[n]);
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
cudaError_t launch(const void* x, const void* w, const void* e, void* y, int M,
           int N, int K, void* stream) {
  const bool vx = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const bool vw = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto ep = static_cast<const int32_t*>(e);
  auto yp = static_cast<OutT*>(y);
  if (vx && vw) {
    qmatmul_mma_kernel<true, true><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                         N, K);
  } else if (vx) {
    qmatmul_mma_kernel<true, false><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                          N, K);
  } else if (vw) {
    qmatmul_mma_kernel<false, true><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp, M,
                                                          N, K);
  } else {
    qmatmul_mma_kernel<false, false><<<grid, kThreads, 0, s>>>(xp, wp, ep, yp,
                                                           M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace mma

// ------------------------------------------------------------- TMA route

namespace tma {

constexpr int kCh = 128;          // output channels a block (wgmma's M:
                                  // two 64-row slabs)
constexpr int kBK = 128;          // K bytes a ring stage: one 128-byte
                                  // swizzled row of x's tile
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp

template <int BM>
struct Cfg {
  static constexpr int STAGES = BM >= 32 ? 3 : 4;
  static constexpr int W_BYTES = kBK * kCh;   // w's (128 k, 128 n) tile
  static constexpr int X_BYTES = BM * kBK;    // x's (BM m, 128 k) tile
  static constexpr int STAGE = W_BYTES + X_BYTES;   // a multiple of 1024
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES + 16;
};

// blocks an SM asked of ptxas: 3, so at most 128 registers a thread (five
// warps a block, four of the fifteen on some scheduler)
constexpr int kMinBlocks = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
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

// TMA: the box of a 2-D tensor map at coordinates (c0 inner, c1 outer)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(int32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 8) += A B: A s8 fragments in registers, B s8 K-major in
// shared memory
__device__ __forceinline__ void wgmma_n8(int32_t* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 16) += A B: A s8 fragments in registers, B s8 K-major in
// shared memory
__device__ __forceinline__ void wgmma_n16(int32_t* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32) += A B: A s8 fragments in registers, B s8 K-major in
// shared memory
__device__ __forceinline__ void wgmma_n32(int32_t* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64) += A B: A s8 fragments in registers, B s8 K-major in
// shared memory
__device__ __forceinline__ void wgmma_n64(int32_t* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BM>
__device__ __forceinline__ void wgmma(int32_t* d, const uint32_t* a,
                                      uint64_t b) {
  if constexpr (BM == 8)
    wgmma_n8(d, a, b);
  else if constexpr (BM == 16)
    wgmma_n16(d, a, b);
  else if constexpr (BM == 32)
    wgmma_n32(d, a, b);
  else
    wgmma_n64(d, a, b);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// grid (M tiles, channel tiles, splits of K): the M tiles of one channel
// tile run side by side and share its w tile through L2.  Split z walks
// k-tiles [z kt_per, min(n_k, (z + 1) kt_per)).  With splits (kSplit),
// ws holds one (M, N) int32 slice per split and counts one zeroed int per
// output tile.
template <int BM, bool kSplit, typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
qmatmul_tma_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const int32_t* __restrict__ e, OutT* __restrict__ y,
                   int32_t* __restrict__ ws, int32_t* __restrict__ counts,
                   int M, int N, int n_k, int kt_per) {
  using C = Cfg<BM>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the stages to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::STAGE);
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kCh;
  const int split = gridDim.z;
  const int kt0 = blockIdx.z * kt_per;
  const int nkt = min(n_k, kt0 + kt_per) - kt0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                 // the producer warp
    if (tid == kConsumers) {
      for (int u = 0; u < nkt; ++u) {
        const int s = u % S;
        if (u >= S) mbar_wait(&empty[s], (u / S - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        const int k = (kt0 + u) * kBK;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load(st, &tw, &full[s], n0, k);
        tma_load(st + C::W_BYTES, &tx, &full[s], k, m0);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the thread's k-rows 4 t + j of a 16-row half, read in the order
  // j ^ sw, and its channels' 16-byte chunk 2 warp + g / 4 of a 128-byte
  // row, which the swizzle XORs with the row's index mod 8
  const int sw = t & 2;
  const uint32_t sel_lo = sw ? 0x1054u : 0x5410u;
  const uint32_t sel_hi = sw ? 0x3276u : 0x7632u;
  uint32_t off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * t + (j ^ sw);
    off[j] = r * 128 + (((2 * warp + (g >> 2)) ^ (r & 7)) << 4) + 4 * (g & 3);
  }

  int32_t acc[2][BM / 2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[s][i] = 0;

  for (int u = 0; u < nkt; ++u) {
    const int s = u % S;
    mbar_wait(&full[s], (u / S) & 1);
    const uint8_t* w_s = smem + s * C::STAGE;
    const uint32_t x_addr = smem_u32(w_s + C::W_BYTES);
    // every A fragment of the stage first: ptxas serializes wgmma whose
    // input registers are written while another wgmma is in flight
    uint32_t a[kBK / 32][2][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      // R[q][c]: 4 k-bytes (k-rows 32 kk + 16 q + 4 t .. + 3) of channel c
      uint32_t R[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint8_t* base = w_s + (32 * kk + 16 * q) * 128;
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = *reinterpret_cast<const uint32_t*>(base + off[j]);
        // rows 4 t + (j ^ sw) -> a 4 x 4 byte transpose; with sw = 2 the
        // pairs (p0, p1) and (p2, p3) come swapped, which sel_* undo
        const uint32_t u0 = __byte_perm(p[0], p[1], 0x5140);
        const uint32_t u1 = __byte_perm(p[0], p[1], 0x7362);
        const uint32_t u2 = __byte_perm(p[2], p[3], 0x5140);
        const uint32_t u3 = __byte_perm(p[2], p[3], 0x7362);
        R[q][0] = __byte_perm(u0, u2, sel_lo);
        R[q][1] = __byte_perm(u0, u2, sel_hi);
        R[q][2] = __byte_perm(u1, u3, sel_lo);
        R[q][3] = __byte_perm(u1, u3, sel_hi);
      }
      // slab s: rows g, g + 8 are channels 4 g + 2 s, + 1; registers
      // (row g, k 4t..), (row g + 8, k 4t..), (row g, k 16+4t..),
      // (row g + 8, k 16+4t..)
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        a[kk][sl][0] = R[0][2 * sl];
        a[kk][sl][1] = R[0][2 * sl + 1];
        a[kk][sl][2] = R[1][2 * sl];
        a[kk][sl][3] = R[1][2 * sl + 1];
      }
    }
    pin<BM / 2>(acc[0]);
    pin<BM / 2>(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const uint64_t b = desc_sw128(x_addr + 32 * kk);
      wgmma<BM>(acc[0], a[kk][0], b);
      wgmma<BM>(acc[1], a[kk][1], b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<BM / 2>(acc[0]);
    pin<BM / 2>(acc[1]);
    mbar_arrive(&empty[s]);                // the stage is read
  }

  // acc[s][i]: channel 4 g + 2 s + ((i >> 1) & 1) of the warp's 32, row
  // 8 (i >> 2) + 2 t + (i & 1) of the tile; the thread's 4 channels of a
  // row are acc[0][i], acc[0][i + 2], acc[1][i], acc[1][i + 2], i = 4 j + c
  const int nb = n0 + 32 * warp + 4 * g;
  const bool n_ok = nb < N;               // N % 16 == 0: all 4 or none
  if constexpr (kSplit) {
    int32_t* mine = ws + (long long)blockIdx.z * M * N;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = m0 + 8 * j + 2 * t + c, i = 4 * j + c;
        if (m < M && n_ok)
          *reinterpret_cast<int4*>(mine + (long long)m * N + nb) =
              make_int4(acc[0][i], acc[0][i + 2], acc[1][i], acc[1][i + 2]);
      }
    __threadfence();
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (tid == 0)
      *last = atomicAdd(&counts[blockIdx.y * gridDim.x + blockIdx.x], 1) ==
              split - 1;
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (!*last) return;
    __threadfence();
    // the other slices, 8 loads of 16 bytes in flight a round: ZB slices
    // x QB of the thread's E (row, 4 channels) entries
    constexpr int E = BM / 4, L = 8;
    constexpr int ZB = E < L ? L / E : 1, QB = E < L ? E : L;
    for (int z0 = 0; z0 < split; z0 += ZB) {
#pragma unroll
      for (int q0 = 0; q0 < E; q0 += QB) {
        int4 v[ZB][QB];
#pragma unroll
        for (int b = 0; b < ZB; ++b)
#pragma unroll
          for (int r = 0; r < QB; ++r) {
            const int z = z0 + b, q = q0 + r;
            const int m = m0 + 8 * (q >> 1) + 2 * t + (q & 1);
            v[b][r] = make_int4(0, 0, 0, 0);
            if (z < split && z != (int)blockIdx.z && m < M && n_ok)
              v[b][r] = __ldcg(reinterpret_cast<const int4*>(
                  ws + ((long long)z * M + m) * N + nb));
          }
#pragma unroll
        for (int b = 0; b < ZB; ++b)
#pragma unroll
          for (int r = 0; r < QB; ++r) {
            // wrapping adds: the int32 sum modulo 2^32
            const int q = q0 + r, i = 4 * (q >> 1) + (q & 1);
            acc[0][i] = (int32_t)((uint32_t)acc[0][i] + (uint32_t)v[b][r].x);
            acc[0][i + 2] =
                (int32_t)((uint32_t)acc[0][i + 2] + (uint32_t)v[b][r].y);
            acc[1][i] = (int32_t)((uint32_t)acc[1][i] + (uint32_t)v[b][r].z);
            acc[1][i + 2] =
                (int32_t)((uint32_t)acc[1][i + 2] + (uint32_t)v[b][r].w);
          }
      }
    }
  }
  if (!n_ok) return;
  float scale[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) scale[q] = pot_scale(e[nb + q]);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * t + c, i = 4 * j + c;
      if (m < M) {
        const float v[4] = {
            __fmul_rn(__int2float_rn(acc[0][i]), scale[0]),
            __fmul_rn(__int2float_rn(acc[0][i + 2]), scale[1]),
            __fmul_rn(__int2float_rn(acc[1][i]), scale[2]),
            __fmul_rn(__int2float_rn(acc[1][i + 2]), scale[3])};
        store4(y + (long long)m * N + nb, v);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// cuTensorMapEncodeTiled needs a current context.  Autograd runs a
// backward on a thread of its own, where this may be the first CUDA call:
// cudaSetDevice makes the device's primary context current there.
cudaError_t make_current() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaSetDevice(dev) : e;
}

// the map of a row-major int8 (rows, cols) matrix in boxes of (box_rows,
// 128 bytes of a row), 128-byte swizzled; out-of-bounds reads are zeros
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
                int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, bool kSplit, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* e, void* y,
                   void* ws, void* counts, int M, int N, int K, int split,
                   int kt_per, cudaStream_t stream) {
  using C = Cfg<BM>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap tx, tw;
  if (!tensor_map(enc, &tx, x, M, K, BM) ||
      !tensor_map(enc, &tw, w, K, N, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qmatmul_tma_kernel<BM, kSplit, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_k = (K + kBK - 1) / kBK;
  const dim3 grid((M + BM - 1) / BM, (N + kCh - 1) / kCh, split);
  qmatmul_tma_kernel<BM, kSplit, OutT><<<grid, kThreads, C::SMEM, stream>>>(
      tx, tw, static_cast<const int32_t*>(e), static_cast<OutT*>(y),
      static_cast<int32_t*>(ws), static_cast<int32_t*>(counts), M, N, n_k,
      kt_per);
  return cudaGetLastError();
}

// BM = 64 is never split (the wrapper takes it only where the output
// tiles fill the card), and its reduction would not fit 128 registers
template <int BM, typename OutT>
cudaError_t launch_split(const void* x, const void* w, const void* e,
                         void* y, void* ws, void* counts, int M, int N, int K,
                         int split, int kt_per, cudaStream_t s) {
  if constexpr (BM == 64) {
    if (split > 1) return cudaErrorInvalidValue;
    return launch<BM, false, OutT>(x, w, e, y, ws, counts, M, N, K, split,
                                   kt_per, s);
  } else {
    return split > 1 ? launch<BM, true, OutT>(x, w, e, y, ws, counts, M, N,
                                              K, split, kt_per, s)
                     : launch<BM, false, OutT>(x, w, e, y, ws, counts, M, N,
                                               K, split, kt_per, s);
  }
}

template <typename OutT>
cudaError_t dispatch(int bm, const void* x, const void* w, const void* e,
                     void* y, void* ws, void* counts, int M, int N, int K,
                     int split, int kt_per, cudaStream_t s) {
  switch (bm) {
    case 8:
      return launch_split<8, OutT>(x, w, e, y, ws, counts, M, N, K, split,
                                   kt_per, s);
    case 16:
      return launch_split<16, OutT>(x, w, e, y, ws, counts, M, N, K, split,
                                    kt_per, s);
    case 32:
      return launch_split<32, OutT>(x, w, e, y, ws, counts, M, N, K, split,
                                    kt_per, s);
    case 64:
      return launch_split<64, OutT>(x, w, e, y, ws, counts, M, N, K, split,
                                    kt_per, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tma

}  // namespace

// The mma route.  x: (M, K) int8; w: (K, N) int8; e: (N,) int32; y: (M,
// N), float32 when bf16 is 0, bfloat16 otherwise; all contiguous on one
// device.  Returns cudaGetLastError() after the launch.
extern "C" int qmatmul(const void* x, const void* w, const void* e, void* y,
                       int M, int N, int K, int bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? mma::launch<__nv_bfloat16>(x, w, e, y, M, N, K, s)
           : mma::launch<float>(x, w, e, y, M, N, K, s));
}

// The TMA route: as qmatmul, with K > 0, K % 16 == N % 16 == 0 and x, w
// 16-byte aligned; bm in {8, 16, 32, 64, 128} the M tile; K cut into
// `split` parts of kt_per 128-byte k-tiles (split * kt_per covers K, no
// part empty).  With split > 1, ws holds split (M, N) int32 slices and
// counts ceil(M / bm) * ceil(N / 128) ints, zeroed.
extern "C" int qmatmul_tma(const void* x, const void* w, const void* e,
                           void* y, void* ws, void* counts, int M, int N,
                           int K, int bf16, int bm, int split, int kt_per,
                           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int n_k = (K + tma::kBK - 1) / tma::kBK;
  if (K <= 0 || K % 16 || N % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || split < 1 || kt_per < 1 ||
      (split - 1) * kt_per >= n_k || split * kt_per < n_k ||
      (split > 1 && (ws == nullptr || counts == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? tma::dispatch<__nv_bfloat16>(bm, x, w, e, y, ws, counts, M, N, K,
                                          split, kt_per, s)
           : tma::dispatch<float>(bm, x, w, e, y, ws, counts, M, N, K, split,
                                  kt_per, s));
}

// dynamic shared memory of a TMA-route block with M tile bm, 0 for another
extern "C" int qmatmul_tma_smem(int bm) {
  switch (bm) {
    case 8:
      return tma::Cfg<8>::SMEM;
    case 16:
      return tma::Cfg<16>::SMEM;
    case 32:
      return tma::Cfg<32>::SMEM;
    case 64:
      return tma::Cfg<64>::SMEM;
    default:
      return 0;
  }
}

extern "C" const char* qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
