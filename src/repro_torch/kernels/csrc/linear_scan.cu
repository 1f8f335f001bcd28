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
// bit.  Every route below walks each (b, w) channel in order of t from
// h = 0 with that step, in one thread, so the f32 operations are exactly
// the plain version's, bit for bit, on every route.
//
// Bound: bytes.  Each step reads 8 bytes and writes 4 and does two flops.
// The work is sequential in t, so parallelism comes only from the B * W
// channels: at B = 1, W = 4096 that is 128 warps, about one per SM.  The
// dependent chain (a multiply and an add, ~8 cycles a step) is far below
// the bytes bound; what limits a walk is how many bytes are in flight
// while it waits on memory.
//
// Three routes; the wrapper (linear_scan.py::route) picks one by a plain
// rule of S, W and alignment and passes its id:
//
// ring (id 0), for S above the step route's threshold where W % 4 == 0
//   and a, x, h start 16-byte aligned (a TMA tensor map's rule: a 16-byte
//   aligned base and row pitch).  One block per (32 channels, batch row),
//   two warps.  The producer warp's lane 0 keeps a ring of kRingStages
//   stages in flight, each a (32 channels, kRingBT steps) TMA box of a and
//   one of x from 3-D tensor maps over (W, S, B) -- the box's part past S
//   or W lands as zeros -- completed on the stage's full mbarrier; it
//   refills a stage when the consumer has released it on the stage's
//   empty mbarrier.  The consumer warp walks the stage, one channel a
//   lane, h in a register, writes each h into a shared (kRingBT, 32) tile
//   and stores the tile as one TMA box (the part past S or W is not
//   written), two tiles deep.  No block-wide barrier after the set-up.
//   4 stages of 64 steps and two h tiles are 80 KiB: two blocks an SM.
//   (Measured against it, experiments/linear_scan_variants.py: stages of
//   128 steps, 2, 3 or 6 stages, 16 channels a block, and h stored from
//   registers a row a step, which a single warp's stores hold to a third
//   of the speed.)
// step (id 1), for S at or below the threshold (decode's S = 1) where the
//   ring's alignment rule holds: no shared memory, no barrier; each thread
//   walks 4 channels' S steps straight from device memory with 16-byte
//   loads and stores, from h = 0 (not h = x: the product a * 0 keeps the
//   plain version's sign of zero and its NaN), loading kChunk steps
//   ahead.  The grid covers B * W.
// tiled (id 2), the first version of this kernel, for every other shape
//   (W % 4 != 0, or an input that starts off a 16-byte boundary): one
//   block per (32 channels, batch row), 256 threads copy (64 steps x 32
//   channels) tiles of a and x into shared memory with 4-byte cp.async,
//   two stages deep, and warp 0 walks them.  Ragged edges (S % 64,
//   W % 32) are zero-filled copies and masked stores.

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// ---------------------------------------------------------------- tiled

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
        h = step(a_s[stage][r][tid], h, x_s[stage][r][tid]);
        if (col_ok) dst[(long long)r * W] = h;
      }
    }
    __syncthreads();               // the stage is free to refill
  }
}

// ----------------------------------------------------------------- ring

constexpr int kRingBW = 32;       // channels a block: one consumer lane each
constexpr int kRingBT = 64;       // steps a stage
constexpr int kRingStages = 4;    // depth of the ring
constexpr int kRingChunk = 16;    // steps whose shared loads go together
constexpr bool kStagedStore = true;   // h through shared memory, a tile as
                                      // one TMA store (false: from
                                      // registers, a row a step)

constexpr int kTile = kRingBT * kRingBW * 4;         // one tensor's stage
constexpr int kOut = kStagedStore ? 2 * kTile : 0;   // two h tiles
constexpr int kRingSmem = kRingStages * 2 * kTile + kOut +
                          2 * kRingStages * 8;       // + the mbarriers

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

// a (kRingBW, kRingBT, 1) box of a (W, S, B) tensor map at (w, t, b),
// completed on `bar`; the box's part past W or S lands as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int w, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(w),
      "r"(t), "r"(b)
      : "memory");
}

// the (kRingBW, kRingBT, 1) box at `src` into a (W, S, B) tensor map at
// (w, t, b), in this thread's bulk group; the box's part past W or S is
// not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int w, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(w), "r"(t), "r"(b)
      : "memory");
}

__global__ void __launch_bounds__(64)
linear_scan_ring_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap th,
                        float* __restrict__ h_out, int S, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);          // [stage][BT][BW]
  float* x_s = a_s + kRingStages * kRingBT * kRingBW;   // [stage][BT][BW]
  float* o_s = x_s + kRingStages * kRingBT * kRingBW;   // [2][BT][BW]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kRingStages * 2 * kTile + kOut);
  uint64_t* empty = full + kRingStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kRingBW;
  const int n_tiles = (S + kRingBT - 1) / kRingBT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {                                      // the producer
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kRingStages;
        if (k >= kRingStages) mbar_wait(&empty[s], (k / kRingStages - 1) & 1);
        const int o = s * kRingBT * kRingBW;
        mbar_expect_tx(&full[s], 2 * kTile);
        tma_load(a_s + o, &ta, &full[s], w0, k * kRingBT, blockIdx.y);
        tma_load(x_s + o, &tx, &full[s], w0, k * kRingBT, blockIdx.y);
      }
    }
    return;
  }

  // the consumer: lane `lane` walks channel w0 + lane, kRingChunk steps at
  // a time.  A chunk's shared loads all precede its stores in the source,
  // so they are in flight together (the compiler may not move a load past
  // a store it cannot prove apart).
  const bool mine = lane < min(kRingBW, W - w0);
  float h = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kRingStages;
    const int t0 = k * kRingBT;
    const int steps = min(kRingBT, S - t0);
    const float* as = a_s + s * kRingBT * kRingBW + lane;
    const float* xs = x_s + s * kRingBT * kRingBW + lane;
    float* os = o_s + (k & 1) * kRingBT * kRingBW;
    float* dst = h_out + ((long long)blockIdx.y * S + t0) * W + w0 + lane;
    if constexpr (kStagedStore) {
      if (lane == 0)          // the store of tile k - 2 has read its h tile
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
    }
    mbar_wait(&full[s], (k / kRingStages) & 1);
    for (int r0 = 0; r0 < steps; r0 += kRingChunk) {
      float ar[kRingChunk], xr[kRingChunk];
#pragma unroll
      for (int j = 0; j < kRingChunk; ++j) {  // rows past `steps` lie in the
        ar[j] = as[(r0 + j) * kRingBW];       // stage too: read, not used
        xr[j] = xs[(r0 + j) * kRingBW];
      }
#pragma unroll
      for (int j = 0; j < kRingChunk; ++j) {
        if (r0 + j < steps) {
          h = step(ar[j], h, xr[j]);
          if constexpr (kStagedStore) {
            if (lane < kRingBW) os[(r0 + j) * kRingBW + lane] = h;
          } else if (mine) {
            dst[(long long)(r0 + j) * W] = h;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);              // the stage is free
    if constexpr (kStagedStore) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();           // every lane's h is visible to the TMA store
      if (lane == 0) {
        tma_store(&th, os, w0, t0, blockIdx.y);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  if constexpr (kStagedStore) {
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// ----------------------------------------------------------------- step

constexpr int kStepThreads = 128;
constexpr int kChunk = 8;          // steps whose loads are issued together

// 4 channels a thread, read and written as one 16-byte vector.  A chunk's
// loads all precede its stores in the source, so they are in flight
// together (the compiler may not move a load past a store it cannot prove
// apart).
__global__ void __launch_bounds__(kStepThreads)
linear_scan_step_kernel(const float4* __restrict__ a,
                        const float4* __restrict__ x,
                        float4* __restrict__ h_out, int S, int W4,
                        long long n) {
  const long long i = (long long)blockIdx.x * kStepThreads + threadIdx.x;
  if (i >= n) return;
  const long long off = i / W4 * S * W4 + i % W4;   // in vectors
  float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    float4 at[kChunk], xt[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (t0 + j < S) {
        at[j] = a[off + (long long)(t0 + j) * W4];
        xt[j] = x[off + (long long)(t0 + j) * W4];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (t0 + j < S) {
        h.x = step(at[j].x, h.x, xt[j].x);
        h.y = step(at[j].y, h.y, xt[j].y);
        h.z = step(at[j].z, h.z, xt[j].z);
        h.w = step(at[j].w, h.w, xt[j].w);
        h_out[off + (long long)(t0 + j) * W4] = h;
      }
    }
  }
}

cudaError_t launch_step(const float* a, const float* x, float* h, int B,
                        int S, int W, cudaStream_t stream) {
  const long long n = (long long)B * W / 4;
  const long long blocks = (n + kStepThreads - 1) / kStepThreads;
  linear_scan_step_kernel<<<(unsigned)blocks, kStepThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(x),
      reinterpret_cast<float4*>(h), S, W / 4, n);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (the
// library does not link libcuda)
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

// the map of a contiguous (B, S, W) float32 tensor as (W, S, B) in boxes
// of (kRingBW, kRingBT, 1): reads past W or S are zeros, writes there are
// dropped
bool scan_map(EncodeTiled enc, CUtensorMap* map, const void* p, int B, int S,
              int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {kRingBW, kRingBT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_ring(const float* a, const float* x, float* h, int B,
                        int S, int W, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap ta, tx, th;
  if (!scan_map(enc, &ta, a, B, S, W) || !scan_map(enc, &tx, x, B, S, W) ||
      !scan_map(enc, &th, h, B, S, W))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      linear_scan_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kRingBW - 1) / kRingBW, B);
  linear_scan_ring_kernel<<<grid, 64, kRingSmem, stream>>>(ta, tx, th, h, S,
                                                           W);
  return cudaGetLastError();
}

}  // namespace

// a, x, h: (B, S, W) float32, contiguous, on one device; `route` is the id
// of linear_scan.py::ROUTES (ring 0, step 1, tiled 2), whose
// conditions the wrapper has checked.  Returns cudaGetLastError() after
// the launch.
extern "C" int linear_scan(const void* a_, const void* x_, void* h_, int B,
                           int S, int W, int route, void* stream_) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const float* a = static_cast<const float*>(a_);
  const float* x = static_cast<const float*>(x_);
  float* h = static_cast<float*>(h_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (route) {
    case 0:
      return launch_ring(a, x, h, B, S, W, stream);
    case 1:
      return launch_step(a, x, h, B, S, W, stream);
    case 2: {
      const dim3 grid((W + kBW - 1) / kBW, B);
      linear_scan_kernel<<<grid, kThreads, 0, stream>>>(a, x, h, S, W);
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
