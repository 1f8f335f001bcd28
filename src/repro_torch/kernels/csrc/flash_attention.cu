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
// The arithmetic contract (both routes): scores q.k in f32 times
// 1/sqrt(D); masked scores exactly -1e30 (never -inf) and the running max m
// starting at -1e30; p = exp(s - m_new) and corr = exp(m - m_new) in f32,
// l = l * corr + sum(p), acc = acc * corr + round(p) V with p rounded to
// V's type; the output acc / max(l, 1e-20).  A key a row does not see, met
// before the row's first visible key, adds exp(0) = 1 to l and v to acc;
// the first visible key makes corr = exp(-1e30 - m) exactly 0, which wipes
// them.  So a tile that lies wholly outside every row's visible range
// changes nothing and is skipped.  A row that sees no key at all keeps
// what the masked keys it walked add up to: the mean of v over them.  Such
// a row walks every key j < kv_pad, the kv length padded to the caller's
// tile (the padding reads as zeros), as the reference's chunked scan does.
// Rows with a visible key do not depend on kv_pad.  A block walks only the
// keys some row of it needs: from the first visible key of its first row to
// the last of its last row (the causal frontier and the window), or from 0
// to kv_pad when a row sees none.
//
// Bound: operations at the main path's shapes, 4 * D flops per visible
// (query, key) pair against 2 * D * 2 bytes per key.  The C entry point
// picks the route by dtype:
//
// bfloat16 -- tensor cores (flash_attention_wgmma_kernel).  One block per (128
// query rows, query head, batch row): two consumer warpgroups of 64 rows each,
// sharing K/V; two blocks an SM at D <= 64 (ptxas: 119 registers), one at D =
// 256 (209 registers).  Thread 0 is also the producer: Q is loaded once by TMA,
// K and V tiles of kKT = 64 keys arrive by TMA into a ring of kStages = 2
// stages completed on mbarriers, so the next tile's copy is in flight while the
// current one is computed; a stage is refilled once every consumer thread has
// arrived on its "empty" barrier.  (B, S, H, D) is a 4-D tensor map (no copy to
// another layout); its rows land in shared memory in slabs of 64 dims (fewer
// when D < 64) with the 128-byte (64-, 32-byte) swizzle that wgmma descriptors
// read.  Per tile and warpgroup: S = Q K^T by wgmma m64n64k16 with both
// operands in shared memory (K-major); S times scale * log2(e); the mask only
// on tiles that straddle a boundary (causal diagonal, window edge, kv_len,
// kv_pad), interior tiles skip it; the online softmax in registers (row max
// across the 4 threads of a row by shuffles, l kept per thread and summed at
// the end) with p = 2^(s - m_new) by ex2.approx -- scores pre-multiplied by
// log2(e), so masked scores and the running max are -1e30 in that domain and
// the contract's exp(0) = 1 and exact-0 wipe hold unchanged; p is rounded to
// bf16 straight into the A fragments of O += P V, a register-A wgmma against V
// in shared memory (MN-major, one m64nNk16 per slab, N = min(D, 64)), with the
// f32 accumulator in registers across the whole walk.  A warpgroup skips tiles
// outside its own rows' range (it still waits and arrives, to keep the ring in
// step).  Epilogue: acc / max(l, 1e-20) to bf16 in the swizzled Q buffer, then
// a TMA store (rows past Sq are clipped).  The G query heads of one KV head run
// in neighbouring blocks and share K/V through L2: packing them into a
// warpgroup's rows was tried (experiments/flash_variants.py) and moved the time
// by +4 % at the D = 64 loss shape and 0 to -6 % at D = 256, not worth its
// code.  Query tiles are scheduled last-first, so the longest causal walks
// start first.  At D = 256 the accumulator is 128 registers a thread; Q stays
// in shared memory and ptxas reports no spills.  What holds it back (PERF.md):
// each warpgroup runs its two products and the softmax between them in turn, so
// at D = 64 the tensor cores and the ex2 unit wait on each other's latency
// (skipping the K/V copies saves only 2-4 %); overlapping the next tile's Q K^T
// with this tile's softmax inside a warpgroup is the next step.
//
// Both routes write the rows' log-sum-exp, lse = m + ln l in natural-log
// units (B, Hq, Sq) f32, when given a non-null `lse` (the backward kernels of
// flash_attention_bwd.cu read it); the bf16 route keeps m in log2 units and
// converts.  A launch given a null `lse` writes nothing more.
//
// float32 -- CUDA cores (flash_attention_kernel), the first version, kept
// for the checks that hold f32 results tightly (TF32 would break them):
// one block per (64 query rows, query head, batch row), each row held by
// D / 32 threads (D / 16 for D = 16) owning 32 of its dims of q and of the
// f32 accumulator; K and V tiles of 32 keys staged in shared memory as
// f32, rows padded so the threads of one row read different banks; per
// tile 32 scores per row (a shuffle sum across the row's threads), the
// tile max, one rescale, then p V.

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- float32

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per shared-memory tile

// Load one 16-byte vector of 4 floats from `src` into `dst`.
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
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

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int Sq,
                       int Skv, int Hq, int Hkv, int kv_len, int offset,
                       int causal, int window, int kv_pad, float scale) {
  using S = Shape<D>;
  constexpr int DPT = S::DPT, TPR = S::TPR, PART = S::PART, ROW = S::ROW;
  constexpr int VEC = 4;
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
    const float* src = q + (((long long)b * Sq + (live ? r : 0)) * Hq + h) * D +
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
      s[j] = p;                                 // f32: p.astype(v.dtype) is p
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
  if (lse != nullptr && part == 0)
    lse[((long long)b * Hq + h) * Sq + r] = m + logf(l);
  const float denom = fmaxf(l, 1e-20f);
  float* dst = out + (((long long)b * Sq + r) * Hq + h) * D + part * DPT;
#pragma unroll
  for (int d = 0; d < DPT; d += VEC) {
    alignas(16) float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = acc[d + e] / denom;
    *reinterpret_cast<float4*>(dst + d) = *reinterpret_cast<const float4*>(o);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   int kv_len, int offset, int causal, int window, int kv_pad,
                   float scale, cudaStream_t stream) {
  using S = Shape<D>;
  const size_t smem = sizeof(float) * 2 * kBK * S::ROW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<D><<<grid, S::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
      Hq, Hkv, kv_len, offset, causal, window, kv_pad, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, float* lse, int B, int Sq, int Skv, int Hq,
                     int Hkv, int kv_len, int offset, int causal, int window,
                     int kv_pad, float scale, cudaStream_t s) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<DD>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, kv_len,       \
                      offset, causal, window, kv_pad, scale, s);
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

// --------------------------------------------------------------- bfloat16

constexpr int kWG = 2;               // consumer warpgroups per block
constexpr int kRows = 64 * kWG;      // query rows per block
constexpr int kStages = 2;           // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kKT = 64;              // keys per online-softmax step

template <int D>
struct Tile {
  static constexpr int KT = kKT;
  static constexpr int DW = D < 64 ? D : 64;    // dims per swizzled slab
  static constexpr int W = 2 * DW;              // a slab row in bytes: the
                                                // swizzle width
  static constexpr int SLABS = D / DW;
  static constexpr int LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;  // wgmma's
                                                // B128 / B64 / B32
  static constexpr int Q_BYTES = 64 * D * 2;    // one warpgroup's Q
  static constexpr int KV_BYTES = KT * D * 2;   // one K (or V) tile
  static constexpr int DATA = kWG * Q_BYTES + kStages * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + DATA + 8 * (2 * kStages + 1);
};

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

// TMA: a box of the 4-D tensor map at coordinates (d, head, row, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64) (+)= A B^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// O (64 x 16) += P V, P bf16 fragments in registers, V MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(acc));
}

// O (64 x 32) += P V, P bf16 fragments in registers, V MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(acc));
}

// O (64 x 64) += P V, P bf16 fragments in registers, V MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(acc));
}

// 2^x (ex2.approx, subnormal results flushed to 0): exact at x = 0 and 0
// at x <= -1e30, the two values the contract fixes
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The keys rows r0 <= r1 need: [vis_lo(r0), vis_hi(r1)) when every row
// sees a key (the rows that do form one run, and both ends grow with the
// row), else [0, kv_pad).  `inner` gets the keys every row sees:
// [vis_lo(r1), vis_hi(r0)), empty when a row sees none.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span visible(int qp, int kv_len, int causal,
                                        int window) {
  return {window ? max(qp - window + 1, 0) : 0,
          causal ? min(qp + 1, kv_len) : kv_len};
}

__device__ __forceinline__ Span need(int r0, int r1, int offset, int kv_len,
                                     int causal, int window, int kv_pad,
                                     Span* inner) {
  const Span a = visible(r0 + offset, kv_len, causal, window);
  const Span z = visible(r1 + offset, kv_len, causal, window);
  if (a.lo < a.hi && z.lo < z.hi) {
    *inner = {z.lo, a.hi};
    return {a.lo, z.hi};
  }
  *inner = {0, 0};
  return {0, kv_pad};
}

template <int D>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, int Sq,
                             int Hq, int Hkv, int kv_len, int offset,
                             int causal, int window, int kv_pad,
                             float scale_log2, float* __restrict__ lse) {
  using T = Tile<D>;
  constexpr int KT = T::KT, DW = T::DW, W = T::W, SLABS = T::SLABS;
  constexpr int LAYOUT = T::LAYOUT;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the buffers to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;                        // [kWG][SLABS][64][W]
  uint8_t* kv_s = smem + kWG * T::Q_BYTES;    // [kStages][K, V][SLABS][KT][W]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::DATA);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int hk = h / (Hq / Hkv);

  // the keys the block walks (the union of its warpgroups') and those this
  // warpgroup computes
  Span unused, inner = {0, 0};
  const Span block = need(q0, min(q0 + kRows, Sq) - 1, offset, kv_len, causal,
                          window, kv_pad, &unused);
  const int w0 = q0 + 64 * wg;
  const bool live = w0 < Sq;
  const Span mine = live ? need(w0, min(w0 + 64, Sq) - 1, offset, kv_len,
                                causal, window, kv_pad, &inner)
                         : Span{0, 0};
  const int lo = block.lo / KT * KT;
  const int n_tiles = (block.hi - lo + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 is the producer: Q once, then K/V tile u into stage u % kStages
  auto load_kv = [&](int u) {
    const int s = u % kStages;
    uint8_t* k_dst = kv_s + s * 2 * T::KV_BYTES;
    mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < SLABS; ++c) {
      tma_load(k_dst + c * KT * W, &tk, &full[s], c * DW, hk, lo + u * KT, b);
      tma_load(k_dst + T::KV_BYTES + c * KT * W, &tv, &full[s], c * DW, hk,
               lo + u * KT, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, kWG * T::Q_BYTES);
    for (int w = 0; w < kWG; ++w)
#pragma unroll
      for (int c = 0; c < SLABS; ++c)
        tma_load(q_s + w * T::Q_BYTES + c * 64 * W, &tq, q_bar, c * DW, h,
                 q0 + 64 * w, b);
    for (int u = 0; u < kStages - 1 && u < n_tiles; ++u) load_kv(u);
  }

  // this thread's rows of the warpgroup's 64: r_a and r_a + 8 (accumulator
  // element i sits at row r_a + 8 * ((i >> 1) & 1), column
  // 8 * (i >> 2) + 2 * (lane & 3) + (i & 1))
  const int r_a = w0 + 16 * warp + lane / 4;
  float o[SLABS][DW / 2];
#pragma unroll
  for (int c = 0; c < SLABS; ++c)
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[c][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(q_s + wg * T::Q_BYTES);
  mbar_wait(q_bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    if (tid == 0 && it + kStages - 1 < n_tiles) {
      const int u = it + kStages - 1;           // refill the stage freed by
      if (u >= kStages)                         // tile u - kStages
        mbar_wait(&empty[u % kStages], (u / kStages - 1) & 1);
      load_kv(u);
    }
    __syncwarp();
    mbar_wait(&full[s], (it / kStages) & 1);
    __syncwarp();
    const int kv0 = lo + it * KT;
    if (kv0 < mine.hi && kv0 + KT > mine.lo) {
      const uint32_t k_addr = smem_u32(kv_s + s * 2 * T::KV_BYTES);
      const uint32_t v_addr = k_addr + T::KV_BYTES;
      float sc[KT / 2];
      // S = Q K^T, K-major operands; a 16-dim step is 32 bytes along a
      // slab's swizzled row
      pin<KT / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / DW, off = (kk * 16 % DW) * 2;
        wgmma_ss_n64(sc,
                     gmma_desc(q_addr + c * 64 * W + off, 16, 8 * W, LAYOUT),
                     gmma_desc(k_addr + c * KT * W + off, 16, 8 * W, LAYOUT),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<KT / 2>(sc);

      // scores in the log2 domain; the mask only where a boundary crosses
      // the tile
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sc[i] *= scale_log2;
      if (!(kv0 >= inner.lo && kv0 + KT <= inner.hi)) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int qp = r_a + 8 * ((i >> 1) & 1) + offset;
          const int kv = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = kv < kv_len;
          if (causal) ok = ok && kv <= qp;
          if (window) ok = ok && kv > qp - window;
          const float x = ok ? sc[i] : kNegInf;
          sc[i] = kv < kv_pad ? x : -INFINITY;  // not walked: adds nothing
        }
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          if (((i >> 1) & 1) == rr) mx = fmaxf(mx, sc[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        corr[rr] = ex2(m[rr] - m_new);
        m[rr] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int rr = (i >> 1) & 1;
        sc[i] = ex2(sc[i] - m[rr]);
        psum[rr] += sc[i];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + psum[rr];
      // p rounded to bf16: the accumulator layout of 16 keys is the A
      // fragment layout of one k16 step
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
#pragma unroll
      for (int c = 0; c < SLABS; ++c)
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];

      // O += P V, V MN-major: a 16-key step is 16 slab rows
#pragma unroll
      for (int c = 0; c < SLABS; ++c) pin<DW / 2>(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int c = 0; c < SLABS; ++c) {
          const uint64_t dv = gmma_desc(v_addr + c * KT * W + kk * 16 * W,
                                        KT * W, 8 * W, LAYOUT);
          if constexpr (DW == 64)
            wgmma_rs_n64(o[c], pa[kk], dv, 1);
          else if constexpr (DW == 32)
            wgmma_rs_n32(o[c], pa[kk], dv, 1);
          else
            wgmma_rs_n16(o[c], pa[kk], dv, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < SLABS; ++c) pin<DW / 2>(o[c]);
    }
    mbar_arrive(&empty[s]);
  }
  if (!live) return;

  // epilogue: acc / max(l, 1e-20) as bf16 into this warpgroup's Q buffer,
  // swizzled as the tensor map expects, then one TMA store per slab
  float den[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float t = l[rr];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    den[rr] = fmaxf(t, 1e-20f);
    // lse in natural-log units: m is in log2 units here
    const int row = r_a + 8 * rr;
    if (lse != nullptr && (lane & 3) == 0 && row < Sq)
      lse[((long long)b * Hq + h) * Sq + row] = (m[rr] + log2f(t)) * kLn2;
  }
  uint8_t* o_s = q_s + wg * T::Q_BYTES;
#pragma unroll
  for (int c = 0; c < SLABS; ++c)
#pragma unroll
    for (int i = 0; i < DW / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      const int row = 16 * warp + lane / 4 + 8 * rr;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      int off = row * W + col * 2;
      off ^= ((off >> 7) & (W / 16 - 1)) << 4;
      *reinterpret_cast<uint32_t*>(o_s + c * 64 * W + off) =
          pack_bf16(o[c][i] / den[rr], o[c][i + 1] / den[rr]);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int c = 0; c < SLABS; ++c)
      tma_store(&to, o_s + c * 64 * W, c * DW, h, w0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

// the 4-D map of a contiguous bf16 (B, S, H, D) tensor, boxes of `rows`
// rows of one head and one slab of dims, swizzled for wgmma
template <int D>
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                int S, int H, int rows) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::DW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Skv,
                         int Hq, int Hkv, int kv_len, int offset, int causal,
                         int window, int kv_pad, float scale,
                         cudaStream_t stream) {
  using T = Tile<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<D>(enc, &tq, q, B, Sq, Hq, 64) ||
      !tensor_map<D>(enc, &tk, k, B, Skv, Hkv, T::KT) ||
      !tensor_map<D>(enc, &tv, v, B, Skv, Hkv, T::KT) ||
      !tensor_map<D>(enc, &to, out, B, Sq, Hq, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, B, (Sq + kRows - 1) / kRows);
  flash_attention_wgmma_kernel<D><<<grid, kWG * 128, T::SMEM, stream>>>(
      tq, tk, tv, to, Sq, Hq, Hkv, kv_len, offset, causal, window, kv_pad,
      scale * kLog2e, lse);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(int D, const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int Sq, int Skv,
                           int Hq, int Hkv, int kv_len, int offset, int causal,
                           int window, int kv_pad, float scale,
                           cudaStream_t s) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch_wgmma<DD>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, kv_len, \
                            offset, causal, window, kv_pad, scale, s);
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
// 16-byte aligned, one dtype (0 float32: CUDA cores, 1 bfloat16: tensor
// cores); D in {16, 32, 64, 128, 256}; Hq % Hkv == 0.  kv_len <= Skv keys
// are real; row i sits at i + offset.  kv_pad >= Skv: the keys a row that
// sees none walks (see the note at the top).  lse: (B, Hq, Sq) f32 or null
// (then not written).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Sq, int Skv,
                               int Hq, int Hkv, int D, int kv_len, int offset,
                               int causal, int window, int kv_pad,
                               float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Skv == 0)        // no key to walk: acc = l = 0, the output 0
      return static_cast<int>(cudaMemsetAsync(
          out, 0, (size_t)B * Sq * Hq * D * sizeof(__nv_bfloat16), s));
    return dispatch_wgmma(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, kv_len,
                          offset, causal, window, kv_pad, scale, s);
  }
  if (dtype == 0)
    return dispatch(D, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, kv_len,
                    offset, causal, window, kv_pad, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// keys per online-softmax step of the bf16 kernel (KEY_TILE in
// flash_attention.py, which the bf16 checks need)
extern "C" int flash_attention_key_tile() { return kKT; }

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
