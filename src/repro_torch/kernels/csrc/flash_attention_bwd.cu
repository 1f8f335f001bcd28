// The backward of flash attention (flash_attention.cu) for Hopper (sm_90a):
// dq, dk and dv of causal, windowed, GQA, non-causal and cross-length
// (Sq != Skv) attention with a kv_len / offset alignment.
//
// Replaces no TPU kernel: the reference differentiates its chunked_attention
// scan with XLA's autodiff (repro/nn/layers.py::chunked_attention), and the
// port's forward is a hand-written kernel autograd cannot see through, so its
// gradient is hand-written too.  Row i sits at position i + offset and sees
// key j when j < kv_len, j <= i + offset (causal) and j > i + offset - window
// (window > 0).  With the forward's lse (m + ln l, natural log) and
// delta = rowsum(dO * O):
//
//   P = exp(scale q.k - lse) where row i sees key j, else 0
//   dV = P^T dO,   dS = P * (dO V^T - delta),   dK = scale dS^T Q,
//   dQ = scale dS K
//
// Three kernels, each output written once, no atomics, so a run is
// deterministic: (a) delta, one warp a (row, head); (b) dK/dV, a block per
// (64-key tile, KV head, batch row) looping over the G query heads of its
// group and the query tiles that see the key tile (the causal frontier and
// the window bound the walk), so GQA's sum over heads stays in registers;
// (c) dQ, a block per (query tile, query head, batch row) walking the key
// tiles the forward walked.  (b) and (c) both recompute S and dO V^T: seven
// products where five would do, in exchange for no cross-block reduction.
// Bound: operations, 2 * D flops a visible (row, key) pair and product.
//
// Rows that see no key (Model.loss never makes them) are outside the
// contract: their P is 0 here, so they add nothing to dk and dv and get a
// zero dq, where the forward gave them the mean of v.
//
// bfloat16 -- the tensor cores through mma.sync m16n8k16 (bf16 operands, f32
// accumulators), operands staged in shared memory by cp.async (rows padded
// by 16 bytes, so ldmatrix reads eight rows from eight bank groups) in a ring
// of two stages.  (b): four warps, each 16 keys of the tile; per query tile
// S^T = K Q^T and dP^T = V dO^T land in accumulator fragments, P^T = 2^(S^T
// scale log2(e) - lse log2(e)) and dS^T are formed in registers and re-packed
// as bf16 A fragments (P rounded to v's type, as the forward rounds it before
// its PV product), then dV += P^T dO and dK += dS^T Q against dO and Q read
// transposed by ldmatrix; 64 query rows a step at D <= 64, 32 at D = 128 (the
// dk and dv accumulators take D registers a thread).  (c): four warps, each
// 16 query rows; per 64-key tile S = Q K^T, dP = dO V^T, then dQ += dS K.
// One rounding to bf16 on store.
//
// float32 -- the CUDA cores (the *_simt_kernel's; the tensor-core ones are
// *_mma_kernel), for the checks that hold f32 gradients tightly:
// tiles of 32 query rows and 64 keys in shared memory (rows padded by one
// float), 256 threads; a thread forms 8 (row, key) pairs of S and dO V^T,
// P and dS go through shared memory, then each thread accumulates its share
// of dk and dv (a key, D / 4 dims) or of dq (a row, D / 8 dims).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Which (row, key) pairs the forward let through, and the spans that bound
// the kernels' walks.
struct Mask {
  int Sq, kv_len, offset, causal, window;

  __device__ __forceinline__ bool operator()(int i, int j) const {
    if (i >= Sq || j >= kv_len) return false;
    const int qp = i + offset;
    if (causal && j > qp) return false;
    if (window && j <= qp - window) return false;
    return true;
  }
  // rows [*lo, *hi) that see a key of [k0, k1), k1 <= kv_len
  __device__ __forceinline__ void rows(int k0, int k1, int* lo,
                                       int* hi) const {
    *lo = causal ? max(k0 - offset, 0) : 0;
    *hi = window ? min(Sq, k1 - 1 + window - offset) : Sq;
    if (k0 >= k1 || *hi < *lo) *hi = *lo;
  }
  // keys [*lo, *hi) that rows [r0, r1) see
  __device__ __forceinline__ void keys(int r0, int r1, int* lo,
                                       int* hi) const {
    *lo = window ? max(r0 + offset - window + 1, 0) : 0;
    *hi = causal ? min(r1 + offset, kv_len) : kv_len;
    if (*hi < *lo) *hi = *lo;
  }
};

// ------------------------------------------------------------------- delta

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta (B, Hq, Sq) = sum over d of dO * O, one warp a (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int Hq,
                       int D) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* a = o + (long long)r * D;
  const T* c = dout + (long long)r * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(a[d]), to_f32(c[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const int h = r % Hq;
    const int sq = (r / Hq) % Sq;
    const int b = r / Hq / Sq;
    delta[((long long)b * Hq + h) * Sq + sq] = s;
  }
}

// ---------------------------------------------------------------- float32

constexpr int kFQ = 32;        // query rows a tile
constexpr int kFK = 64;        // keys a tile
constexpr int kFThreads = 256;

template <int D>
struct F32 {
  static constexpr int P = D + 1;        // row pitch in floats
  static constexpr int PP = kFQ + 1;     // P / dS row pitch: [key][row]
  static constexpr size_t SMEM =
      sizeof(float) *
      (2 * kFQ * P + 2 * kFK * P + 2 * kFK * PP + 2 * kFQ);
};

// rows [r0, r0 + n) of head h of a (B, S, H, D) f32 tensor into rows of
// `pitch` floats; rows past S read as zeros
template <int D>
__device__ __forceinline__ void f32_rows(float* dst, const float* src, int b,
                                         int S, int H, int h, int r0, int n) {
  for (int i = threadIdx.x; i < n * D; i += kFThreads) {
    const int r = i / D, d = i % D;
    const int s = r0 + r;
    dst[r * F32<D>::P + d] =
        s < S ? src[(((long long)b * S + s) * H + h) * D + d] : 0.0f;
  }
}

// lse and delta of rows [i0, i0 + kFQ) of one (b, h): (B, Hq, Sq) rows
__device__ __forceinline__ void f32_vec(float* dst, const float* src, int i0,
                                        int Sq) {
  for (int r = threadIdx.x; r < kFQ; r += kFThreads)
    dst[r] = i0 + r < Sq ? src[i0 + r] : 0.0f;
}

// P and dS of the tile pair (rows i0.., keys j0..), as [key][row]: thread
// (key tid % 64, rows 8 * (tid / 64)..+7) forms 8 scores and 8 dO.v
template <int D>
__device__ __forceinline__ void f32_scores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int i0,
    int j0, const Mask& mask, float scale) {
  constexpr int P = F32<D>::P, PP = F32<D>::PP;
  const int j = threadIdx.x % kFK;
  const int r0 = 8 * (threadIdx.x / kFK);
  float s[8], dp[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kv = k_s[j * P + d], vv = v_s[j * P + d];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = fmaf(q_s[(r0 + e) * P + d], kv, s[e]);
      dp[e] = fmaf(do_s[(r0 + e) * P + d], vv, dp[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = r0 + e;
    const float p =
        mask(i0 + r, j0 + j) ? expf(s[e] * scale - lse_s[r]) : 0.0f;
    p_s[j * PP + r] = p;
    ds_s[j * PP + r] = p * (dp[e] - dl_s[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dkdv_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Skv, int Hq, int Hkv, Mask mask,
                          float scale) {
  constexpr int P = F32<D>::P, PP = F32<D>::PP, DPT = D / 4;
  extern __shared__ float smem[];
  float* q_s = smem;                     // [kFQ][P]
  float* do_s = q_s + kFQ * P;           // [kFQ][P]
  float* k_s = do_s + kFQ * P;           // [kFK][P]
  float* v_s = k_s + kFK * P;            // [kFK][P]
  float* p_s = v_s + kFK * P;            // [kFK][PP]
  float* ds_s = p_s + kFK * PP;          // [kFK][PP]
  float* lse_s = ds_s + kFK * PP;        // [kFQ]
  float* dl_s = lse_s + kFQ;             // [kFQ]

  const int k0 = blockIdx.x * kFK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  f32_rows<D>(k_s, k, b, Skv, Hkv, hk, k0, kFK);
  f32_rows<D>(v_s, v, b, Skv, Hkv, hk, k0, kFK);
  int lo, hi;
  mask.rows(k0, min(k0 + kFK, mask.kv_len), &lo, &hi);

  const int jj = threadIdx.x % kFK, d0 = (threadIdx.x / kFK) * DPT;
  float ak[DPT], av[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) ak[e] = av[e] = 0.0f;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long row = ((long long)b * Hq + h) * Sq;
    for (int i0 = lo / kFQ * kFQ; i0 < hi; i0 += kFQ) {
      __syncthreads();                 // the last tile is consumed
      f32_rows<D>(q_s, q, b, Sq, Hq, h, i0, kFQ);
      f32_rows<D>(do_s, dout, b, Sq, Hq, h, i0, kFQ);
      f32_vec(lse_s, lse + row, i0, Sq);
      f32_vec(dl_s, delta + row, i0, Sq);
      __syncthreads();
      f32_scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, i0, k0,
                    mask, scale);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kFQ; ++r) {
        const float p = p_s[jj * PP + r], ds = ds_s[jj * PP + r];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          av[e] = fmaf(p, do_s[r * P + d0 + e], av[e]);
          ak[e] = fmaf(ds, q_s[r * P + d0 + e], ak[e]);
        }
      }
    }
  }
  if (k0 + jj >= Skv) return;
  const long long at = (((long long)b * Skv + k0 + jj) * Hkv + hk) * D + d0;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    dk[at + e] = ak[e] * scale;
    dv[at + e] = av[e];
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Skv, int Hq,
                        int Hkv, Mask mask, float scale) {
  constexpr int P = F32<D>::P, PP = F32<D>::PP, DPT = D / 8;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kFQ * P;
  float* k_s = do_s + kFQ * P;
  float* v_s = k_s + kFK * P;
  float* p_s = v_s + kFK * P;
  float* ds_s = p_s + kFK * PP;
  float* lse_s = ds_s + kFK * PP;
  float* dl_s = lse_s + kFQ;

  const int i0 = blockIdx.x * kFQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long long row = ((long long)b * Hq + h) * Sq;
  f32_rows<D>(q_s, q, b, Sq, Hq, h, i0, kFQ);
  f32_rows<D>(do_s, dout, b, Sq, Hq, h, i0, kFQ);
  f32_vec(lse_s, lse + row, i0, Sq);
  f32_vec(dl_s, delta + row, i0, Sq);
  int lo, hi;
  mask.keys(i0, min(i0 + kFQ, Sq), &lo, &hi);

  const int ii = threadIdx.x % kFQ, d0 = (threadIdx.x / kFQ) * DPT;
  float aq[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) aq[e] = 0.0f;
  for (int j0 = lo / kFK * kFK; j0 < hi; j0 += kFK) {
    __syncthreads();                   // the last tile is consumed
    f32_rows<D>(k_s, k, b, Skv, Hkv, hk, j0, kFK);
    f32_rows<D>(v_s, v, b, Skv, Hkv, hk, j0, kFK);
    __syncthreads();
    f32_scores<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, i0, j0, mask,
                  scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFK; ++j) {
      const float ds = ds_s[j * PP + ii];
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        aq[e] = fmaf(ds, k_s[j * P + d0 + e], aq[e]);
    }
  }
  if (i0 + ii >= Sq) return;
  const long long at = (((long long)b * Sq + i0 + ii) * Hq + h) * D + d0;
#pragma unroll
  for (int e = 0; e < DPT; ++e) dq[at + e] = aq[e] * scale;
}

// --------------------------------------------------------------- bfloat16

typedef __nv_bfloat16 bf16;

template <int D>
struct Bf16 {
  static constexpr int BQ = D <= 64 ? 64 : 32;   // query rows a step of (b)
  static constexpr int BK = 64;                  // keys a block of (b), a
                                                 // step of (c)
  static constexpr int PITCH = D + 8;            // a staged row, elements
  static constexpr int ROW_BYTES = PITCH * 2;
  // (b): K, V [BK][PITCH]; Q, dO [2][BQ][PITCH]; lse, delta [2][BQ]
  static constexpr int DKDV_SMEM =
      2 * BK * ROW_BYTES + 2 * 2 * BQ * ROW_BYTES + 2 * 2 * BQ * 4;
  // (c): Q, dO [64][PITCH]; K, V [2][BK][PITCH]
  static constexpr int DQ_SMEM = 2 * 64 * ROW_BYTES + 2 * 2 * BK * ROW_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros when !valid (nothing is read then)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment addresses.  A (16 x 16) from rows r0.. and columns c0.. of a
// row-major tile: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) give a0..a3.
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int pitch, int r0,
                                           int c0, int lane) {
  return smem_u32(tile + (r0 + lane % 8 + 8 * (lane / 8 % 2)) * pitch + c0 +
                  8 * (lane / 16));
}
// B fragments of two n8 tiles from a tile stored [n][k] (rows n0.., columns
// k0..): r0, r1 for rows n0..n0+7, r2, r3 for n0+8..n0+15
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int pitch, int n0,
                                           int k0, int lane) {
  return smem_u32(tile + (n0 + lane % 8 + 8 * (lane / 16)) * pitch + k0 +
                  8 * (lane / 8 % 2));
}
// the same from a tile stored [k][n] (rows k0.., columns n0..), by ldsm_t
__device__ __forceinline__ uint32_t bt_addr(const bf16* tile, int pitch,
                                            int k0, int n0, int lane) {
  return smem_u32(tile + (k0 + lane % 8 + 8 * (lane / 8 % 2)) * pitch + n0 +
                  8 * (lane / 16));
}

// rows [r0, r0 + ROWS) of head h of a (B, S, H, D) bf16 tensor into rows of
// PITCH elements, 16 bytes a copy; rows past S are zeros
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int b,
                                           int S, int H, int h, int r0) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += 128) {
    const int r = c / CH, col = c % CH * 8;
    const int s = r0 + r;
    const bool ok = s < S;
    cp16(dst + r * Bf16<D>::PITCH + col,
         src + (((long long)b * S + (ok ? s : 0)) * H + h) * D + col, ok);
  }
}

template <int ROWS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int i0,
                                          int Sq) {
  for (int r = threadIdx.x; r < ROWS; r += 128) {
    const bool ok = i0 + r < Sq;
    cp4(dst + r, src + (ok ? i0 + r : 0), ok);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Sq, int Skv, int Hq, int Hkv, Mask mask,
                           float scale) {
  using T = Bf16<D>;
  constexpr int BQ = T::BQ, BK = T::BK, PITCH = T::PITCH;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);      // [BK][PITCH]
  bf16* v_s = k_s + BK * PITCH;                       // [BK][PITCH]
  bf16* q_s = v_s + BK * PITCH;                       // [2][BQ][PITCH]
  bf16* do_s = q_s + 2 * BQ * PITCH;                  // [2][BQ][PITCH]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * PITCH);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                    // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;
  int lo, hi;
  mask.rows(k0, min(k0 + BK, mask.kv_len), &lo, &hi);
  const int t0 = lo / BQ;
  const int nt = hi > lo ? (hi + BQ - 1) / BQ - t0 : 0;
  const int n_steps = G * nt;

  // step u: query head hk * G + u / nt, query tile t0 + u % nt
  auto stage = [&](int u) {
    const int s = u & 1;
    const int h = hk * G + u / nt;
    const int i0 = (t0 + u % nt) * BQ;
    stage_rows<D, BQ>(q_s + s * BQ * PITCH, q, b, Sq, Hq, h, i0);
    stage_rows<D, BQ>(do_s + s * BQ * PITCH, dout, b, Sq, Hq, h, i0);
    const long long row = ((long long)b * Hq + h) * Sq;
    stage_vec<BQ>(lse_s + s * BQ, lse + row, i0, Sq);
    stage_vec<BQ>(dl_s + s * BQ, delta + row, i0, Sq);
  };
  stage_rows<D, BK>(k_s, k, b, Skv, Hkv, hk, k0);
  stage_rows<D, BK>(v_s, v, b, Skv, Hkv, hk, k0);
  if (n_steps > 0) stage(0);
  cp_commit();

  // this warp's keys kr..kr+15; accumulator element e of n8 tile n sits at
  // key kr + g8 + 8 * (e >> 1), column 8 * n + 2 * t4 + (e & 1)
  const int kr = 16 * warp;
  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.0f;

  for (int u = 0; u < n_steps; ++u) {
    if (u + 1 < n_steps) stage(u + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int s = u & 1;
    const int i0 = (t0 + u % nt) * BQ;
    const bf16* qs = q_s + s * BQ * PITCH;
    const bf16* dos = do_s + s * BQ * PITCH;
    const float* lses = lse_s + s * BQ;
    const float* dls = dl_s + s * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows
    float st[BQ / 8][4], pt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = pt[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, a_addr(k_s, PITCH, kr, 16 * kk, lane));
      ldsm(va, a_addr(v_s, PITCH, kr, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qb[4], ob[4];
        ldsm(qb, b_addr(qs, PITCH, 16 * np, 16 * kk, lane));
        ldsm(ob, b_addr(dos, PITCH, 16 * np, 16 * kk, lane));
        mma(st[2 * np], ka, qb[0], qb[1]);
        mma(st[2 * np + 1], ka, qb[2], qb[3]);
        mma(pt[2 * np], va, ob[0], ob[1]);
        mma(pt[2 * np + 1], va, ob[2], ob[3]);
      }
    }
    // P^T into st, dS^T into pt
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * t4 + (e & 1);
        const int j = k0 + kr + g8 + 8 * (e >> 1);
        const float p =
            mask(i0 + r, j) ? ex2(st[n][e] * scale_log2 - lses[r] * kLog2e)
                            : 0.0f;
        st[n][e] = p;
        pt[n][e] = p * (pt[n][e] - dls[r]);
      }
    // dV += P^T dO, dK += dS^T Q over the BQ rows; the accumulator layout
    // of two n8 tiles is the A layout of one k16 step
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack(st[2 * kk][0], st[2 * kk][1]),
                              pack(st[2 * kk][2], st[2 * kk][3]),
                              pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack(pt[2 * kk][0], pt[2 * kk][1]),
                              pack(pt[2 * kk][2], pt[2 * kk][3]),
                              pack(pt[2 * kk + 1][0], pt[2 * kk + 1][1]),
                              pack(pt[2 * kk + 1][2], pt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t ob[4], qb[4];
        ldsm_t(ob, bt_addr(dos, PITCH, 16 * kk, 16 * dp, lane));
        ldsm_t(qb, bt_addr(qs, PITCH, 16 * kk, 16 * dp, lane));
        mma(av[2 * dp], pa, ob[0], ob[1]);
        mma(av[2 * dp + 1], pa, ob[2], ob[3]);
        mma(ak[2 * dp], sa, qb[0], qb[1]);
        mma(ak[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();       // stage s is refilled at step u + 1 for u + 2
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = k0 + kr + g8 + 8 * half;
      if (j < Skv) {
        const long long at =
            (((long long)b * Skv + j) * Hkv + hk) * D + 8 * n + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack(ak[n][2 * half] * scale, ak[n][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack(av[n][2 * half], av[n][2 * half + 1]);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Skv, int Hq,
                         int Hkv, Mask mask, float scale) {
  using T = Bf16<D>;
  constexpr int BK = T::BK, PITCH = T::PITCH;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // [64][PITCH]
  bf16* do_s = q_s + 64 * PITCH;                      // [64][PITCH]
  bf16* k_s = do_s + 64 * PITCH;                      // [2][BK][PITCH]
  bf16* v_s = k_s + 2 * BK * PITCH;                   // [2][BK][PITCH]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int i0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float scale_log2 = scale * kLog2e;
  int lo, hi;
  mask.keys(i0, min(i0 + 64, Sq), &lo, &hi);
  const int j_lo = lo / BK * BK;
  const int n_steps = hi > lo ? (hi - j_lo + BK - 1) / BK : 0;

  auto stage = [&](int u) {
    const int s = u & 1;
    stage_rows<D, BK>(k_s + s * BK * PITCH, k, b, Skv, Hkv, hk, j_lo + u * BK);
    stage_rows<D, BK>(v_s + s * BK * PITCH, v, b, Skv, Hkv, hk, j_lo + u * BK);
  };
  stage_rows<D, 64>(q_s, q, b, Sq, Hq, h, i0);
  stage_rows<D, 64>(do_s, dout, b, Sq, Hq, h, i0);
  if (n_steps > 0) stage(0);
  cp_commit();

  // this warp's rows wr..wr+15; accumulator element e of n8 tile n sits at
  // row wr + g8 + 8 * (e >> 1), column 8 * n + 2 * t4 + (e & 1)
  const int wr = 16 * warp;
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = i0 + wr + g8 + 8 * half;
    const long long at = ((long long)b * Hq + h) * Sq + (r < Sq ? r : 0);
    lse2[half] = r < Sq ? lse[at] * kLog2e : 0.0f;
    dl[half] = r < Sq ? delta[at] : 0.0f;
  }
  float aq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[n][e] = 0.0f;

  for (int u = 0; u < n_steps; ++u) {
    if (u + 1 < n_steps) stage(u + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int s = u & 1;
    const int j0 = j_lo + u * BK;
    const bf16* ks = k_s + s * BK * PITCH;
    const bf16* vs = v_s + s * BK * PITCH;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys
    float st[BK / 8][4], pt[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = pt[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm(qa, a_addr(q_s, PITCH, wr, 16 * kk, lane));
      ldsm(oa, a_addr(do_s, PITCH, wr, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4], vb[4];
        ldsm(kb, b_addr(ks, PITCH, 16 * np, 16 * kk, lane));
        ldsm(vb, b_addr(vs, PITCH, 16 * np, 16 * kk, lane));
        mma(st[2 * np], qa, kb[0], kb[1]);
        mma(st[2 * np + 1], qa, kb[2], kb[3]);
        mma(pt[2 * np], oa, vb[0], vb[1]);
        mma(pt[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // dS into pt
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int r = i0 + wr + g8 + 8 * half;
        const int j = j0 + 8 * n + 2 * t4 + (e & 1);
        const float p =
            mask(r, j) ? ex2(st[n][e] * scale_log2 - lse2[half]) : 0.0f;
        pt[n][e] = p * (pt[n][e] - dl[half]);
      }
    // dQ += dS K over the BK keys, K read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t sa[4] = {pack(pt[2 * kk][0], pt[2 * kk][1]),
                              pack(pt[2 * kk][2], pt[2 * kk][3]),
                              pack(pt[2 * kk + 1][0], pt[2 * kk + 1][1]),
                              pack(pt[2 * kk + 1][2], pt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t kb[4];
        ldsm_t(kb, bt_addr(ks, PITCH, 16 * kk, 16 * dp, lane));
        mma(aq[2 * dp], sa, kb[0], kb[1]);
        mma(aq[2 * dp + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();       // stage s is refilled at step u + 1 for u + 2
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = i0 + wr + g8 + 8 * half;
      if (r < Sq)
        *reinterpret_cast<uint32_t*>(
            dq + (((long long)b * Sq + r) * Hq + h) * D + 8 * n + 2 * t4) =
            pack(aq[n][2 * half] * scale, aq[n][2 * half + 1] * scale);
    }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t smem_attr(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, Hkv;
  Mask mask;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t dkdv_f32(const Args& a) {
  cudaError_t e = smem_attr(flash_bwd_dkdv_simt_kernel<D>, F32<D>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Skv + kFK - 1) / kFK, a.Hkv, a.B);
  flash_bwd_dkdv_simt_kernel<D><<<grid, kFThreads, F32<D>::SMEM, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.dk, (float*)a.dv, a.Sq, a.Skv, a.Hq, a.Hkv, a.mask, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const Args& a) {
  cudaError_t e = smem_attr(flash_bwd_dq_simt_kernel<D>, F32<D>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kFQ - 1) / kFQ, a.Hq, a.B);
  flash_bwd_dq_simt_kernel<D><<<grid, kFThreads, F32<D>::SMEM, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.dq, a.Sq, a.Skv, a.Hq, a.Hkv, a.mask, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkdv_bf16(const Args& a) {
  cudaError_t e = smem_attr(flash_bwd_dkdv_mma_kernel<D>, Bf16<D>::DKDV_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Skv + Bf16<D>::BK - 1) / Bf16<D>::BK, a.Hkv, a.B);
  flash_bwd_dkdv_mma_kernel<D><<<grid, 128, Bf16<D>::DKDV_SMEM, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.dk, (bf16*)a.dv, a.Sq, a.Skv, a.Hq, a.Hkv, a.mask, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const Args& a) {
  cudaError_t e = smem_attr(flash_bwd_dq_mma_kernel<D>, Bf16<D>::DQ_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + 63) / 64, a.Hq, a.B);
  flash_bwd_dq_mma_kernel<D><<<grid, 128, Bf16<D>::DQ_SMEM, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.dq, a.Sq, a.Skv, a.Hq, a.Hkv, a.mask, a.scale);
  return cudaGetLastError();
}

// which = 1: dk and dv, which = 2: dq
template <int D>
cudaError_t launch(int which, int dtype, const Args& a) {
  if (dtype == 1) return which == 1 ? dkdv_bf16<D>(a) : dq_bf16<D>(a);
  return which == 1 ? dkdv_f32<D>(a) : dq_f32<D>(a);
}

cudaError_t run(int which, int D, int dtype, const Args& a) {
  if (a.B == 0 || a.Hq == 0 || (which == 1 ? a.Skv : a.Sq) == 0)
    return cudaSuccess;
  switch (D) {
    case 16:
      return launch<16>(which, dtype, a);
    case 32:
      return launch<32>(which, dtype, a);
    case 64:
      return launch<64>(which, dtype, a);
    case 128:
      return launch<128>(which, dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// delta (B, Hq, Sq) f32 = sum_d dO * O, o and dout (B, Sq, Hq, D)
// contiguous, one dtype (0 float32, 1 bfloat16).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_delta(const void* o, const void* dout,
                                         float* delta, int B, int Sq, int Hq,
                                         int D, int dtype, void* stream) {
  const int rows = B * Sq * Hq;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + 7) / 8;
  if (dtype == 1)
    flash_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(
        (const bf16*)o, (const bf16*)dout, delta, rows, Sq, Hq, D);
  else if (dtype == 0)
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)o, (const float*)dout, delta, rows, Sq, Hq, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// q, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Skv, Hkv, D); lse, delta:
// (B, Hq, Sq) f32; all contiguous, 16-byte aligned, one dtype (0 float32:
// CUDA cores, 1 bfloat16: tensor cores); D in {16, 32, 64, 128}; Hq % Hkv
// == 0; kv_len <= Skv.  which = 1 writes dk and dv (dq may be null), which
// = 2 writes dq (dk, dv may be null); every element of what it writes, the
// keys at kv_len and past as zeros.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_bwd(int which, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, void* dk, void* dv, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int kv_len,
                                   int offset, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,    v,   dout, lse, delta, dq,
               dk, dv,   B,   Sq,   Skv, Hq,    Hkv,
               Mask{Sq, kv_len, offset, causal, window},
               scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(which, D, dtype, a));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
