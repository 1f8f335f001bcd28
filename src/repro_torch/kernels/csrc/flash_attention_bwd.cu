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
// Each output element is written once, with no atomics and every sum in a
// fixed order, so a run is deterministic.  (a) delta; (b) dK/dV, walking
// for each key tile the query tiles that see it (the causal frontier and
// the window bound the walk); (c) dQ, walking for each query tile the key
// tiles the forward walked.  (b) and (c) both recompute S and dO V^T: seven
// products where five would do, in exchange for no cross-block sum of dQ.
// Bound: operations, 2 * D flops a visible (row, key) pair and product.
//
// Rows that see no key (Model.loss never makes them) are outside the
// contract: their P is 0 here, so they add nothing to dk and dv and get a
// zero dq, where the forward gave them the mean of v.
//
// (a) delta (B, Hq, Sq) -- in float32 a kernel of its own: a warp a run of
// 32 consecutive rows of one (b, h), a float4 a lane, D / 4 lanes a row,
// the row's sum by shuffles, one coalesced 128-byte store of the 32 sums
// (bound: bytes).  In bfloat16 the dQ kernel (c), launched first, computes
// its rows' delta while its first tiles load and writes it for (b): O is
// read once and dO's second read hits the L2.
//
// bfloat16 (b), (c) -- the tensor cores through wgmma, in the structure of
// the forward's bf16 route: (B, S, H, D) 4-D tensor maps land 64-row tiles
// in shared memory in slabs of 64 dims (fewer when D < 64) with the
// 128-byte (64-, 32-byte) swizzle that wgmma descriptors read.  A block is
// a producer warpgroup and NW consumer warpgroups (NW = 2 at D = 128, else
// 1; setmaxnreg moves the producer's registers to the consumers): one
// producer warp keeps a ring of 3 stages (2 at D = 256) full by TMA, each stage
// completing on an mbarrier, and each consumer warpgroup computes 64 keys
// (b) or 64 query rows (c).  Two blocks an SM at D <= 64, one at D >= 128.
// Where a boundary (causal diagonal, window edge, Sq, kv_len) crosses a
// tile, P is zeroed where masked after its exponential: no branch per
// element (a branch per element made (b) 1.8x slower).
//
// (b) A block per (64 NW keys, KV head, batch row, cluster rank).  Its K
// and V tiles are loaded once and stay in shared memory; a stage holds a
// 64-row Q tile, the dO tile and their rows' lse * log2(e) and delta (the
// producer warp copies those two with plain loads, then arrives).  Per
// stage and consumer: S^T = K Q^T and dP^T = V dO^T by shared-shared wgmma
// m64n64k16 (both K-major); P^T = 2^(S^T scale log2(e) - lse log2(e)) by
// ex2.approx while dP^T is still in flight; dS^T = P^T (dP^T - delta); P^T
// rounded to bf16 (v's type, as the forward rounds p before its PV
// product) straight into the A fragments of dV += P^T dO, a register-A
// wgmma against dO in shared memory read MN-major (the descriptor's
// transpose); dS^T rounded to bf16 into the A fragments of dK += dS^T Q,
// the same way, packed while dV's product runs.  dK and dV stay in f32
// registers across the walk (D / 2 each a thread).  GQA: the G query
// heads' walks over a (key tile, KV head, batch row), G nt steps, are
// split evenly, step by step, over a thread-block cluster of c blocks;
// after a cluster barrier each block stores slice q of its f32 dK and dV
// into block q's shared memory (st.shared::cluster, distributed shared
// memory), and after a second one block q sums its slice over the c
// blocks in rank order and stores it in bf16, dK times the scale.  The
// wrapper picks c (bwd_cluster): the smallest size whose longest walk is
// near the card's balanced share, since every block pays a start-up and
// its part of the sum (at phase 15's causal shapes on an H100 80GB HBM3 at
// 700 W, c = 2 gives dK/dV in 86 / 142 us, c = G in 136 / 231 us and c = 1
// in 123 / 215 us).  Key tile 0 (the longest causal walk) is scheduled
// first.
//
// (c) A block per (64 NW query rows, query head, batch row), the last tile
// first.  Q and dO stay in shared memory; a stage holds a 64-key K tile and
// the V tile.  Per stage and consumer: S = Q K^T and dP = dO V^T by
// shared-shared wgmma, P and dS as in (b) with each thread's two rows' lse
// and delta (computed here, see (a)) in registers, dS rounded to bf16 into
// the A fragments of dQ += dS K (register-A, K read MN-major).  Epilogue:
// dQ times the scale as bf16 into the warpgroup's Q buffer, swizzled, then
// a TMA store.
//
// D = 256 (the hybrid's local attention, MQA 16:1 under a window): a 64 x
// 256 f32 accumulator is 128 registers a thread, so one warpgroup cannot
// hold both dK and dV, and three ring stages of 64 KB do not fit beside the
// resident 64 KB.  (b) has two consumer warpgroups on one 64-key tile,
// split by output: both compute S^T and P^T, warpgroup 0 owns dV += P^T dO,
// warpgroup 1 also computes dP^T and dS^T and owns dK += dS^T Q; the
// cluster's sum is as above.  (c) has one consumer warpgroup (dQ 128
// registers, no setmaxnreg).  The ring is 2 stages deep in both: 64 KB
// resident and 2 x 64 KB in flight.
//
// float32 -- the CUDA cores (the *_simt_kernel's), for the checks that hold
// f32 gradients tightly: tiles of 32 query rows and 64 keys in shared
// memory (rows padded by one float), 256 threads; a thread forms 8 (row,
// key) pairs of S and dO V^T, P and dS go through shared memory, then each
// thread accumulates its share of dk and dv (a key, D / 4 dims) or of dq (a
// row, D / 8 dims); the dK/dV block walks the G query heads itself.

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is fetched from the driver at run time
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
  // the same as one expression, no branch: the bf16 kernels evaluate it
  // per element (operator() keeps the f32 route's code as it was)
  __device__ __forceinline__ bool sees(int i, int j) const {
    const int qp = i + offset;
    return (i < Sq) & (j < kv_len) & (!causal | (j <= qp)) &
           (!window | (j > qp - window));
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
  // every row of [r0, r0 + nr) sees every key of [k0, k0 + nk)
  __device__ __forceinline__ bool all(int r0, int nr, int k0, int nk) const {
    return r0 + nr <= Sq && k0 + nk <= kv_len &&
           (!causal || k0 + nk - 1 <= r0 + offset) &&
           (!window || k0 > r0 + nr - 1 + offset - window);
  }
};

// ------------------------------------------------------------------- delta

// delta (B, Hq, Sq) = sum over d of dO * O, float32.  A warp takes 32
// consecutive rows s0.. of one (b, h): L = D / 4 lanes a row (a float4
// each; at D = 256 32 lanes, two float4 each), R = 32 / L rows a pass; the
// 32 sums leave in one coalesced store.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int Hq) {
  constexpr int V = D > 128 ? D / 128 : 1;      // float4s a lane
  constexpr int L = D / (4 * V);                // lanes a row
  constexpr int R = 32 / L;                     // rows a pass
  __shared__ float sums[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int runs = (Sq + 31) / 32;
  const long long chunk = (long long)blockIdx.x * 8 + warp;
  if (chunk >= (long long)B * Hq * runs) return;
  const int s0 = (int)(chunk % runs) * 32;
  const int h = (int)(chunk / runs % Hq);
  const int b = (int)(chunk / runs / Hq);
  const int part = lane % L;
#pragma unroll 8
  for (int p = 0; p < 32 / R; ++p) {
    const int s = s0 + p * R + lane / L;
    float acc = 0.0f;
    if (s < Sq) {
#pragma unroll
      for (int w = 0; w < V; ++w) {
        const long long at =
            (((long long)b * Sq + s) * Hq + h) * D + 4 * (part + L * w);
        const float4 x = *reinterpret_cast<const float4*>(o + at);
        const float4 y = *reinterpret_cast<const float4*>(dout + at);
        const float t =
            fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
        acc = w ? acc + t : t;
      }
    }
#pragma unroll
    for (int w = L / 2; w > 0; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (part == 0) sums[warp][p * R + lane / L] = acc;
  }
  __syncwarp();
  if (s0 + lane < Sq)
    delta[((long long)b * Hq + h) * Sq + s0 + lane] = sums[warp][lane];
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

constexpr int kStages = 3;           // depth of the TMA ring below D = 256
constexpr int kMaxCluster = 8;       // the portable cluster size

template <int D>
struct Tile {
  // At D = 256 (SPLIT) the dK/dV kernel's two consumer warpgroups share one
  // 64-key tile and split by output, each holding one 64 x 256 f32
  // accumulator (128 registers a thread): warpgroup 0 owns dV, warpgroup 1
  // dK.  The dQ kernel has one consumer warpgroup there.
  static constexpr bool SPLIT = D == 256;
  static constexpr int NW = D == 128 ? 2 : 1;   // consumer warpgroups of
                                                // (c), and of (b) unless SPLIT
  static constexpr int CW = SPLIT ? 2 : NW;     // consumer warpgroups of (b)
  static constexpr int THREADS = 128 * (NW + 1);
  static constexpr int DKDV_THREADS = 128 * (CW + 1);
  static constexpr int BLOCKS = D >= 128 ? 1 : 2;  // blocks an SM
  static constexpr int STAGES = D == 256 ? 2 : kStages;  // the ring's depth
  // registers a thread after setmaxnreg: the consumers take what the
  // producer warpgroup gives up (launch bounds give each 65536 / (BLOCKS *
  // THREADS), rounded down to 8).  (c) at D = 256, one block of 256
  // threads an SM, moves none: ptxas gives it what it needs, up to 255.
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NW == 2 ? 240 : 232;
  static constexpr int DKDV_CONSUMER_REGS = CW == 2 ? 240 : 232;
  static constexpr bool DQ_MOVES_REGS = !SPLIT;
  static constexpr int DW = D < 64 ? D : 64;    // dims per swizzled slab
  static constexpr int W = 2 * DW;              // a slab row in bytes: the
                                                // swizzle width
  static constexpr int SLABS = D / DW;
  static constexpr int LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;  // wgmma's
                                                // B128 / B64 / B32
  static constexpr int TILE = 64 * D * 2;       // a 64-row tile, bytes
  static constexpr int ROWS = 64 * NW;          // keys (b) / rows (c) a block
  // (b): resident K, V [NW][2][TILE], ring [STAGES][Q, dO][TILE], then
  // [STAGES][lse, delta][64] f32; (c): resident Q, dO [NW][2][TILE], ring
  // [STAGES][K, V][TILE]
  static constexpr int DATA = NW * 2 * TILE + STAGES * 2 * TILE;
  static constexpr int VECS = STAGES * 2 * 64 * 4;
  static constexpr int BARS = 8 * (2 * STAGES + 1);
  static constexpr int DKDV_SMEM = 1024 + DATA + VECS + BARS;
  static constexpr int DQ_SMEM = 1024 + DATA + BARS;
  // (b)'s f32 dK, dV slots at the end, over the resident tiles and the
  // ring: [c][ceil(2 ROWS / c)][PITCH], rows padded by 8 floats against
  // bank conflicts
  static constexpr int PITCH = D + 8;
  static_assert((2 * ROWS + kMaxCluster - 1) * PITCH * 4 <= DATA,
                "the cluster's dK, dV slots fit the tiles' room");
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "a block's shared memory fits the SM's 227 KB");
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

// bytes the barrier's phase waits for, without an arrival
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
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

// a 64-row tile of head h, rows r0.., batch row b: one box per slab
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int r0, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::SLABS; ++c)
    tma_load(dst + c * 64 * T::W, map, bar, c * T::DW, h, r0, b);
}

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// named barrier `id` of n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();                         // the .aligned form: whole warps
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// (x, y) at `local`'s offset in the shared memory of the cluster's CTA
// `rank`
__device__ __forceinline__ void store_remote(float* local, int rank, float x,
                                             float y) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(remote),
               "f"(x), "f"(y)
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// keep A fragments live (unclobbered) until the wgmma reading them is done
template <int N>
__device__ __forceinline__ void hold(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

// C (64 x 64) (+)= A B^T, A and B K-major in shared memory
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

// C (64 x 16) += A B, A bf16 fragments in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// C (64 x 32) += A B, as wgmma_rs_n16
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// C (64 x 64) += A B, as wgmma_rs_n16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
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

// The two products of a 64 x 64 score tile, C = A B^T over D: S (or S^T)
// into s, dP (or dP^T) into dp, two commit groups.  a0 / b0: the first
// product's operands, a1 / b1 the second's, each [SLABS][64][W].
template <int D>
__device__ __forceinline__ void score_pair(float* s, float* dp, uint32_t a0,
                                           uint32_t b0, uint32_t a1,
                                           uint32_t b1) {
  using T = Tile<D>;
  constexpr int W = T::W, DW = T::DW;
  uint64_t da0 = gmma_desc(a0, 16, 8 * W, T::LAYOUT);
  uint64_t db0 = gmma_desc(b0, 16, 8 * W, T::LAYOUT);
  uint64_t da1 = gmma_desc(a1, 16, 8 * W, T::LAYOUT);
  uint64_t db1 = gmma_desc(b1, 16, 8 * W, T::LAYOUT);
  // opaque: the compiler keeps four bases, not every step's descriptor
  // hoisted out of the walk (at D = 128 that spilled)
  asm volatile("" : "+l"(da0), "+l"(db0), "+l"(da1), "+l"(db1));
  pin<32>(s);
  pin<32>(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / DW, off = c * 64 * W + (kk * 16 % DW) * 2;
    wgmma_ss_n64(s, da0 + (off >> 4), db0 + (off >> 4), kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / DW, off = c * 64 * W + (kk * 16 % DW) * 2;
    wgmma_ss_n64(dp, da1 + (off >> 4), db1 + (off >> 4), kk > 0);
  }
  wgmma_commit();
}

// score_pair's first product alone: S^T into s, one commit group
template <int D>
__device__ __forceinline__ void score_one(float* s, uint32_t a0,
                                          uint32_t b0) {
  using T = Tile<D>;
  constexpr int W = T::W, DW = T::DW;
  uint64_t da0 = gmma_desc(a0, 16, 8 * W, T::LAYOUT);
  uint64_t db0 = gmma_desc(b0, 16, 8 * W, T::LAYOUT);
  asm volatile("" : "+l"(da0), "+l"(db0));
  pin<32>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / DW, off = c * 64 * W + (kk * 16 % DW) * 2;
    wgmma_ss_n64(s, da0 + (off >> 4), db0 + (off >> 4), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += A (64 x 64, bf16 fragments, 4 k16 steps) B, B a 64 x D
// tile [SLABS][64][W] in shared memory read MN-major; one commit group
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[Tile<D>::SLABS]
                                                       [Tile<D>::DW / 2],
                                            const uint32_t (&a)[4][4],
                                            uint32_t b) {
  using T = Tile<D>;
  constexpr int W = T::W;
  uint64_t base = gmma_desc(b, 64 * W, 8 * W, T::LAYOUT);
  asm volatile("" : "+l"(base));
#pragma unroll
  for (int c = 0; c < T::SLABS; ++c) pin<T::DW / 2>(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < T::SLABS; ++c) {
      const uint64_t desc = base + ((c * 64 * W + kk * 16 * W) >> 4);
      if constexpr (T::DW == 64)
        wgmma_rs_n64(acc[c], a[kk], desc);
      else if constexpr (T::DW == 32)
        wgmma_rs_n32(acc[c], a[kk], desc);
      else
        wgmma_rs_n16(acc[c], a[kk], desc);
    }
  wgmma_commit();
}

// an accumulator tile's 32 values as the bf16 A fragments of its four k16
// steps along the columns (the accumulator layout of 16 columns is the A
// fragment layout of one k16 step)
__device__ __forceinline__ void to_frags(const float* x, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// (b) at D = 256, one consumer warpgroup's walk: P^T = 2^(S^T scale
// log2(e) - lse log2(e)), then dV += P^T dO (DK false) or, with dP^T,
// dS^T = P^T (dP^T - delta) and dK += dS^T Q (DK true), into acc
template <int D, bool DK>
__device__ __forceinline__ void split_walk(
    float (&acc)[Tile<D>::SLABS][Tile<D>::DW / 2], const uint8_t* ring,
    const float* vecs, uint64_t* full, uint64_t* empty, uint32_t k_addr,
    uint32_t v_addr, int n_steps, int t0, int u0, int nt, int wlo, int whi,
    int kw, int key_a, const Mask& mask, float scale_log2, int lane) {
  using T = Tile<D>;
  constexpr int TILE = T::TILE, STAGES = T::STAGES;
  for (int u = 0; u < n_steps; ++u) {
    const int s = u % STAGES;
    const int i0 = (t0 + (u0 + u) % nt) * 64;
    mbar_wait(&full[s], (u / STAGES) & 1);
    if (i0 < whi && i0 + 64 > wlo) {
      const uint32_t q_addr = smem_u32(ring + s * 2 * TILE);
      const uint32_t do_addr = q_addr + TILE;
      const float* lse2 = vecs + s * 128;
      const float* dl = lse2 + 64;
      float st[32], dpt[32];
      if constexpr (DK)
        score_pair<D>(st, dpt, k_addr, q_addr, v_addr, do_addr);
      else
        score_one<D>(st, k_addr, q_addr);
      float2 rv[8];
#pragma unroll
      for (int g = 0; g < 8; ++g)
        rv[g] = *reinterpret_cast<const float2*>(lse2 + 8 * g +
                                                 2 * (lane & 3));
      wgmma_wait<DK ? 1 : 0>();
      pin<32>(st);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = ex2(st[i] * scale_log2 -
                    ((i & 1) ? rv[i >> 2].y : rv[i >> 2].x));
      if (!mask.all(i0, 64, kw, 64)) {    // a boundary crosses the tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (!mask.sees(i0 + col, key_a + 8 * ((i >> 1) & 1)))
            st[i] = 0.0f;
        }
      }
      uint32_t fa[4][4];
      if constexpr (DK) {
#pragma unroll
        for (int g = 0; g < 8; ++g)
          rv[g] =
              *reinterpret_cast<const float2*>(dl + 8 * g + 2 * (lane & 3));
        wgmma_wait<0>();
        pin<32>(dpt);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dpt[i] =
              st[i] * (dpt[i] - ((i & 1) ? rv[i >> 2].y : rv[i >> 2].x));
        to_frags(dpt, fa);              // dS^T rounded to bf16
        acc_product<D>(acc, fa, q_addr);
      } else {
        to_frags(st, fa);               // P^T rounded to bf16
        acc_product<D>(acc, fa, do_addr);
      }
      wgmma_wait<0>();
      hold(fa);
#pragma unroll
      for (int cc = 0; cc < T::SLABS; ++cc) pin<T::DW / 2>(acc[cc]);
    }
    mbar_arrive(&empty[s]);
  }
}

// (b) dK and dV.  Grid (Hkv * c, B, key tiles of ROWS), clusters of c along
// x: the blocks of cluster hk share the walks of query heads hk * G ..
// hk * G + G - 1 over the key tile, step by step
template <int D>
__global__ void __launch_bounds__(Tile<D>::DKDV_THREADS, Tile<D>::BLOCKS)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int Skv, int Hq, int Hkv, Mask mask, float scale) {
  using T = Tile<D>;
  constexpr int NW = T::NW, TILE = T::TILE, ROWS = T::ROWS, PITCH = T::PITCH,
                STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the buffers to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res = smem;                            // [NW][K, V][TILE]
  uint8_t* ring = smem + NW * 2 * TILE;           // [STAGES][Q, dO][TILE]
  float* vecs = reinterpret_cast<float*>(smem + T::DATA);  // [STAGES][2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::DATA + T::VECS);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const int c = gridDim.x / Hkv, rank = cluster_rank();
  const int hk = blockIdx.x / c, b = blockIdx.y, k0 = blockIdx.z * ROWS;
  const int G = Hq / Hkv;
  int lo, hi;
  mask.rows(k0, min(k0 + ROWS, mask.kv_len), &lo, &hi);
  const int t0 = lo / 64;
  const int nt = hi > lo ? (hi + 63) / 64 - t0 : 0;
  // the G heads' walks, G nt steps (head g, query tile t0 + j) in that
  // order, split evenly over the cluster: this block takes steps u0 + u,
  // 0 <= u < n_steps
  const int u0 = rank * G * nt / c;
  const int n_steps = (rank + 1) * G * nt / c - u0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], T::CW * 128);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: K, V once, then step u0 + u = (head (u0 + u) / nt,
    // query tile t0 + (u0 + u) % nt) into stage u % STAGES
    regs_down<T::PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, NW * 2 * TILE);
        for (int w = 0; w < NW; ++w) {
          tma_tile<D>(res + w * 2 * TILE, &tk, kv_bar, hk, k0 + 64 * w, b);
          tma_tile<D>(res + w * 2 * TILE + TILE, &tv, kv_bar, hk,
                      k0 + 64 * w, b);
        }
      }
      for (int u = 0; u < n_steps; ++u) {
        const int s = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[s], (u / STAGES - 1) & 1);
        const int h = hk * G + (u0 + u) / nt;
        const int i0 = (t0 + (u0 + u) % nt) * 64;
        if (lane == 0) {                // the tiles first, then the rows
          expect_tx(&full[s], 2 * TILE);
          tma_tile<D>(ring + s * 2 * TILE, &tq, &full[s], h, i0, b);
          tma_tile<D>(ring + s * 2 * TILE + TILE, &tdo, &full[s], h, i0, b);
        }
        const long long row = ((long long)b * Hq + h) * mask.Sq;
        float* vr = vecs + s * 128;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half, i = i0 + r;
          vr[r] = i < mask.Sq ? lse[row + i] * kLog2e : 0.0f;
          vr[64 + r] = i < mask.Sq ? delta[row + i] : 0.0f;
        }
        mbar_arrive(&full[s]);
      }
    }
    cluster_barrier();                  // every block is done with its
    cluster_barrier();                  // tiles; the slots are filled
    return;
  }

  regs_up<T::DKDV_CONSUMER_REGS>();
  const int cw = wg - 1;
  const int kt = T::SPLIT ? 0 : cw;   // this warpgroup's K, V tile
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_addr = smem_u32(res + kt * 2 * TILE);
  const uint32_t v_addr = k_addr + TILE;
  const int kw = k0 + 64 * kt;        // this warpgroup's keys kw..kw+63
  int wlo, whi;
  mask.rows(kw, min(kw + 64, mask.kv_len), &wlo, &whi);
  // accumulator element i of a 64 x N tile sits at row (key)
  // 16 warp + lane / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
  // 2 (lane & 3) + (i & 1)
  const int key_a = kw + 16 * warp + lane / 4;
  // dK and dV summed over the cluster in rank order: rows [q span, (q +
  // 1) span) of the 2 ROWS rows of [dK; dV] belong to block q.  Once
  // every block of the cluster is done with its tiles (a cluster
  // barrier), every block stores its f32 values of those rows into the
  // tiles' room of block q, slot `rank` (remote stores: nothing waits on
  // them); after a second cluster barrier block q adds its c slots in
  // rank order and stores bf16, dK times the scale.
  const int span = (2 * ROWS + c - 1) / c;
  float* sums = reinterpret_cast<float*>(smem);   // [c][span][PITCH]
  if constexpr (T::SPLIT) {
    // At D = 256 warpgroup 0 forms P^T and owns dV += P^T dO; warpgroup 1
    // forms P^T, dP^T and dS^T and owns dK += dS^T Q.  Each holds one
    // 64 x 256 f32 accumulator, where one warpgroup holding both would need
    // 256 registers a thread for them alone.
    const bool owns_dk = cw == 1;
    float acc[T::SLABS][T::DW / 2];
#pragma unroll
    for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
      for (int i = 0; i < T::DW / 2; ++i) acc[cc][i] = 0.0f;
    mbar_wait(kv_bar, 0);
    // one walk for each role, each a straight line of products (a walk
    // that branched on the role between them serialized the wgmma's)
    if (owns_dk)
      split_walk<D, true>(acc, ring, vecs, full, empty, k_addr, v_addr,
                          n_steps, t0, u0, nt, wlo, whi, kw, key_a, mask,
                          scale_log2, lane);
    else
      split_walk<D, false>(acc, ring, vecs, full, empty, k_addr, v_addr,
                           n_steps, t0, u0, nt, wlo, whi, kw, key_a, mask,
                           scale_log2, lane);

    cluster_barrier();
    const int base = owns_dk ? 0 : ROWS;  // dK's rows, then dV's
#pragma unroll
    for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
      for (int i = 0; i < T::DW / 2; i += 2) {
        const int r = base + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = cc * T::DW + 8 * (i >> 2) + 2 * (lane & 3);
        const int q = r / span;
        store_remote(sums + (rank * span + r - q * span) * PITCH + col, q,
                     acc[cc][i], acc[cc][i + 1]);
      }
  } else {
    float ak[T::SLABS][T::DW / 2], av[T::SLABS][T::DW / 2];
#pragma unroll
    for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
      for (int i = 0; i < T::DW / 2; ++i) ak[cc][i] = av[cc][i] = 0.0f;
    mbar_wait(kv_bar, 0);

    for (int u = 0; u < n_steps; ++u) {
      const int s = u % STAGES;
      const int i0 = (t0 + (u0 + u) % nt) * 64;
      mbar_wait(&full[s], (u / STAGES) & 1);
      if (i0 < whi && i0 + 64 > wlo) {
        const uint32_t q_addr = smem_u32(ring + s * 2 * TILE);
        const uint32_t do_addr = q_addr + TILE;
        const float* lse2 = vecs + s * 128;
        const float* dl = lse2 + 64;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows
        float st[32], dpt[32];
        score_pair<D>(st, dpt, k_addr, q_addr, v_addr, do_addr);
        // this thread's columns (query rows) are 8 g + 2 (lane & 3) + {0, 1}
        float2 rv[8];
#pragma unroll
        for (int g = 0; g < 8; ++g)
          rv[g] = *reinterpret_cast<const float2*>(lse2 + 8 * g +
                                                   2 * (lane & 3));
        wgmma_wait<1>();
        pin<32>(st);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          st[i] = ex2(st[i] * scale_log2 -
                      ((i & 1) ? rv[i >> 2].y : rv[i >> 2].x));
        if (!mask.all(i0, 64, kw, 64)) {    // a boundary crosses the tile
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            if (!mask.sees(i0 + col, key_a + 8 * ((i >> 1) & 1)))
              st[i] = 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < 8; ++g)
          rv[g] =
              *reinterpret_cast<const float2*>(dl + 8 * g + 2 * (lane & 3));
        wgmma_wait<0>();
        pin<32>(dpt);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dpt[i] =
              st[i] * (dpt[i] - ((i & 1) ? rv[i >> 2].y : rv[i >> 2].x));
        // dV += P^T dO with P^T rounded to bf16, then dK += dS^T Q with
        // dS^T rounded, packed while the first product runs (P^T and dS^T
        // in f32 are dead by then: at D = 128 dK and dV hold 128 registers)
        uint32_t pa[4][4], sa[4][4];
        to_frags(st, pa);
        acc_product<D>(av, pa, do_addr);
        to_frags(dpt, sa);
        acc_product<D>(ak, sa, q_addr);
        wgmma_wait<0>();
        hold(pa);
        hold(sa);
#pragma unroll
        for (int cc = 0; cc < T::SLABS; ++cc) {
          pin<T::DW / 2>(av[cc]);
          pin<T::DW / 2>(ak[cc]);
        }
      }
      mbar_arrive(&empty[s]);
    }

    cluster_barrier();
#pragma unroll
    for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
      for (int i = 0; i < T::DW / 2; i += 2) {
        const int r = 64 * cw + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = cc * T::DW + 8 * (i >> 2) + 2 * (lane & 3);
        const int qk = r / span, qv = (ROWS + r) / span;
        store_remote(sums + (rank * span + r - qk * span) * PITCH + col, qk,
                     ak[cc][i], ak[cc][i + 1]);
        store_remote(
            sums + (rank * span + ROWS + r - qv * span) * PITCH + col, qv,
            av[cc][i], av[cc][i + 1]);
      }
  }
  cluster_barrier();
  constexpr int Q4 = D / 4;
  const int n = min(span, 2 * ROWS - rank * span) * Q4;
  for (int e = tid - 128; e < n; e += T::CW * 128) {
    const int rr = e / Q4, c4 = e % Q4;
    const float* at = sums + rr * PITCH + 4 * c4;
    float4 sum = *reinterpret_cast<const float4*>(at);
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < c) {
        const float4 x =
            *reinterpret_cast<const float4*>(at + q * span * PITCH);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
    const int R = rank * span + rr, which = R >= ROWS;
    const int j = k0 + R - which * ROWS;
    if (j < Skv) {
      const float m = which ? 1.0f : scale;
      uint2 out;
      out.x = pack(sum.x * m, sum.y * m);
      out.y = pack(sum.z * m, sum.w * m);
      *reinterpret_cast<uint2*>((which ? dv : dk) +
                                (((long long)b * Skv + j) * Hkv + hk) * D +
                                4 * c4) = out;
    }
  }
}


// (c) dQ.  Grid (Hq, B, query tiles of ROWS), the last tile first.
template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, Tile<D>::BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const bf16* __restrict__ out,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, int Hq, int Hkv,
                          Mask mask, float scale) {
  using T = Tile<D>;
  constexpr int NW = T::NW, TILE = T::TILE, ROWS = T::ROWS, W = T::W,
                STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res = smem;                            // [NW][Q, dO][TILE]
  uint8_t* ring = smem + NW * 2 * TILE;           // [STAGES][K, V][TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::DATA);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int hk = h / (Hq / Hkv);
  const int Sq = mask.Sq;
  int lo, hi;
  mask.keys(q0, min(q0 + ROWS, Sq), &lo, &hi);
  const int j_lo = lo / 64 * 64;
  const int n_steps = hi > lo ? (hi - j_lo + 63) / 64 : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW * 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: Q, dO once, then key tile j_lo + 64 u into stage u %
    // STAGES
    if constexpr (T::DQ_MOVES_REGS) regs_down<T::PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(q_bar, NW * 2 * TILE);
      for (int w = 0; w < NW; ++w) {
        tma_tile<D>(res + w * 2 * TILE, &tq, q_bar, h, q0 + 64 * w, b);
        tma_tile<D>(res + w * 2 * TILE + TILE, &tdo, q_bar, h, q0 + 64 * w,
                    b);
      }
      for (int u = 0; u < n_steps; ++u) {
        const int s = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[s], (u / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE);
        tma_tile<D>(ring + s * 2 * TILE, &tk, &full[s], hk, j_lo + 64 * u, b);
        tma_tile<D>(ring + s * 2 * TILE + TILE, &tv, &full[s], hk,
                    j_lo + 64 * u, b);
      }
    }
    return;
  }

  if constexpr (T::DQ_MOVES_REGS) regs_up<T::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int w0 = q0 + 64 * cw;          // this warpgroup's rows w0..w0+63
  const bool live = w0 < Sq;
  int wlo = 0, whi = 0;
  if (live) mask.keys(w0, min(w0 + 64, Sq), &wlo, &whi);
  // accumulator element i sits at row r_a + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  const int r_a = w0 + 16 * warp + lane / 4;
  const float scale_log2 = scale * kLog2e;
  // each row's delta = rowsum(dO * O) by the four threads of its quad,
  // 16 bytes a load, while the producer's first tiles are in flight; the
  // dK/dV kernel, launched after this one, reads it
  constexpr int CH = (D / 8 + 3) / 4;   // 16-byte chunks a thread a row
  uint4 xo[2][CH], xd[2][CH];           // every load issued before any use
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int r = r_a + 8 * rr, ch = (lane & 3) + 4 * k;
      const long long el = (((long long)b * Sq + r) * Hq + h) * D + 8 * ch;
      const bool ok = r < Sq && ch < D / 8;
      xo[rr][k] = ok ? *reinterpret_cast<const uint4*>(out + el) : uint4{};
      xd[rr][k] = ok ? *reinterpret_cast<const uint4*>(dout + el) : uint4{};
    }
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r_a + 8 * rr;
    const long long at = ((long long)b * Hq + h) * Sq + (r < Sq ? r : 0);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const bf16* xs = reinterpret_cast<const bf16*>(&xo[rr][k]);
      const bf16* ys = reinterpret_cast<const bf16*>(&xd[rr][k]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc = fmaf(__bfloat162float(xs[i]), __bfloat162float(ys[i]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[rr] = acc;
    if ((lane & 3) == 0 && r < Sq) delta[at] = acc;
    lse2[rr] = r < Sq ? lse[at] * kLog2e : 0.0f;
  }
  float aq[T::SLABS][T::DW / 2];
#pragma unroll
  for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
    for (int i = 0; i < T::DW / 2; ++i) aq[cc][i] = 0.0f;
  const uint32_t q_addr = smem_u32(res + cw * 2 * TILE);
  const uint32_t do_addr = q_addr + TILE;
  mbar_wait(q_bar, 0);

  for (int u = 0; u < n_steps; ++u) {
    const int s = u % STAGES;
    const int j0 = j_lo + 64 * u;
    mbar_wait(&full[s], (u / STAGES) & 1);
    if (j0 < whi && j0 + 64 > wlo) {
      const uint32_t k_addr = smem_u32(ring + s * 2 * TILE);
      const uint32_t v_addr = k_addr + TILE;
      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
      float st[32], dp[32];
      score_pair<D>(st, dp, q_addr, k_addr, do_addr, v_addr);
      wgmma_wait<1>();
      pin<32>(st);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = ex2(st[i] * scale_log2 - lse2[(i >> 1) & 1]);
      if (!mask.all(w0, 64, j0, 64)) {      // a boundary crosses the tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (!mask.sees(r_a + 8 * ((i >> 1) & 1), key)) st[i] = 0.0f;
        }
      }
      wgmma_wait<0>();
      pin<32>(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = st[i] * (dp[i] - dl[(i >> 1) & 1]);
      // dQ += dS K, dS rounded to bf16
      uint32_t sa[4][4];
      to_frags(dp, sa);
      acc_product<D>(aq, sa, k_addr);
      wgmma_wait<0>();
      hold(sa);
#pragma unroll
      for (int cc = 0; cc < T::SLABS; ++cc) pin<T::DW / 2>(aq[cc]);
    }
    mbar_arrive(&empty[s]);
  }
  if (!live) return;

  // epilogue: dQ times the scale as bf16 into this warpgroup's Q buffer,
  // swizzled as the tensor map expects, then one TMA store per slab (rows
  // past Sq are clipped)
  uint8_t* o_s = res + cw * 2 * TILE;
#pragma unroll
  for (int cc = 0; cc < T::SLABS; ++cc)
#pragma unroll
    for (int i = 0; i < T::DW / 2; i += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      int off = row * W + col * 2;
      off ^= ((off >> 7) & (W / 16 - 1)) << 4;
      *reinterpret_cast<uint32_t*>(o_s + cc * 64 * W + off) =
          pack(aq[cc][i] * scale, aq[cc][i + 1] * scale);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_sync(1 + cw, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int cc = 0; cc < T::SLABS; ++cc)
      tma_store(&tdq, o_s + cc * 64 * W, cc * T::DW, h, w0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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
  const void *q, *k, *v, *out, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, Sq, Skv, Hq, Hkv;
  Mask mask;
  float scale;
  int cluster;
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

// the 4-D map of a contiguous bf16 (B, S, H, D) tensor, boxes of 64 rows of
// one head and one slab of dims, swizzled for wgmma
template <int D>
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                int S, int H) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::DW, 1, 64, 1};
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
cudaError_t dkdv_bf16(const Args& a) {
  using T = Tile<D>;
  if (a.Sq == 0) {                      // no row: the gradients are 0
    const size_t n = (size_t)a.B * a.Skv * a.Hkv * D * 2;
    const cudaError_t e = cudaMemsetAsync(a.dk, 0, n, a.stream);
    return e != cudaSuccess ? e : cudaMemsetAsync(a.dv, 0, n, a.stream);
  }
  const int G = a.Hq / a.Hkv, c = a.cluster;
  if (c < 1 || c > kMaxCluster || c > G) return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map<D>(enc, &tq, a.q, a.B, a.Sq, a.Hq) ||
      !tensor_map<D>(enc, &tk, a.k, a.B, a.Skv, a.Hkv) ||
      !tensor_map<D>(enc, &tv, a.v, a.B, a.Skv, a.Hkv) ||
      !tensor_map<D>(enc, &tdo, a.dout, a.B, a.Sq, a.Hq))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::DKDV_SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(a.Hkv * c, a.B, (a.Skv + T::ROWS - 1) / T::ROWS);
  cfg.blockDim = dim3(T::DKDV_THREADS);
  cfg.dynamicSmemBytes = T::DKDV_SMEM;
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma_kernel<D>, tq, tk, tv,
                         tdo, (const float*)a.lse, (const float*)a.delta,
                         (bf16*)a.dk, (bf16*)a.dv, a.Skv, a.Hq, a.Hkv,
                         a.mask, a.scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const Args& a) {
  using T = Tile<D>;
  if (a.Skv == 0)                       // no key: dq is 0
    return cudaMemsetAsync(a.dq, 0, (size_t)a.B * a.Sq * a.Hq * D * 2,
                           a.stream);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!tensor_map<D>(enc, &tq, a.q, a.B, a.Sq, a.Hq) ||
      !tensor_map<D>(enc, &tk, a.k, a.B, a.Skv, a.Hkv) ||
      !tensor_map<D>(enc, &tv, a.v, a.B, a.Skv, a.Hkv) ||
      !tensor_map<D>(enc, &tdo, a.dout, a.B, a.Sq, a.Hq) ||
      !tensor_map<D>(enc, &tdq, a.dq, a.B, a.Sq, a.Hq))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::DQ_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.Hq, a.B, (a.Sq + T::ROWS - 1) / T::ROWS);
  flash_bwd_dq_wgmma_kernel<D><<<grid, T::THREADS, T::DQ_SMEM, a.stream>>>(
      tq, tk, tv, tdo, tdq, (const bf16*)a.out, (const bf16*)a.dout,
      (const float*)a.lse, (float*)a.delta, a.Hq, a.Hkv, a.mask, a.scale);
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
    case 256:
      return launch<256>(which, dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t delta_launch(int D, const float* o, const float* dout,
                         float* delta, int B, int Sq, int Hq,
                         cudaStream_t s) {
  const long long warps = (long long)B * Hq * ((Sq + 31) / 32);
  const unsigned blocks = (unsigned)((warps + 7) / 8);
#define DELTA_CASE(DD)                                                   \
  case DD:                                                               \
    flash_bwd_delta_kernel<DD><<<blocks, 256, 0, s>>>(o, dout, delta, B, \
                                                      Sq, Hq);           \
    return cudaGetLastError();
  switch (D) {
    DELTA_CASE(16)
    DELTA_CASE(32)
    DELTA_CASE(64)
    DELTA_CASE(128)
    DELTA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DELTA_CASE
}

}  // namespace

// delta (B, Hq, Sq) f32 = sum_d dO * O, o and dout (B, Sq, Hq, D)
// contiguous and 16-byte aligned, float32 (dtype 0: the bf16 route's dq
// launch computes delta itself), D in {16, 32, 64, 128, 256}.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_delta(const void* o, const void* dout,
                                         float* delta, int B, int Sq, int Hq,
                                         int D, int dtype, void* stream) {
  if ((long long)B * Sq * Hq == 0) return 0;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(delta_launch(
      D, static_cast<const float*>(o), static_cast<const float*>(dout), delta,
      B, Sq, Hq, static_cast<cudaStream_t>(stream)));
}

// q, out, dout, dq: (B, Sq, Hq, D); k, v, dk, dv: (B, Skv, Hkv, D); lse,
// delta: (B, Hq, Sq) f32; all contiguous, 16-byte aligned, one dtype (0
// float32: CUDA cores, 1 bfloat16: tensor cores); D in {16, 32, 64, 128,
// 256};
// Hq % Hkv == 0; kv_len <= Skv.  which = 1 writes dk and dv (dq may be
// null), which = 2 writes dq (dk, dv may be null); every element of what it
// writes, the keys at kv_len and past as zeros.  delta: in float32 written
// by flash_attention_bwd_delta before both launches; in bfloat16 the dq
// launch (which = 2, first) writes it and the dk/dv launch reads it.
// cluster: the blocks of the bf16 dK/dV kernel that share a KV head's sum,
// 1 <= cluster <= min(Hq / Hkv, 8) (the f32 route ignores it).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd(int which, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int kv_len,
                                   int offset, int causal, int window,
                                   float scale, int dtype, int cluster,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  out, dout, lse, delta, dq,
               dk, dv, B,  Sq,  Skv,  Hq,  Hkv,
               Mask{Sq, kv_len, offset, causal, window},
               scale, cluster, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(which, D, dtype, a));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
