// The RWKV6 time mix's WKV recurrence, one layer's sequence in one launch,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// lax.scan over tokens (repro/nn/blocks.py::rwkv_time_mix_seq, its step).
// Per (batch row b, head h) the state s is an (HD, HD) f32 matrix, row i on
// the key axis and column j on the value axis; each step t:
//
//   kv_ij = k_i v_j
//   out_j = sum_i r_i (s_ij + u_i kv_ij)      (the state before step t)
//         = sum_i r_i s_ij + v_j a_t,  a_t = sum_i r_i u_i k_i
//   s_ij  = w_i s_ij + kv_ij
//
// r, k, v: (B, S, H, HD), all f32 or all bf16, as the projections give
// them (bf16 to f32 is exact, so the state does not depend on which);
// w, y: (B, S, H, HD) f32; u: (H, HD) f32; s0, sS: (B, H, HD, HD) f32; all
// contiguous and 16-byte aligned.
//
// Bound: FP32 issue slots at prefill and loss shapes, bytes at decode.
// The final state must equal the plain version's bit for bit, so the
// update stays unfused, __fadd_rn(__fmul_rn(w_i, s_ij), __fmul_rn(k_i,
// v_j)): three FP32 instructions a state entry a step, each a whole issue
// slot, and the output one FFMA: four slots a state entry a step.  An
// H100 SXM issues 132 SMs x 128 lanes x its clock of them, 33.5e12 a
// second at 1.98 GHz (half of the 67 TFLOP/s data-sheet rate, which counts
// an FMA as two): 160 us at (8, 1024, 40, 64), 105 us at (4, 1345, 40,
// 64), against 91 / 59 us for the bytes with bf16 r, k, v.  At decode (S =
// 1) the state, read and written once, is the time: 1.6 us at (4, 1, 40,
// 64).  So every instruction that is not one of the four is overhead, and
// every multiprocessor's four schedulers must be kept full.
//
// Design.  A (b, h) chain is HD independent column chains (column j needs
// r, k, w and v_j only), so the grid is (column block, h, b), NCB = HD / CB
// blocks a chain: 320 blocks of 5 warps at the serving batch (4, 40 heads
// of 64), 640 at the loss's (8).
//  * Consumers: W warps.  P = HD / 4 lanes split a column group's key axis
//    and each thread keeps R = 4 rows of C = 4 columns in registers (16
//    entries), so one 16-byte shared load each of r, k and w serves 16
//    entries; its rows are 4 p .. 4 p + 3, so the P lanes' loads fall on
//    distinct banks and the other groups' are broadcasts.  No block-wide
//    barrier a step.
//  * Reduction: a group of U = 4 steps' partial outputs meet over the P
//    lanes with __shfl_xor_sync after the group: exchanges that halve the
//    columns a lane holds (a lane holds its C columns in the order that
//    makes each a plain add: it sends the upper half, which its partner
//    keeps), then exchanges that halve the steps it holds, so each lane
//    ends with its column's outputs of U / (P / C) steps (one step and an
//    all-reduce where P / C > U).  The exchanges of U steps are
//    independent, so their latency overlaps (reducing each step alone took
//    427 / 324 us against 392 / 302 at the loss / prefill shapes, with two
//    columns a thread; experiments/wkv6_variants.py on an NVIDIA H100 80GB
//    HBM3 at 700 W).
//  * A producer warp keeps a ring of NS stages, each T steps: one TMA box
//    each of r, k, w (HD wide) and of the block's v columns (CB wide) from
//    4-D tensor maps over (HD, H, S, B), boxes (HD or CB, 1, T, 1), so the
//    part past S lands as zeros; a stage completes on its `full` mbarrier.
//    The warp then computes a_t for the chunk (the bonus term folded into
//    one scalar a step, added once a column after the reduction) and, for
//    bf16 inputs, converts r, k and v into the stage's f32 arrays (once a
//    block, not once a thread), and releases the stage on `ready`.
//    Consumers wait once a chunk, and release the stage on `done` after
//    writing the chunk's y into the stage; the producer then stores that y
//    as one TMA box (rows past S are not written) and refills the stage.
//  * The step route (decode, S = 1; kernels/wkv6.py::route): one block of
//    HD threads a chain, a thread a state column, the state read and
//    written a whole row at a time, a step's inputs straight from device
//    memory: for one step, one round trip and one barrier, where the
//    ring's load, hand-off and store would be the whole time.
//  * P, C, CB, T, NS and U are Tiling<HD>, a compile-time function of HD,
//    mirrored by kernels/wkv6.py::tiling and reported by wkv6_tiling().
//    experiments/wkv6_variants.py times the alternatives.
//
// Shared-memory budget: NS = 2 stages of T = 16 steps.  At HD = 64 a stage
// is 21,632 bytes with bf16 inputs (f32 r, k, w, v, y and a: 16,512; the
// bf16 landing boxes: 5,120), 43,392 bytes a block with the barriers, so
// the five blocks an SM must hold at the loss's batch (640 blocks on 132
// SMs; three at the serving batch) fit in its 228 KB (with 1 KB reserved a
// block); f32 inputs need 33,152 bytes.  HD = 128: 76,160 bytes (bf16),
// two blocks.
//
// Predicted for the first design (two columns a thread, a reduction a
// step, NS = 3; NVIDIA H100 80GB HBM3, 700 W; written before the first
// run): ~82 instructions a thread a step at HD = 64, 64 of them the four
// slots; at the serving batch three consumer warps share a scheduler on
// the SMs that hold three blocks, so 180-300 us at (4, 1345, 40, 64),
// 220-350 us at (8, 1024, 40, 64) and 2.5-4.5 us at decode (4, 1).  The
// times measured are in PERF.md (row 10).

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HD>
struct Tiling {
  static constexpr int R = 4;              // key rows a thread, 4 | R
  static constexpr int P = HD / R;         // lanes a column group
  static constexpr int C = HD == 16 ? 2 : 4;   // columns a thread
  static constexpr int G = 32 / P;         // column groups a warp
  static constexpr int CB = HD == 16 ? 16 : 32;   // columns a block
  static constexpr int W = CB / (C * G);   // consumer warps
  static constexpr int NCB = HD / CB;      // blocks a chain
  static constexpr int T = 16;             // steps a stage
  static constexpr int NS = 2;             // stages in the ring
  static constexpr int U = 4;              // steps a consumer reduces
                                           // together
  static constexpr int THREADS = 32 * (W + 1);
  static constexpr int MINB = HD == 16 ? 8 : HD == 32 ? 4 : HD == 64 ? 4 : 2;
  // a stage, in bytes from its start: f32 r, k, w (T, HD); v, y (T, CB);
  // a (T), padded to 128; then the bf16 landing boxes of r, k (T, HD) and
  // v (T, CB)
  static constexpr int OFF_K = 4 * T * HD;
  static constexpr int OFF_W = 8 * T * HD;
  static constexpr int OFF_V = 12 * T * HD;
  static constexpr int OFF_Y = OFF_V + 4 * T * CB;
  static constexpr int OFF_A = OFF_Y + 4 * T * CB;
  static constexpr int OFF_RH = OFF_A + 128;
  static constexpr int OFF_KH = OFF_RH + 2 * T * HD;
  static constexpr int OFF_VH = OFF_KH + 2 * T * HD;
  static constexpr int BARS = 128;         // the 3 NS mbarriers, padded
  __host__ __device__ static constexpr int stage(bool bf16) {
    return bf16 ? OFF_VH + 2 * T * CB : OFF_RH;
  }
  __host__ __device__ static constexpr int smem(bool bf16) {
    return BARS + NS * stage(bf16);
  }
  static_assert(R % 4 == 0 && P * G == 32 && W * C * G == CB &&
                    HD % CB == 0 && (C == 2 || C == 4 || C == 8) &&
                    P >= C,
                "tiling");
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

// a box of a (HD, H, S, B) tensor map at (c0, h, t, b), completed on `bar`;
// the box's part past S lands as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// the box at `src` into a (HD, H, S, B) tensor map at (c0, h, t, b), in
// this thread's bulk group; the box's part past S is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int h,
                                          int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// eight bf16 (one 16-byte word, element 2n in the low half of word n) to
// f32, exactly
__device__ __forceinline__ void unpack8(uint4 x, float* f) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    f[2 * n] = __uint_as_float(w[n] << 16);
    f[2 * n + 1] = __uint_as_float(w[n] & 0xffff0000u);
  }
}

__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// a consumer thread's lanes: lane (g, p) of warp `warp` holds rows
// 4 (p + P m) + e and the block's columns base + (c ^ X), c < C, where
// base = (warp G + g) C and X = p / (P / C): the order in which each
// exchange of `reduce` is a plain add
template <int HD>
struct Lane {
  using K = Tiling<HD>;
  int p, x, base;
  __device__ Lane(int warp, int lane)
      : p(lane % K::P), x(lane % K::P / (K::P / K::C)),
        base((warp * K::G + lane / K::P) * K::C) {}
  __device__ int row(int m, int e) const { return 4 * (p + K::P * m) + e; }
  __device__ int col(int c) const { return base + (c ^ x); }
  // the lane that writes column col(0)'s output
  __device__ bool writer() const { return p % (K::P / K::C) == 0; }
};

// one step's update of a thread's rows and columns from r, k, w of its
// rows and v of its columns: the partial outputs o_c = sum over its rows
// of r_i s_ic (the state before the step), then s_ic = w_i s_ic + k_i v_c
// in the plain version's two rounded products and one rounded add
template <int HD>
__device__ __forceinline__ void update(
    const float4 (&r4)[Tiling<HD>::R / 4],
    const float4 (&k4)[Tiling<HD>::R / 4],
    const float4 (&w4)[Tiling<HD>::R / 4], const float (&v)[Tiling<HD>::C],
    float (&s)[Tiling<HD>::R][Tiling<HD>::C], float (&o)[Tiling<HD>::C]) {
  using K = Tiling<HD>;
#pragma unroll
  for (int c = 0; c < K::C; ++c) o[c] = 0.0f;
#pragma unroll
  for (int m = 0; m < K::R / 4; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * m + e;
      const float ri = comp(r4[m], e), ki = comp(k4[m], e),
                  wi = comp(w4[m], e);
#pragma unroll
      for (int c = 0; c < K::C; ++c) {
        o[c] = fmaf(ri, s[x][c], o[c]);
        s[x][c] = __fadd_rn(__fmul_rn(wi, s[x][c]), __fmul_rn(ki, v[c]));
      }
    }
  }
}

// the P lanes' partial outputs added: first exchanges that halve a lane's
// columns (it sends the upper half and keeps the lower, which its partner
// holds in the swapped order), then an all-reduce of the one left; returns
// the whole sum of column col(0)
template <int HD>
__device__ __forceinline__ float reduce(float (&o)[Tiling<HD>::C]) {
  using K = Tiling<HD>;
#pragma unroll
  for (int k = K::C / 2, off = K::P / 2; k >= 1; k /= 2, off /= 2) {
#pragma unroll
    for (int n = 0; n < k; ++n)
      o[n] += __shfl_xor_sync(0xffffffffu, o[n + k], off);
  }
#pragma unroll
  for (int off = K::P / (2 * K::C); off > 0; off >>= 1)
    o[0] += __shfl_xor_sync(0xffffffffu, o[0], off);
  return o[0];
}

// a ring consumer's inputs of step t from stage `st`: r, k, w of its rows
// and v of its columns
template <int HD>
__device__ __forceinline__ void load_step(
    const unsigned char* st, int t, const Lane<HD>& ln,
    float4 (&r4)[Tiling<HD>::R / 4], float4 (&k4)[Tiling<HD>::R / 4],
    float4 (&w4)[Tiling<HD>::R / 4], float (&v)[Tiling<HD>::C]) {
  using K = Tiling<HD>;
  const int at = t * HD + 4 * ln.p;
#pragma unroll
  for (int m = 0; m < K::R / 4; ++m) {
    const int i = at + 4 * K::P * m;
    r4[m] = reinterpret_cast<const float4*>(st)[i / 4];
    k4[m] = reinterpret_cast<const float4*>(st + K::OFF_K)[i / 4];
    w4[m] = reinterpret_cast<const float4*>(st + K::OFF_W)[i / 4];
  }
  const float* vt = reinterpret_cast<const float*>(st + K::OFF_V) + t * K::CB;
#pragma unroll
  for (int c = 0; c < K::C; ++c) v[c] = vt[ln.col(c)];
}

// one step of a ring consumer, its inputs from stage `st`: the output of
// col(0) into *yt if the lane writes it
template <int HD>
__device__ __forceinline__ void step(const unsigned char* st, int t,
                                     const Lane<HD>& ln,
                                     float (&s)[Tiling<HD>::R][Tiling<HD>::C],
                                     float* yt) {
  using K = Tiling<HD>;
  float4 r4[K::R / 4], k4[K::R / 4], w4[K::R / 4];
  float v[K::C], o[K::C];
  load_step<HD>(st, t, ln, r4, k4, w4, v);
  update<HD>(r4, k4, w4, v, s, o);
  const float out = reduce<HD>(o);
  if (ln.writer()) {
    const float a = reinterpret_cast<const float*>(st + K::OFF_A)[t];
    *yt = fmaf(v[0], a, out);
  }
}

// U steps of a ring consumer from step t0 of stage `st`, their partial
// outputs reduced together: the column exchanges of `reduce` for every
// step, then exchanges that halve the steps a lane holds (the lanes that
// share a column are left with U / L steps each, L = P / C, or one step
// and an all-reduce of the rest).  The lane then adds v a_t and writes
// the outputs of the steps it holds into the stage's y.
template <int HD>
__device__ __forceinline__ void group(const unsigned char* st, int t0,
                                      const Lane<HD>& ln,
                                      float (&s)[Tiling<HD>::R][Tiling<HD>::C],
                                      float* y0) {
  using K = Tiling<HD>;
  constexpr int P = K::P, R = K::R, C = K::C, CB = K::CB, U = K::U;
  constexpr int L = P / C;                  // lanes that share col(0)
  float o[U][C];
#pragma unroll
  for (int x = 0; x < U; ++x) {
    float4 r4[R / 4], k4[R / 4], w4[R / 4];
    float v[C];
    load_step<HD>(st, t0 + x, ln, r4, k4, w4, v);
    update<HD>(r4, k4, w4, v, s, o[x]);
  }
#pragma unroll
  for (int k = C / 2, off = P / 2; k >= 1; k /= 2, off /= 2)
#pragma unroll
    for (int x = 0; x < U; ++x)
#pragma unroll
      for (int n = 0; n < k; ++n)
        o[x][n] += __shfl_xor_sync(0xffffffffu, o[x][n + k], off);
  const int q = ln.p % L;
#pragma unroll
  for (int off = L / 2, held = U; off > 0; off >>= 1) {
    if (held > 1) {                         // keep the upper half if set
      const bool up = (q & off) != 0;
      held /= 2;
#pragma unroll
      for (int n = 0; n < held; ++n) {
        const float send = up ? o[n][0] : o[n + held][0];
        const float keep = up ? o[n + held][0] : o[n][0];
        o[n][0] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
      o[0][0] += __shfl_xor_sync(0xffffffffu, o[0][0], off);
    }
  }
  constexpr int HELD = U >= L ? U / L : 1;   // steps a lane ends with
  constexpr int SHARE = U >= L ? 1 : L / U;  // lanes that end with each
  if (q % SHARE == 0) {
    const float* vt = reinterpret_cast<const float*>(st + K::OFF_V);
    const float* at = reinterpret_cast<const float*>(st + K::OFF_A);
#pragma unroll
    for (int n = 0; n < HELD; ++n) {
      const int t = t0 + q / SHARE * HELD + n;
      y0[t * CB] = fmaf(vt[t * CB + ln.col(0)], at[t], o[n][0]);
    }
  }
}

template <int HD, bool BF16>
__global__ void __launch_bounds__(Tiling<HD>::THREADS, Tiling<HD>::MINB)
wkv6_kernel(const __grid_constant__ CUtensorMap tr,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap ty,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ sS, int S, int H) {
  using K = Tiling<HD>;
  constexpr int T = K::T, NS = K::NS, CB = K::CB, U = K::U;
  constexpr int STAGE = K::stage(BF16);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = full + NS;
  uint64_t* done = ready + NS;
  unsigned char* ring = smem + K::BARS;
  const int cb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = (S + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 32);
      mbar_init(&done[s], 32 * K::W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();


  if (warp == K::W) {                                   // the producer
    constexpr int Q = HD / 8;      // 8-key groups a row
    constexpr int RP = 32 / Q;     // rows a pass
    const int q = lane % Q;
    float uq[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) uq[e] = u[h * HD + 8 * q + e];
    constexpr uint32_t kBytes =
        (BF16 ? 2 : 4) * T * (2 * HD + CB) + 4 * T * HD;
    auto issue = [&](int c) {
      const int s = c % NS;
      unsigned char* st = ring + s * STAGE;
      mbar_expect_tx(&full[s], kBytes);
      tma_load(st + (BF16 ? K::OFF_RH : 0), &tr, &full[s], 0, h, c * T, b);
      tma_load(st + (BF16 ? K::OFF_KH : K::OFF_K), &tk, &full[s], 0, h,
               c * T, b);
      tma_load(st + (BF16 ? K::OFF_VH : K::OFF_V), &tv, &full[s], cb * CB, h,
               c * T, b);
      tma_load(st + K::OFF_W, &tw, &full[s], 0, h, c * T, b);
    };
    if (lane == 0)
      for (int c = 0; c < min(NS, n); ++c) issue(c);
    for (int c = 0; c < n; ++c) {
      const int s = c % NS;
      unsigned char* st = ring + s * STAGE;
      float* rf = reinterpret_cast<float*>(st);
      float* kf = reinterpret_cast<float*>(st + K::OFF_K);
      mbar_wait(&full[s], (c / NS) & 1);
      // a_t, and the bf16 boxes to f32, for the chunk's rows: lane (row, q)
      // takes keys 8q..8q+7 of rows lane / Q, + RP, ... (a pass past the
      // last row reads it again)
      const int rows = min(T, S - c * T);
      for (int t0 = 0; t0 < rows; t0 += RP) {
        const int t = min(t0 + lane / Q, rows - 1);
        const int at = t * HD + 8 * q;
        float rr[8], kk[8];
        if constexpr (BF16) {
          unpack8(*reinterpret_cast<const uint4*>(st + K::OFF_RH + 2 * at),
                  rr);
          unpack8(*reinterpret_cast<const uint4*>(st + K::OFF_KH + 2 * at),
                  kk);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            reinterpret_cast<float4*>(rf + at)[x] = make_float4(
                rr[4 * x], rr[4 * x + 1], rr[4 * x + 2], rr[4 * x + 3]);
            reinterpret_cast<float4*>(kf + at)[x] = make_float4(
                kk[4 * x], kk[4 * x + 1], kk[4 * x + 2], kk[4 * x + 3]);
          }
        } else {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float4 r4 = reinterpret_cast<const float4*>(rf + at)[x];
            const float4 k4 = reinterpret_cast<const float4*>(kf + at)[x];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              rr[4 * x + e] = comp(r4, e);
              kk[4 * x + e] = comp(k4, e);
            }
          }
        }
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(rr[e] * uq[e], kk[e], part);
#pragma unroll
        for (int off = Q / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (q == 0 && t0 + lane / Q < rows)
          reinterpret_cast<float*>(st + K::OFF_A)[t] = part;
      }
      if constexpr (BF16) {
        float* vf = reinterpret_cast<float*>(st + K::OFF_V);
        for (int x = lane; x < rows * CB / 8; x += 32) {
          float vv[8];
          unpack8(reinterpret_cast<const uint4*>(st + K::OFF_VH)[x], vv);
          reinterpret_cast<float4*>(vf)[2 * x] =
              make_float4(vv[0], vv[1], vv[2], vv[3]);
          reinterpret_cast<float4*>(vf)[2 * x + 1] =
              make_float4(vv[4], vv[5], vv[6], vv[7]);
        }
      }
      // the stage's y tile is free once chunk c - NS's store has read it;
      // stores of chunks c - NS + 1 .. c - 2 may still be reading
      if (lane == 0 && c >= NS)
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(NS - 2)
                     : "memory");
      mbar_arrive(&ready[s]);
      if (lane == 0 && c >= 1) {   // chunk c - 1's y out, its stage refilled
        const int cp = c - 1, sp = cp % NS;
        mbar_wait(&done[sp], (cp / NS) & 1);
        tma_store(&ty, ring + sp * STAGE + K::OFF_Y, cb * CB, h, cp * T, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        if (cp + NS < n) issue(cp + NS);
      }
    }
    if (lane == 0) {
      const int cp = n - 1, sp = cp % NS;
      mbar_wait(&done[sp], (cp / NS) & 1);
      tma_store(&ty, ring + sp * STAGE + K::OFF_Y, cb * CB, h, cp * T, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    return;
  }

  // a consumer
  constexpr int R = K::R, C = K::C;
  const Lane<HD> ln(warp, lane);
  const size_t chain = (static_cast<size_t>(b) * H + h) * HD * HD + cb * CB;
  float s[R][C];
#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < C; ++c)
        s[4 * m + e][c] = s0[chain + ln.row(m, e) * HD + ln.col(c)];
  for (int c = 0; c < n; ++c) {
    const int sc = c % NS, ph = (c / NS) & 1;
    const unsigned char* st = ring + sc * STAGE;
    mbar_wait(&full[sc], ph);
    mbar_wait(&ready[sc], ph);
    const int steps = min(T, S - c * T);
    float* yc = reinterpret_cast<float*>(ring + sc * STAGE + K::OFF_Y) +
                ln.col(0);
    if (steps == T) {
#pragma unroll 1
      for (int t = 0; t < T; t += U) group<HD>(st, t, ln, s, yc);
    } else {
#pragma unroll 1
      for (int t = 0; t < steps; ++t) step<HD>(st, t, ln, s, yc + t * CB);
    }
    // y is read by the async proxy (the TMA store) after `done`
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&done[sc]);
  }
#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < C; ++c)
        sS[chain + ln.row(m, e) * HD + ln.col(c)] = s[4 * m + e][c];
}

// element `at` of a contiguous f32 or bf16 array, as f32
template <bool BF16>
__device__ __forceinline__ float load1(const void* p, size_t at) {
  if constexpr (BF16)
    return __uint_as_float(
        static_cast<uint32_t>(static_cast<const uint16_t*>(p)[at]) << 16);
  else
    return static_cast<const float*>(p)[at];
}

// The step route (decode, S = 1; kernels/wkv6.py::route): one block of HD
// threads a (h, b) chain, thread j keeping column s[:, j] in registers,
// read and written a row at a time, whole rows coalesced, and a step's
// (r_i, k_i, w_i, u_i) shared through one barrier.  For one step this
// beats the ring consumers' layout run without the ring, whose lanes
// exchange partial sums and whose state needs a shared tile to coalesce:
// 3.47 / 3.49 against 4.06-4.41 us at (4, 1, 40, 64) with bf16 r, k, v
// (experiments/wkv6_variants.py; NVIDIA H100 80GB HBM3, 700 W).  The
// output adds r_i (s_ij + u_i kv_ij) in i order, the plain version's
// einsum in its own; the update is the ring's.  Any S is right, a
// barrier a step.
template <int HD, bool BF16>
__global__ void __launch_bounds__(HD, 1)
wkv6_step_kernel(const void* __restrict__ r, const void* __restrict__ k,
                 const void* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ sS, int S,
                 int H) {
  __shared__ float4 step_in[HD];           // (r_i, k_i, w_i, u_i)
  const int j = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const size_t chain = (static_cast<size_t>(b) * H + h) * HD * HD;
  const float uj = u[h * HD + j];
  size_t at = (static_cast<size_t>(b) * S * H + h) * HD + j;
  float rj = load1<BF16>(r, at), kj = load1<BF16>(k, at),
        vj = load1<BF16>(v, at), wj = w[at];
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[chain + i * HD + j];
  for (int t = 0; t < S; ++t) {
    if (t > 0) {
      at += static_cast<size_t>(H) * HD;
      rj = load1<BF16>(r, at), kj = load1<BF16>(k, at);
      vj = load1<BF16>(v, at), wj = w[at];
      __syncthreads();                     // step t - 1's reads are done
    }
    step_in[j] = make_float4(rj, kj, wj, uj);
    __syncthreads();
    float out = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float4 e = step_in[i];         // a broadcast
      const float kv = __fmul_rn(e.y, vj);
      out = fmaf(e.x, __fadd_rn(s[i], __fmul_rn(e.w, kv)), out);
      s[i] = __fadd_rn(__fmul_rn(e.z, s[i]), kv);
    }
    y[at] = out;
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sS[chain + i * HD + j] = s[i];
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

// the map of a contiguous (B, S, H, HD) tensor as (HD, H, S, B) in boxes of
// (width, 1, T, 1): reads past S are zeros, writes there are dropped
bool seq_map(EncodeTiled enc, CUtensorMap* map, bool bf16, const void* p,
             int B, int S, int H, int HD, int width, int T) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * es, (cuuint64_t)H * HD * es,
                                 (cuuint64_t)S * H * HD * es};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool BF16>
cudaError_t launch(int route, const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0, void* y,
                   float* sS, int B, int S, int H, cudaStream_t stream) {
  using K = Tiling<HD>;
  if (route == 1) {
    wkv6_step_kernel<HD, BF16><<<dim3(H, B), HD, 0, stream>>>(
        r, k, v, static_cast<const float*>(w), u, s0, static_cast<float*>(y),
        sS, S, H);
    return cudaGetLastError();
  }
  if (route != 0) return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (const cudaError_t ce = make_current(); ce != cudaSuccess) return ce;
  CUtensorMap tr, tk, tv, tw, ty;
  if (!seq_map(enc, &tr, BF16, r, B, S, H, HD, HD, K::T) ||
      !seq_map(enc, &tk, BF16, k, B, S, H, HD, HD, K::T) ||
      !seq_map(enc, &tv, BF16, v, B, S, H, HD, K::CB, K::T) ||
      !seq_map(enc, &tw, false, w, B, S, H, HD, HD, K::T) ||
      !seq_map(enc, &ty, false, y, B, S, H, HD, K::CB, K::T))
    return cudaErrorInvalidValue;
  static bool sized = false;     // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<HD, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::smem(BF16));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  wkv6_kernel<HD, BF16>
      <<<dim3(K::NCB, H, B), K::THREADS, K::smem(BF16), stream>>>(
          tr, tk, tv, tw, ty, u, s0, sS, S, H);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int route, bool bf16, const void* r, const void* k,
                     const void* v, const void* w, const float* u,
                     const float* s0, void* y, float* sS, int B, int S, int H,
                     cudaStream_t stream) {
  return bf16 ? launch<HD, true>(route, r, k, v, w, u, s0, y, sS, B, S, H,
                                 stream)
              : launch<HD, false>(route, r, k, v, w, u, s0, y, sS, B, S, H,
                                  stream);
}

template <int HD>
void report(int* out) {
  using K = Tiling<HD>;
  const int v[12] = {K::P, K::C, K::R, K::G, K::CB, K::W, K::NCB, K::T,
                     K::NS, K::THREADS, K::smem(false), K::smem(true)};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
}

}  // namespace

// r, k, v: (B, S, H, hd) f32 (bf16 = 0) or bf16 (bf16 = 1); w, y: f32 of
// the same shape; u (H, hd), s0 and sS (B, H, hd, hd) f32; contiguous,
// 16-byte aligned, on one device.  route: 0 the ring, 1 the step route
// (kernels/wkv6.py::route picks it).  Returns a cudaError_t.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u_, const void* s0_, void* y,
                    void* sS_, int B, int S, int H, int hd, int bf16,
                    int route, void* stream_) {
  const float* u = static_cast<const float*>(u_);
  const float* s0 = static_cast<const float*>(s0_);
  float* sS = static_cast<float*>(sS_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return dispatch<16>(route, bf16, r, k, v, w, u, s0, y, sS, B, S, H,
                             stream);
    case 32:
      return dispatch<32>(route, bf16, r, k, v, w, u, s0, y, sS, B, S, H,
                             stream);
    case 64:
      return dispatch<64>(route, bf16, r, k, v, w, u, s0, y, sS, B, S, H,
                             stream);
    case 128:
      return dispatch<128>(route, bf16, r, k, v, w, u, s0, y, sS, B, S, H,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Tiling<hd> into out[12]: P, C, R, G, CB, W, NCB, T, NS, threads, shared
// bytes with f32 and with bf16 r, k, v (the ring's).  Returns 0, or 1 for another hd.
extern "C" int wkv6_tiling(int hd, int* out) {
  switch (hd) {
    case 16: report<16>(out); return 0;
    case 32: report<32>(out); return 0;
    case 64: report<64>(out); return 0;
    case 128: report<128>(out); return 0;
    default: return 1;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
