// The gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu), one layer's
// sequence in one call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its lax.scan
// (repro/nn/blocks.py::rwkv_time_mix_seq) with XLA's autodiff.  The
// forward, per (batch row b, head h), with S_t the (HD, HD) f32 state after
// step t, row i on the key axis and column j on the value axis:
//
//   y_t[j]   = sum_i r_t[i] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//   S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
//
// With G_t = dL/dS_t (G_{S-1} = dsT, or zeros), c_t = dy_t . v_t and a_t =
// sum_i r u k, the gradient takes log w in w's place:
//
//   dr_t[i] = dr'_t[i] + u_i k_t[i] c_t,  dr'_t[i] = sum_j S_{t-1}[i,j] dy_t[j]
//   dk_t[i] = dk'_t[i] + r_t[i] u_i c_t,  dk'_t[i] = sum_j G_t[i,j] v_t[j]
//   dv_t[j] = sum_i G_t[i,j] k_t[i] + dy_t[j] a_t
//   du_i   += r_t[i] k_t[i] c_t                     (over b and t)
//   G_{t-1} = w_t[i] G_t[i,j] + r_t[i] dy_t[j]      (ds0 = G_{-1})
//   dlw_t[i] = w_t[i] dw_t[i] = P_t[i] - k_t[i] dk'_t[i],
//   P_{t-1}  = dlw_t + r_t dr'_t,  P_{S-1}[i] = sum_j dsT[i,j] S_{S-1}[i,j]
//
// The last two lines hold because w_t S_{t-1} = S_t - k_t v_t^T, with P_t =
// sum_j G_t[i,j] S_t[i,j]: the gradient of log w is a reverse running sum of
// the state parts of dr and dk, so no state is rebuilt and nothing divides
// by w (which comes near 0, and is 0 where exp(-exp(.)) underflows).
//
// r, k, v: (B, S, H, HD), all f32 or all bf16; w, dy: (B, S, H, HD) f32;
// u: (H, HD) f32; s0, dsT: (B, H, HD, HD) f32 (dsT may be null: zeros);
// all contiguous and 16-byte aligned.  dr, dk, dv, dlw: (B, S, H, HD) f32;
// du (H, HD); ds0.
//
// Bound: FP32 issue slots.  The two passes need 7 a state entry a step:
// pass A's state update fmaf(w, s, k v) 2 and dr' 1; pass B's G update
// fmaf(w, g, r dy) 2, dv 1 and dk' 1: 286.7 us at (8, 1024, 40, 64) on an
// H100 SXM (132 SMs x 128 lanes x 1.98 GHz), plus the scalars; bytes 192
// us (r, k, v bf16, w and dy read, four f32 outputs written once).  The
// design's own floor, each pass alone: pass A max(122 us of slots, ~102 us
// of bytes), pass B max(163, ~191, since it reads dr back): ~313 us.
//
// Design: two kernels in the shape of the forward's ring route
// (csrc/wkv6.cu), each a producer warp on a TMA mbarrier ring of NS stages
// of T steps (bf16 inputs converted to f32 once a block, the steps'
// scalars c_t and a_t computed once, the steps past S landing as zeros
// with w patched to 1 so that they leave the state, G and P unchanged),
// and consumer warps that hold a 4 x 4 tile of the state each, so a
// 16-byte shared load serves 16 entries, their lanes' sums added with
// __shfl_xor_sync once a group of U steps (the forward's exchanges).
//  * Pass A, forward in time (wkv6_bwd_a_kernel, grid (row block, h, b)):
//    walks S from s0 and writes dr = dr' + u k c.  dr' sums over columns,
//    so a block holds all columns of RB rows, and lanes split the columns.
//    At the end it writes P_{S-1} (when dsT is given).
//  * Pass B, backward in time (wkv6_bwd_b_kernel, grid (column block, h,
//    b)): G from dsT, the chunks in reverse.  Its dv is the forward's own
//    sum over rows (lanes split the rows); dk' sums over columns, so a
//    group's per-warp partials meet in shared memory after a barrier of
//    the consumers, and add in a fixed order.  Up to hd 64 a block holds a
//    chain's columns: a thread a (step, key) then writes dk, and the keys'
//    owners walk P back a group later, reading pass A's dr (dr' = dr - u k
//    c) and writing dlw.  At hd 128 (a chain's 16,384 state entries at 16
//    a thread would need 1,024 consumers and more registers than an SM
//    has) a chain is a cluster of four column blocks, each the owner of 32
//    keys: a block sends its columns' part of each key's dk' to the key's
//    owner through distributed shared memory (st.async, completing on the
//    owner's mbarrier), and the owner adds the four parts in rank order a
//    group later, while the next group runs, then writes dk and walks P
//    as above.  So dk' is complete inside the chain and nothing of it
//    goes through device memory.
//  * No atomics: du is a partial a (b, h) chain, added over b in order by
//    wkv6_bwd_sum_kernel, so repeats give the same bits.
//  * No checkpoints, no states in shared memory, several blocks an SM: at
//    hd 64 pass A 640 blocks of 5 warps, pass B 320 blocks of 9; at hd
//    128 stages of 8 steps, so that two pass B blocks share an SM.
//
// T, NS, U and the block sizes are Bwd<HD>, mirrored by
// kernels/wkv6.py::bwd_tiling and reported by wkv6_bwd_tiling();
// experiments/wkv6_bwd_variants.py times the alternatives.
//
// Predicted before its first run (NVIDIA H100 80GB HBM3, 700 W): pass A
// at ~2x its floor, pass B at 2-2.5x, 0.55-0.8 ms at (8, 1024, 40, 64).
// Measured (PERF.md row 10b): 0.98 ms bf16, pass A 351 us (2.9x), pass B
// 632 us (3.3x); the checkpointing design it replaces took 2.52 ms in the
// same call.  Pass B's 320 blocks fill 1.21 waves at two blocks an SM (89
// registers x 288 threads, 108 KB of shared memory): at 33 heads (264
// blocks, one wave) it takes 404 us, so the lone second wave costs ~140
// us; within a wave both passes issue well below the FP32 rate.  Smaller
// stages (T = 8), a third stage, other groups (U = 2, 8) and three pass B
// blocks an SM were all slower or no faster.  hd 128 at (8, 1024, 20,
// 128): 2.36 ms, pass B 1.66 ms (5.1x its floor), against 3.23 ms with
// one pass B block an SM and the checkpointing design's 4.77 ms in the
// same call.

#include <cuda.h>          // CUtensorMap and its enums; the encoder itself
                           // is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

template <int HD>
struct Bwd {
  static constexpr int T = HD == 128 ? 8 : 16;   // steps a stage
  static constexpr int NS = 2;             // stages in a ring
  static constexpr int U = 4;              // steps a group (one reduction)
  static constexpr int NB = 4;             // hd 128: buffers of the exchange
  static constexpr int BARS = 128;         // 3 NS + 2 NB mbarriers, padded
  // pass A: lanes split the columns, CA contiguous columns and RA rows a
  // thread (rows in the order that makes each exchange a plain add)
  static constexpr int CA = HD == 16 ? 2 : 4;
  static constexpr int PA = HD / CA;       // lanes a row group
  static constexpr int GA = 32 / PA;       // row groups a warp
  static constexpr int RA = 4;
  static constexpr int RB = HD <= 32 ? HD : 32;   // rows a block
  static constexpr int WA = RB / (RA * GA);       // consumer warps
  static constexpr int NRB = HD / RB;             // blocks a chain
  static constexpr int THREADS_A = 32 * (WA + 1);
  // a pass A stage, bytes: f32 k, w (T, RB); v, dy (T, HD); dr (T, RB);
  // c (T), padded; bf16 landing boxes of k (T, RB) and v (T, HD)
  static constexpr int A_K = 0;
  static constexpr int A_W = A_K + 4 * T * RB;
  static constexpr int A_V = A_W + 4 * T * RB;
  static constexpr int A_DY = A_V + 4 * T * HD;
  static constexpr int A_DR = A_DY + 4 * T * HD;
  static constexpr int A_C = A_DR + 4 * T * RB;
  static constexpr int A_KH = A_C + 128;
  static constexpr int A_VH = A_KH + 2 * T * RB;
  static constexpr int STAGE_A = A_VH + 2 * T * HD;
  static constexpr int SMEM_A = BARS + NS * STAGE_A;
  // pass B: lanes split the rows (4 a thread), CC columns a thread in the
  // order that makes each exchange a plain add
  static constexpr int PB = HD / 4;        // lanes a column group
  static constexpr int CC = HD == 16 ? 2 : 4;
  static constexpr int GB = 32 / PB;       // column groups a warp
  static constexpr int CB = HD == 128 ? 32 : HD;  // columns a block
  static constexpr int WB = CB / (CC * GB);       // consumer warps
  static constexpr int NCB = HD / CB;             // blocks a chain
  static constexpr int NT = 32 * WB;              // consumer threads
  static constexpr int SLOTS = WB * GB;           // dk' partials a key
  static constexpr int THREADS_B = NT + 32;
  // a pass B stage, bytes: f32 r, k, w, dr, v, dy (T, HD); dv (T, CB); a,
  // c (T each), padded; bf16 landing boxes of r, k, v (T, HD)
  static constexpr int B_R = 0;
  static constexpr int B_K = B_R + 4 * T * HD;
  static constexpr int B_W = B_K + 4 * T * HD;
  static constexpr int B_DR = B_W + 4 * T * HD;
  static constexpr int B_V = B_DR + 4 * T * HD;
  static constexpr int B_DY = B_V + 4 * T * HD;
  static constexpr int B_DV = B_DY + 4 * T * HD;
  static constexpr int B_A = B_DV + 4 * T * CB;
  static constexpr int B_RH = B_A + 128;
  static constexpr int B_KH = B_RH + 2 * T * HD;
  static constexpr int B_VH = B_KH + 2 * T * HD;
  static constexpr int STAGE_B = B_VH + 2 * T * HD;
  // after the ring: the dk' partials of two groups (U, SLOTS, HD) f32, the
  // walk's (k dk', r dr') of two groups (U, CB) float2, du's partials; at
  // hd 128 the exchange's NB buffers (U, NCB, CB) f32, the cluster's NCB
  // column blocks' dk' parts of the CB keys this block owns
  static constexpr int B_PB = BARS + NS * STAGE_B;
  static constexpr int B_WB = B_PB + 2 * 4 * U * SLOTS * HD;
  static constexpr int B_DU = B_WB + 2 * 8 * U * CB;
  static constexpr int B_XB = B_DU + 4 * NT;
  static constexpr int SMEM_B = B_XB + (NCB > 1 ? 4 * NB * U * NCB * CB : 0);
  static constexpr int READERS = U * CB;   // hd 128: the threads adding parts
  static constexpr int MINB_A = HD <= 32 ? 8 : HD == 64 ? 4 : 2;
  static constexpr int MINB_B = 2;   // at hd 128 with 8 steps a stage
  static_assert(RB % (RA * GA) == 0 && PA >= RA && PA * GA == 32 &&
                    PB >= CC && PB * GB == 32 && CB % (CC * GB) == 0 &&
                    NT % HD == 0 && T % U == 0 && T % (256 / HD) == 0 &&
                    8 * (3 * NS + 2 * NB) <= BARS,
                "tiling");
  static_assert(NCB == 1 || (CB % 32 == 0 && READERS <= NT && NCB <= 8),
                "the exchange: a warp's keys one owner, a part a reader");
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

// the consumers' own barrier (named barrier 1; the producer warp is not in
// it)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();                         // the .aligned form: whole warps
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// `p`'s offset in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// v to `addr` in a CTA of the cluster, its 4 bytes completed on that CTA's
// mbarrier at `bar`
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// an arrival on the mbarrier at `bar` in a CTA of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// mbar_wait for a phase that other CTAs of the cluster complete
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
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

// n bf16 at `src` (n a multiple of 8) to f32 at `dst`, by one warp
__device__ __forceinline__ void widen(const unsigned char* src, float* dst,
                                      int n, int lane) {
  for (int x = lane; x < n / 8; x += 32) {
    float f[8];
    unpack8(reinterpret_cast<const uint4*>(src)[x], f);
    reinterpret_cast<float4*>(dst)[2 * x] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[2 * x + 1] =
        make_float4(f[4], f[5], f[6], f[7]);
  }
}

// eight consecutive f32 at `p`
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The T steps' dots of one stage by one warp: c_t = dy_t . v_t and, with
// rows `r` (else a_t is not formed), a_t = sum_i r_i u_i k_i, rows of HD
// f32.  Lane (row, q) takes keys 8q .. 8q + 7, added in order, then over
// the HD / 8 lanes of the row: both passes use this, so their c_t agree
// bit for bit.
template <int HD>
__device__ __forceinline__ void step_dots(const float* dy, const float* v,
                                          const float* r, const float* k,
                                          const float (&uq)[8], float* c_out,
                                          float* a_out, int lane) {
  constexpr int Q = HD / 8, RP = 32 / Q, T = Bwd<HD>::T;
  const int q = lane % Q;
#pragma unroll 1
  for (int t0 = 0; t0 < T; t0 += RP) {
    const int t = t0 + lane / Q, at = t * HD + 8 * q;
    float yy[8], vv[8];
    load8(dy + at, yy);
    load8(v + at, vv);
    float pc = 0.0f, pa = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) pc = fmaf(yy[e], vv[e], pc);
    if (r != nullptr) {
      float rr[8], kk[8];
      load8(r + at, rr);
      load8(k + at, kk);
#pragma unroll
      for (int e = 0; e < 8; ++e) pa = fmaf(rr[e] * uq[e], kk[e], pa);
    }
#pragma unroll
    for (int off = Q / 2; off > 0; off >>= 1) {
      pc += __shfl_xor_sync(0xffffffffu, pc, off);
      pa += __shfl_xor_sync(0xffffffffu, pa, off);
    }
    if (q == 0) {
      c_out[t] = pc;
      if (r != nullptr) a_out[t] = pa;
    }
  }
}

// U steps' partial sums o[x][n] over P lanes (the forward's exchanges,
// csrc/wkv6.cu::group): exchanges that halve the X values a lane holds (it
// holds them in the order that makes each a plain add), then exchanges
// that halve the steps it holds.  Lane p then holds, in o[n][0] for n <
// HELD, the sums of its value 0 at steps (p % L) / SHARE * HELD + n, if
// (p % L) % SHARE == 0 (L = P / X).
template <int P, int X, int U>
struct Lanes {
  static constexpr int L = P / X;                 // lanes that share value 0
  static constexpr int HELD = U >= L ? U / L : 1;
  static constexpr int SHARE = U >= L ? 1 : L / U;
  __device__ static __forceinline__ void reduce(float (&o)[U][X], int p) {
#pragma unroll
    for (int k = X / 2, off = P / 2; k >= 1; k /= 2, off /= 2)
#pragma unroll
      for (int x = 0; x < U; ++x)
#pragma unroll
        for (int n = 0; n < k; ++n)
          o[x][n] += __shfl_xor_sync(0xffffffffu, o[x][n + k], off);
    const int q = p % L;
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
  }
  // the steps' first index of lane p's sums, or -1 if it holds none
  __device__ static __forceinline__ int first(int p) {
    const int q = p % L;
    return q % SHARE == 0 ? q / SHARE * HELD : -1;
  }
};

// ------------------------------------------------------------------ pass A

// A pass A thread: lane (g, p) of warp `warp` holds the block's rows
// base + (e ^ x), e < RA, and columns CA p + c, c < CA, where base = (warp
// GA + g) RA and x = p / (PA / RA).
template <int HD>
struct LaneA {
  using K = Bwd<HD>;
  int p, x, base;
  __device__ LaneA(int warp, int lane)
      : p(lane % K::PA), x(lane % K::PA / (K::PA / K::RA)),
        base((warp * K::GA + lane / K::PA) * K::RA) {}
  __device__ int row(int e) const { return base + (e ^ x); }
  __device__ int col(int c) const { return K::CA * p + c; }
};

template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&f)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    f[0] = a.x, f[1] = a.y;
  }
}

// U steps of a pass A consumer from step t0 of stage `st`: dr'_t over the
// thread's rows and columns from the state before each step, then the
// state's update fmaf(w, s, k v); the sums over the lanes; the lanes that
// hold them write dr = dr' + u k c into the stage.
template <int HD>
__device__ __forceinline__ void group_a(const unsigned char* st, int t0,
                                        const LaneA<HD>& ln, float u0,
                                        float (&s)[4][Bwd<HD>::CA]) {
  using K = Bwd<HD>;
  constexpr int CA = K::CA, RB = K::RB, U = K::U;
  using Red = Lanes<K::PA, 4, U>;
  const float* sk = reinterpret_cast<const float*>(st + K::A_K);
  const float* sw = reinterpret_cast<const float*>(st + K::A_W);
  const float* sv = reinterpret_cast<const float*>(st + K::A_V);
  const float* sdy = reinterpret_cast<const float*>(st + K::A_DY);
  float o[U][4];
#pragma unroll
  for (int x = 0; x < U; ++x) {
    const int t = t0 + x;
    float v[CA], dy[CA];
    load_n<CA>(sv + t * HD + ln.col(0), v);
    load_n<CA>(sdy + t * HD + ln.col(0), dy);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ki = sk[t * RB + ln.row(e)], wi = sw[t * RB + ln.row(e)];
      o[x][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CA; ++c) {
        o[x][e] = fmaf(s[e][c], dy[c], o[x][e]);
        s[e][c] = fmaf(wi, s[e][c], ki * v[c]);
      }
    }
  }
  Red::reduce(o, ln.p);
  const int f = Red::first(ln.p);
  if (f >= 0) {
    const float* sc = reinterpret_cast<const float*>(st + K::A_C);
    float* dr = reinterpret_cast<float*>(const_cast<unsigned char*>(st) +
                                         K::A_DR);
#pragma unroll
    for (int n = 0; n < Red::HELD; ++n) {
      const int t = t0 + f + n;
      dr[t * RB + ln.row(0)] =
          fmaf(u0 * sk[t * RB + ln.row(0)], sc[t], o[n][0]);
    }
  }
}

// Pass A: grid (row block, h, b).
template <int HD, bool BF16>
__global__ void __launch_bounds__(Bwd<HD>::THREADS_A, Bwd<HD>::MINB_A)
wkv6_bwd_a_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tdr,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  const float* __restrict__ dsT, float* __restrict__ pend,
                  int S, int H) {
  using K = Bwd<HD>;
  constexpr int T = K::T, NS = K::NS, RB = K::RB, CA = K::CA;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = full + NS;
  uint64_t* done = ready + NS;
  unsigned char* ring = smem + K::BARS;
  const int rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = (S + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 32);
      mbar_init(&done[s], 32 * K::WA);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == K::WA) {                                  // the producer
    constexpr uint32_t kBytes = (BF16 ? 2 : 4) * T * (RB + HD) +
                                4 * T * (RB + HD);
    const float uq[8] = {};
    auto issue = [&](int c) {
      const int s = c % NS;
      unsigned char* st = ring + s * K::STAGE_A;
      mbar_expect_tx(&full[s], kBytes);
      tma_load(st + (BF16 ? K::A_KH : K::A_K), &tk, &full[s], rb * RB, h,
               c * T, b);
      tma_load(st + (BF16 ? K::A_VH : K::A_V), &tv, &full[s], 0, h, c * T, b);
      tma_load(st + K::A_W, &tw, &full[s], rb * RB, h, c * T, b);
      tma_load(st + K::A_DY, &tdy, &full[s], 0, h, c * T, b);
    };
    if (lane == 0)
      for (int c = 0; c < min(NS, n); ++c) issue(c);
    for (int c = 0; c < n; ++c) {
      const int s = c % NS;
      unsigned char* st = ring + s * K::STAGE_A;
      float* sc = reinterpret_cast<float*>(st + K::A_C);
      mbar_wait(&full[s], (c / NS) & 1);
      if constexpr (BF16) {
        widen(st + K::A_KH, reinterpret_cast<float*>(st + K::A_K), T * RB,
              lane);
        widen(st + K::A_VH, reinterpret_cast<float*>(st + K::A_V), T * HD,
              lane);
        __syncwarp();
      }
      step_dots<HD>(reinterpret_cast<const float*>(st + K::A_DY),
                    reinterpret_cast<const float*>(st + K::A_V), nullptr,
                    nullptr, uq, sc, nullptr, lane);
      const int rows = min(T, S - c * T);
      // steps past S: w = 1 (k, v are zeros), so the state stays S_{S-1}
      float* sw = reinterpret_cast<float*>(st + K::A_W);
      for (int x = rows * RB + lane; x < T * RB; x += 32) sw[x] = 1.0f;
      __syncwarp();
      // the stage's dr tile is free once chunk c - NS's store has read it
      if (lane == 0 && c >= NS)
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(NS - 2)
                     : "memory");
      mbar_arrive(&ready[s]);
      if (lane == 0 && c >= 1) {  // chunk c - 1's dr out, its stage refilled
        const int cp = c - 1, sp = cp % NS;
        mbar_wait(&done[sp], (cp / NS) & 1);
        tma_store(&tdr, ring + sp * K::STAGE_A + K::A_DR, rb * RB, h, cp * T,
                  b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        if (cp + NS < n) issue(cp + NS);
      }
    }
    if (lane == 0) {
      const int cp = n - 1, sp = cp % NS;
      mbar_wait(&done[sp], (cp / NS) & 1);
      tma_store(&tdr, ring + sp * K::STAGE_A + K::A_DR, rb * RB, h, cp * T,
                b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    return;
  }

  // a consumer
  const LaneA<HD> ln(warp, lane);
  const size_t chain = (static_cast<size_t>(b) * H + h) * HD * HD +
                       static_cast<size_t>(rb) * RB * HD;
  const float u0 = u[h * HD + rb * RB + ln.row(0)];
  float s[4][CA];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < CA; ++c)
      s[e][c] = s0[chain + ln.row(e) * HD + ln.col(c)];
  for (int c = 0; c < n; ++c) {
    const int sc = c % NS, ph = (c / NS) & 1;
    const unsigned char* st = ring + sc * K::STAGE_A;
    mbar_wait(&full[sc], ph);
    mbar_wait(&ready[sc], ph);
#pragma unroll 1
    for (int t = 0; t < T; t += K::U) group_a<HD>(st, t, ln, u0, s);
    // dr is read by the async proxy (the TMA store) after `done`
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&done[sc]);
  }
  if (dsT != nullptr) {            // P_{S-1} = sum_j dsT S_{S-1}, a row
    // a lane's rows are in the exchanges' order, so the sums over the lanes
    // are group_a's, for one step
    using Red = Lanes<K::PA, 4, 1>;
    float pe[1][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pe[0][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CA; ++c)
        pe[0][e] = fmaf(dsT[chain + ln.row(e) * HD + ln.col(c)], s[e][c],
                        pe[0][e]);
    }
    Red::reduce(pe, ln.p);
    if (Red::first(ln.p) == 0)
      pend[(static_cast<size_t>(b) * H + h) * HD + rb * RB + ln.row(0)] =
          pe[0][0];
  }
}

// ------------------------------------------------------------------ pass B

// A pass B thread: lane (g, p) of warp `warp` holds rows 4p + e, e < 4, and
// the block's columns base + (c ^ x), c < CC, where base = (warp GB + g) CC
// and x = p / (PB / CC) (the forward's Lane).
template <int HD>
struct LaneB {
  using K = Bwd<HD>;
  int p, x, base, slot;
  __device__ LaneB(int warp, int lane)
      : p(lane % K::PB), x(lane % K::PB / (K::PB / K::CC)),
        base((warp * K::GB + lane / K::PB) * K::CC),
        slot(warp * K::GB + lane / K::PB) {}
  __device__ int col(int c) const { return base + (c ^ x); }
};

// U steps of a pass B consumer from step t0 of stage `st`, t0 + U - 1 down
// to t0: dv's and dk''s partial sums from G_t, then G's update fmaf(w, g,
// r dy).  Each step's dk' partials (a thread's 4 keys over its columns)
// into `pb` (U, SLOTS, HD); dv's sums over the lanes, and the lanes that
// hold them write dv = sum + dy a into the stage.
template <int HD>
__device__ __forceinline__ void group_b(const unsigned char* st, int t0,
                                        int jb, const LaneB<HD>& ln,
                                        float (&g)[4][Bwd<HD>::CC],
                                        float* pb) {
  using K = Bwd<HD>;
  constexpr int CC = K::CC, U = K::U;
  using Red = Lanes<K::PB, CC, U>;
  const float* sr = reinterpret_cast<const float*>(st + K::B_R);
  const float* sk = reinterpret_cast<const float*>(st + K::B_K);
  const float* sw = reinterpret_cast<const float*>(st + K::B_W);
  const float* sv = reinterpret_cast<const float*>(st + K::B_V) + jb * K::CB;
  const float* sdy = reinterpret_cast<const float*>(st + K::B_DY) + jb * K::CB;
  float o[U][CC];
#pragma unroll
  for (int x = U - 1; x >= 0; --x) {
    const int t = t0 + x;
    const float4 r4 = reinterpret_cast<const float4*>(sr + t * HD)[ln.p];
    const float4 k4 = reinterpret_cast<const float4*>(sk + t * HD)[ln.p];
    const float4 w4 = reinterpret_cast<const float4*>(sw + t * HD)[ln.p];
    const float ri[4] = {r4.x, r4.y, r4.z, r4.w};
    const float ki[4] = {k4.x, k4.y, k4.z, k4.w};
    const float wi[4] = {w4.x, w4.y, w4.z, w4.w};
    float v[CC], dy[CC], q[4];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      v[c] = sv[t * HD + ln.col(c)];
      dy[c] = sdy[t * HD + ln.col(c)];
      o[x][c] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        o[x][c] = fmaf(ki[e], g[e][c], o[x][c]);
        q[e] = fmaf(g[e][c], v[c], q[e]);
        g[e][c] = fmaf(wi[e], g[e][c], ri[e] * dy[c]);
      }
    }
    reinterpret_cast<float4*>(pb + (x * K::SLOTS + ln.slot) * HD)[ln.p] =
        make_float4(q[0], q[1], q[2], q[3]);
  }
  Red::reduce(o, ln.p);
  const int f = Red::first(ln.p);
  if (f >= 0) {
    const float* sa = reinterpret_cast<const float*>(st + K::B_A);
    float* dv = reinterpret_cast<float*>(const_cast<unsigned char*>(st) +
                                         K::B_DV);
#pragma unroll
    for (int n = 0; n < Red::HELD; ++n) {
      const int t = t0 + f + n;
      dv[t * K::CB + ln.col(0)] = fmaf(sdy[t * HD + ln.col(0)], sa[t], o[n][0]);
    }
  }
}

// P's walk back over one group's U steps from step tg, for the block's key
// `ki` (key `key` of the chain; a thread a key): dlw_t = P - k dk', P =
// dlw_t + r dr', from the group's (k dk', r dr').
template <int HD>
__device__ __forceinline__ void walk(const float2* wb, int tg, int ki,
                                     int key, float& P, float* dlw,
                                     size_t at0, size_t step, int S) {
#pragma unroll
  for (int x = Bwd<HD>::U - 1; x >= 0; --x) {
    const float2 e = wb[x * Bwd<HD>::CB + ki];
    const float d = P - e.x;
    if (tg + x < S) dlw[at0 + static_cast<size_t>(tg + x) * step + key] = d;
    P = d + e.y;
  }
}

// What a reader at hd 128 keeps of its (step, key) from the group's stage
// until the group's dk' parts are all in, a group later: r u and c_t for
// dk's bonus, k, and r dr' for the walk.
struct Held {
  float ru, c, k, rdr;
};

// Pass B: grid (column block, h, b).  SPLIT (NCB > 1, hd 128): a cluster of
// a chain's NCB column blocks; block jb owns keys jb CB .. jb CB + CB - 1,
// and each block sends its columns' part of a key's dk' to the key's owner
// (st.async into the owner's exchange buffer, completing on its mbarrier
// `xfull`), whose readers add the NCB parts in rank order a group later
// and hand the buffer back (an arrival on each sender's `xfree`).
template <int HD, bool BF16>
__global__ void __launch_bounds__(Bwd<HD>::THREADS_B, Bwd<HD>::MINB_B)
wkv6_bwd_b_kernel(const __grid_constant__ CUtensorMap tr,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tdr,
                  const __grid_constant__ CUtensorMap tdv,
                  const float* __restrict__ u, const float* __restrict__ dsT,
                  const float* __restrict__ pend, float* __restrict__ dk,
                  float* __restrict__ dlw, float* __restrict__ du_part,
                  float* __restrict__ ds0, int S, int H) {
  using K = Bwd<HD>;
  constexpr int T = K::T, NS = K::NS, CB = K::CB, CC = K::CC, U = K::U;
  constexpr int NT = K::NT, NCB = K::NCB, NB = K::NB;
  constexpr bool SPLIT = NCB > 1;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ready = full + NS;
  uint64_t* done = ready + NS;
  uint64_t* xfull = done + NS;     // SPLIT: an exchange buffer's parts in
  uint64_t* xfree = xfull + NB;    // SPLIT: the owners have read it
  unsigned char* ring = smem + K::BARS;
  float* pbuf = reinterpret_cast<float*>(smem + K::B_PB);
  float2* wbuf = reinterpret_cast<float2*>(smem + K::B_WB);
  float* dubuf = reinterpret_cast<float*>(smem + K::B_DU);
  float* xbuf = reinterpret_cast<float*>(smem + K::B_XB);
  const int jb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = (S + T - 1) / T;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 32);
      mbar_init(&done[s], NT);
    }
    if constexpr (SPLIT)
      for (int x = 0; x < NB; ++x) {
        mbar_init(&xfull[x], 1);                     // the owner's expect_tx
        mbar_init(&xfree[x], K::READERS / 32 * NCB);  // each reader warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  // ring sequence m holds chunk n - 1 - m: the chunks in reverse
  if (warp == K::WB) {                                  // the producer
    constexpr uint32_t kBytes =
        (BF16 ? 2 : 4) * 3 * T * HD + 4 * 2 * T * HD + 4 * T * CB;
    float uq[8];
    const int q = lane % (HD / 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) uq[e] = u[h * HD + 8 * q + e];
    auto issue = [&](int m) {
      const int s = m % NS, c = n - 1 - m;
      unsigned char* st = ring + s * K::STAGE_B;
      mbar_expect_tx(&full[s], kBytes);
      tma_load(st + (BF16 ? K::B_RH : K::B_R), &tr, &full[s], 0, h, c * T, b);
      tma_load(st + (BF16 ? K::B_KH : K::B_K), &tk, &full[s], 0, h, c * T, b);
      tma_load(st + (BF16 ? K::B_VH : K::B_V), &tv, &full[s], 0, h, c * T, b);
      tma_load(st + K::B_W, &tw, &full[s], 0, h, c * T, b);
      tma_load(st + K::B_DY, &tdy, &full[s], 0, h, c * T, b);
      tma_load(st + K::B_DR, &tdr, &full[s], jb * CB, h, c * T, b);
    };
    if (lane == 0)
      for (int m = 0; m < min(NS, n); ++m) issue(m);
    for (int m = 0; m < n; ++m) {
      const int s = m % NS, c = n - 1 - m;
      unsigned char* st = ring + s * K::STAGE_B;
      mbar_wait(&full[s], (m / NS) & 1);
      if constexpr (BF16) {
        widen(st + K::B_RH, reinterpret_cast<float*>(st + K::B_R), T * HD,
              lane);
        widen(st + K::B_KH, reinterpret_cast<float*>(st + K::B_K), T * HD,
              lane);
        widen(st + K::B_VH, reinterpret_cast<float*>(st + K::B_V), T * HD,
              lane);
        __syncwarp();
      }
      float* sa = reinterpret_cast<float*>(st + K::B_A);
      step_dots<HD>(reinterpret_cast<const float*>(st + K::B_DY),
                    reinterpret_cast<const float*>(st + K::B_V),
                    reinterpret_cast<const float*>(st + K::B_R),
                    reinterpret_cast<const float*>(st + K::B_K), uq, sa + T,
                    sa, lane);
      // steps past S: w = 1 (r, k, v, dy are zeros), so G and P stay
      const int rows = min(T, S - c * T);
      float* sw = reinterpret_cast<float*>(st + K::B_W);
      for (int x = rows * HD + lane; x < T * HD; x += 32) sw[x] = 1.0f;
      __syncwarp();
      if (lane == 0 && m >= NS)
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(NS - 2)
                     : "memory");
      mbar_arrive(&ready[s]);
      if (lane == 0 && m >= 1) {  // sequence m - 1's dv out, stage refilled
        const int mp = m - 1, sp = mp % NS;
        mbar_wait(&done[sp], (mp / NS) & 1);
        tma_store(&tdv, ring + sp * K::STAGE_B + K::B_DV, jb * CB, h,
                  (n - 1 - mp) * T, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        if (mp + NS < n) issue(mp + NS);
      }
    }
    if (lane == 0) {
      const int mp = n - 1, sp = mp % NS;
      mbar_wait(&done[sp], (mp / NS) & 1);
      tma_store(&tdv, ring + sp * K::STAGE_B + K::B_DV, jb * CB, h, 0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    if constexpr (SPLIT) cluster_sync();     // the consumers' last one
    return;
  }

  // a consumer
  const LaneB<HD> ln(warp, lane);
  const size_t chain = (static_cast<size_t>(b) * H + h) * HD * HD;
  const size_t step = static_cast<size_t>(H) * HD;
  const size_t at0 = (static_cast<size_t>(b) * S * H + h) * HD;
  float g[4][CC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < CC; ++c)
      g[e][c] = dsT ? dsT[chain + (4 * ln.p + e) * HD + jb * CB + ln.col(c)]
                    : 0.0f;
  // The (step, key) pairs of a group whose dk' partials a thread adds: key
  // i, steps x0, x0 + NT / HD, ...  Up to hd 64 these are whole dk', and
  // the thread finishes them; at hd 128 they are the block's columns' part,
  // sent to key i's owner (block i / CB), where reader (step tid / CB, key
  // jb CB + tid % CB) adds the NCB parts.  Thread ki < CB walks P for key
  // jb CB + ki.  Group grp's steps start at tg(grp) = n T - U (grp + 1).
  const int i = tid % HD, x0 = tid / HD, ki = tid % CB, key = jb * CB + ki;
  const float ui = u[h * HD + key];
  float P = (dsT != nullptr && tid < CB)
                ? pend[(static_cast<size_t>(b) * H + h) * HD + key]
                : 0.0f;
  float du_acc = 0.0f;
  Held held{};
  auto tg = [&](int grp) { return n * T - U * (grp + 1); };
  // SPLIT: reader (x, ki) finishes group grp's step x from the parts and
  // what it held, and hands the exchange buffer back
  auto finish = [&](int grp) {
    const int xb = grp % NB, x = tid / CB;
    mbar_wait_cluster(&xfull[xb], (grp / NB) & 1);
    const float* xr = xbuf + (xb * U + x) * NCB * CB + ki;
    float d = xr[0];
#pragma unroll
    for (int s = 1; s < NCB; ++s) d += xr[s * CB];
    __syncwarp();
    if (lane < NCB) mbar_arrive_cluster(cluster_addr(&xfree[xb], lane));
    const int t = tg(grp) + x;
    if (t < S)
      dk[at0 + static_cast<size_t>(t) * step + key] =
          fmaf(held.ru, held.c, d);
    wbuf[((grp & 1) * U + x) * CB + ki] = make_float2(held.k * d, held.rdr);
  };
  int grp = 0;
  for (int m = 0; m < n; ++m) {
    const int sc = m % NS, ph = (m / NS) & 1;
    const unsigned char* st = ring + sc * K::STAGE_B;
    mbar_wait(&full[sc], ph);
    mbar_wait(&ready[sc], ph);
    const float* sr = reinterpret_cast<const float*>(st + K::B_R);
    const float* sk = reinterpret_cast<const float*>(st + K::B_K);
    const float* sdr = reinterpret_cast<const float*>(st + K::B_DR);
    const float* scc = reinterpret_cast<const float*>(st + K::B_A) + T;
#pragma unroll 1
    for (int t0 = T - U; t0 >= 0; t0 -= U, ++grp) {
      float* pb = pbuf + (grp & 1) * U * K::SLOTS * HD;
      group_b<HD>(st, t0, jb, ln, g, pb);
      consumers_sync(NT);
      if constexpr (SPLIT) {
        if (grp >= 2 && tid < CB)
          walk<HD>(wbuf + (grp & 1) * U * CB, tg(grp - 2), ki, key, P, dlw,
                   at0, step, S);
        const int xb = grp % NB, owner = i / CB;
        if (grp >= NB) mbar_wait_cluster(&xfree[xb], (grp / NB - 1) & 1);
        const uint32_t bar = cluster_addr(&xfull[xb], owner);
#pragma unroll
        for (int x = x0; x < U; x += NT / HD) {
          float d = pb[x * K::SLOTS * HD + i];
#pragma unroll
          for (int sl = 1; sl < K::SLOTS; ++sl)
            d += pb[(x * K::SLOTS + sl) * HD + i];
          st_async(cluster_addr(
                       xbuf + ((xb * U + x) * NCB + jb) * CB + i % CB, owner),
                   d, bar);
        }
        if (tid == 0) mbar_expect_tx(&xfull[xb], 4 * U * NCB * CB);
        if (tid < K::READERS) {
          if (grp >= 1) finish(grp - 1);
          const int t = t0 + tid / CB;
          const float rr = sr[t * HD + key], kk = sk[t * HD + key];
          const float c = scc[t];
          held = Held{rr * ui, c, kk,
                      rr * fmaf(-(ui * kk), c, sdr[t * CB + ki])};
          du_acc = fmaf(rr * kk, c, du_acc);
        }
      } else {
        if (grp > 0 && tid < HD)
          walk<HD>(wbuf + ((grp - 1) & 1) * U * HD, tg(grp - 1), i, i, P,
                   dlw, at0, step, S);
        float2* wb = wbuf + (grp & 1) * U * HD;
#pragma unroll
        for (int x = x0; x < U; x += NT / HD) {
          float d = pb[x * K::SLOTS * HD + i];
#pragma unroll
          for (int sl = 1; sl < K::SLOTS; ++sl)
            d += pb[(x * K::SLOTS + sl) * HD + i];
          const int t = t0 + x, at = tg(grp) + x;
          const float rr = sr[t * HD + i], kk = sk[t * HD + i];
          const float c = scc[t];
          if (at < S)
            dk[at0 + static_cast<size_t>(at) * step + i] =
                fmaf(rr * ui, c, d);
          wb[x * HD + i] =
              make_float2(kk * d, rr * fmaf(-(ui * kk), c, sdr[t * HD + i]));
          du_acc = fmaf(rr * kk, c, du_acc);
        }
      }
    }
    // dv is read by the async proxy (the TMA store) after `done`
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&done[sc]);
  }
  consumers_sync(NT);
  if constexpr (SPLIT) {         // walk grp - 2, then finish grp - 1
    if (tid < CB)
      walk<HD>(wbuf + (grp & 1) * U * CB, tg(grp - 2), ki, key, P, dlw, at0,
               step, S);
    if (tid < K::READERS) finish(grp - 1);
    consumers_sync(NT);
  }
  if (tid < CB)
    walk<HD>(wbuf + ((grp - 1) & 1) * U * CB, tg(grp - 1), ki, key, P, dlw,
             at0, step, S);
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < CC; ++c)
      ds0[chain + (4 * ln.p + e) * HD + jb * CB + ln.col(c)] = g[e][c];
  // du's partial of each key: its pairs' sums, added in order
  constexpr int PAIRS = SPLIT ? U : NT / HD;
  dubuf[tid] = du_acc;
  consumers_sync(NT);
  if (tid < CB) {
    float a = dubuf[tid];
#pragma unroll
    for (int x = 1; x < PAIRS; ++x) a += dubuf[x * CB + tid];
    du_part[(static_cast<size_t>(b) * H + h) * HD + key] = a;
  }
  if constexpr (SPLIT) cluster_sync();   // no exchange into a block gone
}

// du = the chains' partials added over b in order
__global__ void wkv6_bwd_sum_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int hh) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < hh;
       e += gridDim.x * blockDim.x) {
    float a = du_part[e];
    for (int b = 1; b < B; ++b) a += du_part[static_cast<size_t>(b) * hh + e];
    du[e] = a;
  }
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

struct Args {
  const void *r, *k, *v;
  const float *w, *u, *s0, *dy, *dsT;
  float *dr, *dk, *dv, *dlw, *du, *ds0, *pend, *du_part;
  int B, S, H;
  cudaStream_t stream;
};

// which passes a call runs: bit 0 pass A, bit 1 pass B and the sum
template <int HD, bool BF16>
cudaError_t launch(const Args& a, int passes) {
  using K = Bwd<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // The driver's encoder needs a current context, and autograd calls the
  // backward from a thread of its own, where this may be the first CUDA
  // call: cudaSetDevice makes the device's primary context current here.
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaSetDevice(dev);
  if (ce != cudaSuccess) return ce;
  const int B = a.B, S = a.S, H = a.H, T = K::T;
  static bool sized = false;     // one attribute call per instantiation
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_a_kernel<HD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM_A);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_b_kernel<HD, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::SMEM_B);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  if (passes & 1) {
    CUtensorMap tk, tv, tw, tdy, tdr;
    if (!seq_map(enc, &tk, BF16, a.k, B, S, H, HD, K::RB, T) ||
        !seq_map(enc, &tv, BF16, a.v, B, S, H, HD, HD, T) ||
        !seq_map(enc, &tw, false, a.w, B, S, H, HD, K::RB, T) ||
        !seq_map(enc, &tdy, false, a.dy, B, S, H, HD, HD, T) ||
        !seq_map(enc, &tdr, false, a.dr, B, S, H, HD, K::RB, T))
      return cudaErrorInvalidValue;
    wkv6_bwd_a_kernel<HD, BF16>
        <<<dim3(K::NRB, H, B), K::THREADS_A, K::SMEM_A, a.stream>>>(
            tk, tv, tw, tdy, tdr, a.u, a.s0, a.dsT, a.pend, S, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (!(passes & 2)) return cudaSuccess;
  CUtensorMap tr, tk, tv, tw, tdy, tdr, tdv;
  if (!seq_map(enc, &tr, BF16, a.r, B, S, H, HD, HD, T) ||
      !seq_map(enc, &tk, BF16, a.k, B, S, H, HD, HD, T) ||
      !seq_map(enc, &tv, BF16, a.v, B, S, H, HD, HD, T) ||
      !seq_map(enc, &tw, false, a.w, B, S, H, HD, HD, T) ||
      !seq_map(enc, &tdy, false, a.dy, B, S, H, HD, HD, T) ||
      !seq_map(enc, &tdr, false, a.dr, B, S, H, HD, K::CB, T) ||
      !seq_map(enc, &tdv, false, a.dv, B, S, H, HD, K::CB, T))
    return cudaErrorInvalidValue;
  // a chain's NCB column blocks one cluster (one block up to hd 64)
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(K::NCB, H, B);
  cfg.blockDim = dim3(K::THREADS_B);
  cfg.dynamicSmemBytes = K::SMEM_B;
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K::NCB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K::NCB > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, wkv6_bwd_b_kernel<HD, BF16>, tr, tk, tv, tw, tdy, tdr, tdv,
      a.u, a.dsT, (const float*)a.pend, a.dk, a.dlw, a.du_part, a.ds0, S, H);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hh = H * HD;
  wkv6_bwd_sum_kernel<<<std::min((hh + 255) / 256, 1056), 256, 0,
                        a.stream>>>(a.du_part, a.du, B, hh);
  return cudaGetLastError();
}

template <int HD>
void report(int* out) {
  using K = Bwd<HD>;
  const int v[11] = {K::T,  K::NS,       K::U,      K::RB,
                     K::NRB, K::THREADS_A, K::SMEM_A, K::CB,
                     K::NCB, K::THREADS_B, K::SMEM_B};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

}  // namespace

// The passes of a call alone, for timing each: passes 1 runs pass A, 2
// pass B and the sum (on the dr of an earlier call into the same
// buffers), 3 both, as wkv6_bwd does.  Arguments as wkv6_bwd's.
extern "C" int wkv6_bwd_passes(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dy, const void* dsT, void* dr,
                               void* dk, void* dv, void* dlw, void* du,
                               void* ds0, void* pend, void* du_part, int B,
                               int S, int H, int hd, int bf16, int passes,
                               void* stream_) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || passes < 1 ||
      passes > 3)
    return cudaErrorInvalidValue;
  const Args a{r,
               k,
               v,
               static_cast<const float*>(w),
               static_cast<const float*>(u),
               static_cast<const float*>(s0),
               static_cast<const float*>(dy),
               static_cast<const float*>(dsT),
               static_cast<float*>(dr),
               static_cast<float*>(dk),
               static_cast<float*>(dv),
               static_cast<float*>(dlw),
               static_cast<float*>(du),
               static_cast<float*>(ds0),
               static_cast<float*>(pend),
               static_cast<float*>(du_part),
               B,
               S,
               H,
               static_cast<cudaStream_t>(stream_)};
#define WKV6_BWD_CASE(HD)                                                 \
  case HD:                                                                \
    return bf16 ? launch<HD, true>(a, passes) : launch<HD, false>(a, passes);
  switch (hd) {
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    WKV6_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef WKV6_BWD_CASE
}

// r, k, v: (B, S, H, hd) f32 (bf16 = 0) or bf16 (bf16 = 1); w, dy f32 of the
// same shape; u (H, hd), s0, dsT (or null: zeros) (B, H, hd, hd) f32; out:
// dr, dk, dv, dlw (the gradient of log w) like r in f32, du (H, hd), ds0
// like s0; scratch: pend, du_part (B, H, hd) f32.  All contiguous and r, k,
// v, w, dy, dr, dv 16-byte aligned.  Three launches; returns a cudaError_t.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* dr, void* dk,
                        void* dv, void* dlw, void* du, void* ds0, void* pend,
                        void* du_part, int B, int S, int H, int hd, int bf16,
                        void* stream_) {
  return wkv6_bwd_passes(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dlw, du,
                         ds0, pend, du_part, B, S, H, hd, bf16, 3, stream_);
}

// Bwd<hd> into out[11]: T, NS, U, RB, NRB, pass A's threads and dynamic
// shared bytes, CB, NCB, pass B's threads and dynamic shared bytes.
// Returns 0, or 1 for another hd.
extern "C" int wkv6_bwd_tiling(int hd, int* out) {
  switch (hd) {
    case 16: report<16>(out); return 0;
    case 32: report<32>(out); return 0;
    case 64: report<64>(out); return 0;
    case 128: report<128>(out); return 0;
    default: return 1;
  }
}

extern "C" const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
