// The gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu), one layer's
// sequence in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its lax.scan
// (repro/nn/blocks.py::rwkv_time_mix_seq) with XLA's autodiff.  The
// forward, per (batch row b, head h), with S_t the (HD, HD) f32 state after
// step t, row i on the key axis and column j on the value axis:
//
//   y_t[j]   = sum_i r_t[i] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//   S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
//
// With G_t = dL/dS_t (G_{S-1} = dsT, or zeros), walking t down from S - 1:
//
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] c_t,  c_t = dy_t . v_t
//   dk_t[i] = sum_j G_t[i,j] v_t[j]      + r_t[i] u_i c_t
//   dv_t[j] = sum_i G_t[i,j] k_t[i]      + dy_t[j] a_t,    a_t = sum_i r u k
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du_i   += r_t[i] k_t[i] c_t                        (over b and t)
//   G_{t-1} = w_t[i] G_t[i,j] + r_t[i] dy_t[j]         (ds0 = G_{-1})
//
// r, k, v: (B, S, H, HD), all f32 or all bf16; w, dy: (B, S, H, HD) f32;
// u: (H, HD) f32; s0, dsT: (B, H, HD, HD) f32 (dsT may be null: zeros);
// all contiguous.  dr, dk, dv, dw: (B, S, H, HD) f32; du (H, HD); ds0.
//
// Bound: FP32 issue slots.  dw couples S_{t-1}, which runs forward in
// time, with G_t, which runs backward.  Walking S back by dividing by w_t
// is neither exact nor safe (w = exp(-exp(.)) comes near 0), so the states
// are rebuilt forward with the forward kernel's own unfused update,
// __fadd_rn(__fmul_rn(w, s), __fmul_rn(k, v)) (3 slots), and are then
// bit for bit the forward's.  The least work a state entry a step: that
// rebuild 3, dr 1, G's update 2, dk, dv and dw 1 each: 9 slots, 367 us at
// (8, 1024, 40, 64) on an H100 SXM (132 SMs x 128 lanes x 1.98 GHz),
// above the bytes (191 us: r, k, v bf16, w and dy read, four f32 outputs
// written once).
//
// Design: simple and right first (a Hopper redesign is later work).
//  * Grid (column block, h, b): NCB = HD / CB blocks a chain, one at HD <=
//    64 (the whole state in one block), four column blocks of 32 at HD =
//    128, whose sums over j are per-block partials that a second short
//    kernel adds in a fixed order.
//  * Two views of G, so that no sum crosses threads a step: NR row owners
//    hold S[i, SW columns] and G[i, SW columns] in registers (dr, dk, dw
//    are sums over their own columns, then over the NSR owners of a row:
//    adjacent lanes, one __shfl_xor_sync each at HD = 64), and NC column
//    owners hold G[SH rows, j] (dv is a sum over their own rows, then over
//    the NSC owners of a column).  G's update is elementwise, so both views
//    run the same arithmetic; the column owners' copy costs 2 slots an
//    entry and saves dv's sum across 64 threads a step.
//  * Checkpoints: pass 1 walks the states forward from s0 and stores the
//    state before every chunk of TC steps but the last (to device memory,
//    each row owner's words as float4s in thread order).  Pass 2 walks the
//    chunks in reverse: the row owners rebuild the chunk's TC states from
//    its checkpoint into shared memory (each thread's own words, so no
//    barrier), computing dr on the way, then step G back through the chunk
//    reading S_{t-1} from shared memory, while the column owners step
//    their view and write dv.  The next checkpoint is loaded into the
//    state registers during the backward steps, and the next chunk's
//    inputs into registers during the chunk, so neither load waits.
//  * Inputs: a chunk's r, k, v, w and dy are staged in shared memory as
//    f32 (bf16 converted once), with a_t and c_t (a warp a step).  Each
//    staged row has PAD words after every 32, so a float4 broadcast to a
//    warp's two column runs is one wavefront, not two (2997.59 -> 2512.90
//    us).
//  * No atomics: du is a partial a (b, h) chain, added over b by the
//    second kernel in order, so repeats give the same bits.
//  * Shared memory at HD = 64: the chunk's states 8 x 64 x 64 f32 (128 KB)
//    and the staged inputs (10 KB), one block an SM; the checkpoints are
//    (B, H, ceil(S / TC), HD, HD) f32, 671 MB at (8, 1024, 40, 64).
//
// Predicted for this design on an NVIDIA H100 80GB HBM3 at 700 W, before
// its first run: about 16 issue slots a state entry a step (pass 1's 3,
// the rebuild's 3 + dr's 1, the row owners' 4, the column owners' 3, and
// the shared loads), 320 blocks in three waves of one block an SM, and
// the checkpoints' 1.3 GB of traffic: 0.8-1.2 ms at (8, 1024, 40, 64),
// bf16 or f32.  Measured: 3.01 ms, then 2.51-2.53 ms with the padding,
// 12-15 % of the bound (PERF.md row 10b): with one block of 8 warps an SM
// each part costs 2-5x its FP32 issue count
// (experiments/wkv6_bwd_variants.py).
// The redesign queued in ROADMAP.md takes the gradient of log w instead,
// a reverse cumulative sum of r dr - k dk, so no state is rebuilt.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

template <int HD>
struct Bwd {
  static constexpr int CB = HD == 128 ? 32 : HD;   // state columns a block
  static constexpr int NCB = HD / CB;              // blocks a chain
  static constexpr int TC = HD <= 32 ? 16 : 8;     // steps a chunk
  static constexpr int SW = CB < 32 ? CB : 32;     // columns a row owner
  static constexpr int NSR = CB / SW;              // row owners a row
  static constexpr int NR = HD * NSR;              // row owners
  static constexpr int SH = HD < 32 ? HD : 32;     // rows a column owner
  static constexpr int NSC = HD / SH;              // column owners a column
  static constexpr int NC = CB * NSC;              // column owners
  static constexpr int THREADS = NR + NC;
  static constexpr int PAD = 4;                    // words after each 32
                                                   // of a staged row
  static constexpr int ROW = HD + HD / 32 * PAD;   // a staged row, words
  static constexpr int IN = TC * ROW;              // a staged input, words
  static constexpr int PER = TC * HD / THREADS;    // its values a thread
  static constexpr int ST = TC * HD * CB;          // the chunk's states
  static constexpr int CK = HD * CB / 4;           // a checkpoint, float4s
  static constexpr int SMEM = 4 * (ST + 5 * IN + 2 * TC + HD);
  static_assert(SW == SH && SW % 4 == 0 && TC * HD % THREADS == 0 &&
                    (NR % 32 == 0 || THREADS == 32),
                "tiling");
};

template <bool BF16>
using Raw = typename std::conditional<BF16, uint16_t, float>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// Word of step t, key or column i in a staged input: PAD words after each
// 32, so that the two 32-column runs a warp's owners read start in other
// banks and a float4 broadcast to both is one shared-memory wavefront.
template <int HD>
__device__ __forceinline__ int sx(int t, int i) {
  return t * Bwd<HD>::ROW + i + (i >> 5) * Bwd<HD>::PAD;
}

// A chunk's inputs into registers (ALL: r, k, v, w, dy; else k, v, w),
// steps past S as zeros.  Element e of an input is step e / HD, key e % HD.
template <int HD, bool BF16, bool ALL>
__device__ __forceinline__ void fetch(
    Raw<BF16> (&pr)[Bwd<HD>::PER], Raw<BF16> (&pk)[Bwd<HD>::PER],
    Raw<BF16> (&pv)[Bwd<HD>::PER], float (&pw)[Bwd<HD>::PER],
    float (&pdy)[Bwd<HD>::PER], const Raw<BF16>* r, const Raw<BF16>* k,
    const Raw<BF16>* v, const float* w, const float* dy, size_t at0,
    size_t step, int S, int t0) {
  using K = Bwd<HD>;
#pragma unroll
  for (int p = 0; p < K::PER; ++p) {
    const int e = threadIdx.x + p * K::THREADS, t = e / HD;
    const bool in = t0 + t < S;
    const size_t a = at0 + static_cast<size_t>(t0 + t) * step + e % HD;
    pk[p] = in ? k[a] : Raw<BF16>(0);
    pv[p] = in ? v[a] : Raw<BF16>(0);
    pw[p] = in ? w[a] : 0.0f;
    if (ALL) {
      pr[p] = in ? r[a] : Raw<BF16>(0);
      pdy[p] = in ? dy[a] : 0.0f;
    }
  }
}

template <int HD, bool BF16, bool ALL>
__device__ __forceinline__ void put(
    const Raw<BF16> (&pr)[Bwd<HD>::PER], const Raw<BF16> (&pk)[Bwd<HD>::PER],
    const Raw<BF16> (&pv)[Bwd<HD>::PER], const float (&pw)[Bwd<HD>::PER],
    const float (&pdy)[Bwd<HD>::PER], float* sr, float* sk, float* sv,
    float* sw, float* sdy) {
  using K = Bwd<HD>;
#pragma unroll
  for (int p = 0; p < K::PER; ++p) {
    const int e = threadIdx.x + p * K::THREADS, x = sx<HD>(e / HD, e % HD);
    sk[x] = to_f32(pk[p]);
    sv[x] = to_f32(pv[p]);
    sw[x] = pw[p];
    if (ALL) {
      sr[x] = to_f32(pr[p]);
      sdy[x] = pdy[p];
    }
  }
}

template <int N>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dr, dk, dw (each + jb * jstride: partials at NCB > 1), dv, du_part (B,
// H, HD) and ds0; ck: the checkpoints, (B, H, NCB, nck, CK) float4s.
template <int HD, bool BF16>
__global__ void __launch_bounds__(Bwd<HD>::THREADS, 1)
wkv6_bwd_kernel(const Raw<BF16>* __restrict__ r,
                const Raw<BF16>* __restrict__ k,
                const Raw<BF16>* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0,
                float4* __restrict__ ck, int S, int H, size_t jstride) {
  using K = Bwd<HD>;
  constexpr int E = K::SW;                 // G (and S) entries a thread
  extern __shared__ float4 smem4[];
  float4* st = smem4;                      // states: [step][E / 4][NR]
  float* sr = reinterpret_cast<float*>(smem4 + K::ST / 4);
  float* sk = sr + K::IN;
  float* sv = sk + K::IN;
  float* sw = sv + K::IN;
  float* sdy = sw + K::IN;
  float* sa = sdy + K::IN;
  float* sc = sa + K::TC;
  float* su = sc + K::TC;
  const int tid = threadIdx.x, jb = blockIdx.x, h = blockIdx.y,
            b = blockIdx.z;
  const size_t step = static_cast<size_t>(H) * HD;
  const size_t at0 = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t chain = (static_cast<size_t>(b) * H + h) * HD * HD;
  const int nck = (S + K::TC - 1) / K::TC;
  float4* ckb = ck + ((static_cast<size_t>(b) * H + h) * K::NCB + jb) *
                         static_cast<size_t>(nck) * K::CK;
  for (int i = tid; i < HD; i += K::THREADS) su[i] = u[h * HD + i];
  const bool rown = tid < K::NR;
  // a row owner: row ri, columns rj .. rj + E; a column owner: column cj,
  // rows ci0 .. ci0 + E
  const int ri = tid / K::NSR, rseg = tid % K::NSR;
  const int rj = jb * K::CB + rseg * E;
  const int ct = tid - K::NR;
  const int cj = jb * K::CB + ct / K::NSC, ci0 = (ct % K::NSC) * E;

  Raw<BF16> pr[K::PER], pk[K::PER], pv[K::PER];
  float pw[K::PER], pdy[K::PER];
  float s[E], g[E];
  if (rown) {
#pragma unroll
    for (int c = 0; c < E; ++c) s[c] = s0[chain + ri * HD + rj + c];
  }

  // pass 1: the state before each chunk but the last, as checkpoints
  if (nck > 1)
    fetch<HD, BF16, false>(pr, pk, pv, pw, pdy, r, k, v, w, dy, at0, step,
                           S, 0);
  for (int c = 0; c + 1 < nck; ++c) {
    __syncthreads();                       // the last chunk's reads are done
    put<HD, BF16, false>(pr, pk, pv, pw, pdy, sr, sk, sv, sw, sdy);
    __syncthreads();
    if (c + 2 < nck)
      fetch<HD, BF16, false>(pr, pk, pv, pw, pdy, r, k, v, w, dy, at0, step,
                             S, (c + 1) * K::TC);
    if (rown) {
      float4* dst = ckb + static_cast<size_t>(c) * K::CK;
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        dst[q * K::NR + tid] =
            make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      for (int t = 0; t < K::TC; ++t) {
        const float wi = sw[sx<HD>(t, ri)], ki = sk[sx<HD>(t, ri)];
        const float4* vv =
            reinterpret_cast<const float4*>(sv + sx<HD>(t, rj));
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const float4 v4 = vv[q];
          const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
            s[4 * q + x] = __fadd_rn(__fmul_rn(wi, s[4 * q + x]),
                                     __fmul_rn(ki, vq[x]));
        }
      }
    }
  }

  // pass 2: the chunks in reverse
  if (rown) {
#pragma unroll
    for (int c = 0; c < E; ++c)
      g[c] = dsT ? dsT[chain + ri * HD + rj + c] : 0.0f;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      g[e] = dsT ? dsT[chain + (ci0 + e) * HD + cj] : 0.0f;
  }
  float du_acc = 0.0f;
  const int warp = tid / 32, lane = tid % 32;
  fetch<HD, BF16, true>(pr, pk, pv, pw, pdy, r, k, v, w, dy, at0, step, S,
                        (nck - 1) * K::TC);
  for (int c = nck - 1; c >= 0; --c) {
    __syncthreads();
    put<HD, BF16, true>(pr, pk, pv, pw, pdy, sr, sk, sv, sw, sdy);
    __syncthreads();
    for (int t = warp; t < K::TC; t += K::THREADS / 32) {
      float pa = 0.0f, pc = 0.0f;
      for (int i = lane; i < HD; i += 32) {
        pa = fmaf(sr[sx<HD>(t, i)] * su[i], sk[sx<HD>(t, i)], pa);
        pc = fmaf(sdy[sx<HD>(t, i)], sv[sx<HD>(t, i)], pc);
      }
      pa = lanes_sum<32>(pa);
      pc = lanes_sum<32>(pc);
      if (lane == 0) {
        sa[t] = pa;
        sc[t] = pc;
      }
    }
    __syncthreads();
    if (c > 0)
      fetch<HD, BF16, true>(pr, pk, pv, pw, pdy, r, k, v, w, dy, at0, step,
                            S, (c - 1) * K::TC);
    const int t0 = c * K::TC, n = min(K::TC, S - t0);
    if (rown) {
      // rebuild the chunk's states (each step's S_{t-1}), and dr
      for (int t = 0; t < n; ++t) {
        float4* slot = st + t * (E / 4) * K::NR;
        const float wi = sw[sx<HD>(t, ri)], ki = sk[sx<HD>(t, ri)];
        const float4* vv =
            reinterpret_cast<const float4*>(sv + sx<HD>(t, rj));
        const float4* yy =
            reinterpret_cast<const float4*>(sdy + sx<HD>(t, rj));
        float p = 0.0f;
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          slot[q * K::NR + tid] =
              make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
          const float4 v4 = vv[q], y4 = yy[q];
          const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
          const float yq[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            p = fmaf(yq[x], s[4 * q + x], p);
            s[4 * q + x] = __fadd_rn(__fmul_rn(wi, s[4 * q + x]),
                                     __fmul_rn(ki, vq[x]));
          }
        }
        p = lanes_sum<K::NSR>(p);
        if (rseg == 0) {
          const size_t o = jb * jstride + at0 +
                           static_cast<size_t>(t0 + t) * step + ri;
          dr[o] = jb == 0 ? fmaf(su[ri] * ki, sc[t], p) : p;
        }
      }
      // the previous chunk's checkpoint lands while G steps back
      if (c > 0) {
        const float4* src = ckb + static_cast<size_t>(c - 1) * K::CK;
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const float4 x = src[q * K::NR + tid];
          s[4 * q] = x.x;
          s[4 * q + 1] = x.y;
          s[4 * q + 2] = x.z;
          s[4 * q + 3] = x.w;
        }
      }
      for (int t = n - 1; t >= 0; --t) {
        const float4* slot = st + t * (E / 4) * K::NR;
        const float wi = sw[sx<HD>(t, ri)], rr = sr[sx<HD>(t, ri)];
        const float4* vv =
            reinterpret_cast<const float4*>(sv + sx<HD>(t, rj));
        const float4* yy =
            reinterpret_cast<const float4*>(sdy + sx<HD>(t, rj));
        float pw_ = 0.0f, pk_ = 0.0f;
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const float4 s4 = slot[q * K::NR + tid], v4 = vv[q], y4 = yy[q];
          const float sq[4] = {s4.x, s4.y, s4.z, s4.w};
          const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
          const float yq[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pw_ = fmaf(g[4 * q + x], sq[x], pw_);
            pk_ = fmaf(g[4 * q + x], vq[x], pk_);
            g[4 * q + x] = fmaf(wi, g[4 * q + x], rr * yq[x]);
          }
        }
        pw_ = lanes_sum<K::NSR>(pw_);
        pk_ = lanes_sum<K::NSR>(pk_);
        if (rseg == 0) {
          const size_t o = jb * jstride + at0 +
                           static_cast<size_t>(t0 + t) * step + ri;
          dw[o] = pw_;
          if (jb == 0) {
            dk[o] = fmaf(rr * su[ri], sc[t], pk_);
            du_acc = fmaf(rr * sk[sx<HD>(t, ri)], sc[t], du_acc);
          } else {
            dk[o] = pk_;
          }
        }
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const float dyj = sdy[sx<HD>(t, cj)];
        const float4* r4s =
            reinterpret_cast<const float4*>(sr + sx<HD>(t, ci0));
        const float4* k4s =
            reinterpret_cast<const float4*>(sk + sx<HD>(t, ci0));
        const float4* w4s =
            reinterpret_cast<const float4*>(sw + sx<HD>(t, ci0));
        float p = 0.0f;
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const float4 r4 = r4s[q], k4 = k4s[q], w4 = w4s[q];
          const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
          const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            p = fmaf(g[4 * q + x], kq[x], p);
            g[4 * q + x] = fmaf(wq[x], g[4 * q + x], rq[x] * dyj);
          }
        }
        p = lanes_sum<K::NSC>(p);
        if (ct % K::NSC == 0)
          dv[at0 + static_cast<size_t>(t0 + t) * step + cj] =
              fmaf(dyj, sa[t], p);
      }
    }
  }
  if (rown) {
    float4* o = reinterpret_cast<float4*>(ds0 + chain + ri * HD + rj);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      o[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
    if (jb == 0 && rseg == 0)
      du_part[(static_cast<size_t>(b) * H + h) * HD + ri] = du_acc;
  }
}

// du = the chains' partials added over b in order; at NCB > 1 also dr, dk
// and dw = their column blocks' partials (part: (3, ncb, n)) added in order.
__global__ void wkv6_bwd_sum_kernel(const float* __restrict__ part,
                                    float* __restrict__ dr,
                                    float* __restrict__ dk,
                                    float* __restrict__ dw, size_t n,
                                    int ncb, const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int hh) {
  const size_t first = blockIdx.x * static_cast<size_t>(blockDim.x) +
                       threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = first; e < static_cast<size_t>(hh); e += stride) {
    float a = du_part[e];
    for (int b = 1; b < B; ++b) a += du_part[static_cast<size_t>(b) * hh + e];
    du[e] = a;
  }
  if (ncb == 1) return;
  float* outs[3] = {dr, dk, dw};
  for (size_t e = first; e < n; e += stride) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* p = part + static_cast<size_t>(q) * ncb * n + e;
      float a = p[0];
      for (int j = 1; j < ncb; ++j) a += p[static_cast<size_t>(j) * n];
      outs[q][e] = a;
    }
  }
}

template <int HD, bool BF16>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   const float* dy, const float* dsT, float* dr, float* dk,
                   float* dv, float* dw, float* du, float* ds0, float* ck,
                   float* du_part, float* part, int B, int S, int H,
                   cudaStream_t stream) {
  using K = Bwd<HD>;
  static bool sized = false;     // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<HD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const size_t n = static_cast<size_t>(B) * S * H * HD;
  const bool split = K::NCB > 1;
  wkv6_bwd_kernel<HD, BF16><<<dim3(K::NCB, H, B), K::THREADS, K::SMEM,
                              stream>>>(
      static_cast<const Raw<BF16>*>(r), static_cast<const Raw<BF16>*>(k),
      static_cast<const Raw<BF16>*>(v), w, u, s0, dy, dsT,
      split ? part : dr, split ? part + K::NCB * n : dk, dv,
      split ? part + 2 * K::NCB * n : dw, du_part, ds0,
      reinterpret_cast<float4*>(ck), S, H, split ? n : 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t work = split ? n : static_cast<size_t>(H) * HD;
  const int blocks =
      static_cast<int>(std::min<size_t>((work + 255) / 256, 1056));
  wkv6_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(
      part, dr, dk, dw, n, K::NCB, du_part, du, B, H * HD);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(bool bf16, const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0,
                     const float* dy, const float* dsT, float* dr, float* dk,
                     float* dv, float* dw, float* du, float* ds0, float* ck,
                     float* du_part, float* part, int B, int S, int H,
                     cudaStream_t stream) {
  return bf16 ? launch<HD, true>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw,
                                 du, ds0, ck, du_part, part, B, S, H, stream)
              : launch<HD, false>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw,
                                  du, ds0, ck, du_part, part, B, S, H,
                                  stream);
}

template <int HD>
void report(int* out) {
  using K = Bwd<HD>;
  const int v[7] = {K::CB, K::NCB, K::TC, K::SW, K::SH, K::THREADS, K::SMEM};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

}  // namespace

// r, k, v: (B, S, hd) f32 (bf16 = 0) or bf16 (bf16 = 1); w, dy f32 of the
// same shape; u (H, hd), s0, dsT (or null: zeros) (B, H, hd, hd) f32; out:
// dr, dk, dv, dw like r in f32, du (H, hd), ds0 like s0; scratch: ck (B, H,
// ceil(S / TC), hd, hd) f32, du_part (B, H, hd) f32, part (3, NCB, B, S,
// H, hd) f32 where NCB > 1 (hd = 128).  Two launches; returns a
// cudaError_t.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* dr, void* dk,
                        void* dv, void* dw, void* du, void* ds0, void* ck,
                        void* du_part, void* part, int B, int S, int H,
                        int hd, int bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const float* f[5] = {static_cast<const float*>(w),
                       static_cast<const float*>(u),
                       static_cast<const float*>(s0),
                       static_cast<const float*>(dy),
                       static_cast<const float*>(dsT)};
  float* o[9] = {static_cast<float*>(dr),      static_cast<float*>(dk),
                 static_cast<float*>(dv),      static_cast<float*>(dw),
                 static_cast<float*>(du),      static_cast<float*>(ds0),
                 static_cast<float*>(ck),      static_cast<float*>(du_part),
                 static_cast<float*>(part)};
#define WKV6_BWD_CASE(HD)                                                     \
  case HD:                                                                    \
    return dispatch<HD>(bf16 != 0, r, k, v, f[0], f[1], f[2], f[3], f[4],     \
                        o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], o[8], \
                        B, S, H, stream);
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

// Bwd<hd> into out[7]: CB, NCB, TC, SW, SH, threads, dynamic shared bytes.
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
