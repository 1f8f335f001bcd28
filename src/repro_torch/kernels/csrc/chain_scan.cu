// Device decision chains of the batched evaluator, for Hopper (sm_90a).
//
// Replaces the two lax.scan chains of repro/eval/jaxtail.py: the serial
// greedy chain of tune_parallel (JaxState._build_chain, its scan at :346)
// and the time-multiplexed tuner's decision-tree chain
// (JaxState._build_tm_chain, its scan at :267).  Neither is a Pallas kernel;
// on the TPU each is one XLA loop over a whole candidate run.  Here each is
// one launch of one thread block:
//
//   chain_scan  step t: score candidate t (weight [wi, wj] of layer k moved
//               by dw, column wj's bias by db) against the chain state with
//               every earlier accepted step applied; accept iff its correct
//               count >= the running count, then apply it.
//   tm_chain    step t: score the step's one or two candidate values, rank
//               them by (count, value), accept the best iff it clears the
//               running count; else score the bias nudges in order with the
//               best value and accept the first that clears it.
//
// Arithmetic is the reference's, in int32 with its wraparound (products and
// sums in uint32): column update at layer k, the hardware activation with
// the 8-bit requantization (arithmetic >> on signed int32), the rank-1
// update at layer k+1, the deeper layers as int32 products, and the unique
// score a * n_out + (n_out - 1 - j), whose row maximum is the first-index
// argmax; rows with a negative label never count.
//
// Bound: latency and the one SM's issue rate.  Step t+1 reads the state
// that step t's accept wrote, and the accept needs a count over every row,
// so the chain is a sequence of block-wide reductions, and between two of
// them the block recomputes the network tail of every row whose layer-k
// output moves.  The bytes a step must touch (three int32 columns of the
// state, and the rows it changes) take about a nanosecond at the memory's
// rate.  The design keeps everything in one block and spends as few
// instructions and memory round trips as it can between two reductions:
//
// * One block of T threads (512 for the serial chain on the paper's nets,
//   256 otherwise, so a tail row stays in registers).  Thread i owns rows i, i + T, ...
//   The chain's private copy of the state lives in a workspace, layer k's
//   inputs, accumulators and outputs stored column-major, so the three
//   columns a step reads are read coalesced, one row a thread; layer k+1's
//   accumulators row-major, padded to W, read as 16-byte vectors.  A row is
//   only read and written by its own thread, so the one __syncthreads a
//   reduction needs is all the synchronisation a step has.
// * The reduction is a warp shuffle, one shared-memory slot a warp, one
//   barrier, and every warp summing the slots itself; the slots are double
//   buffered, so no second barrier guards their reuse.
// * A row whose layer-k output does not move under a candidate keeps its
//   correct-label bit, kept for every row in the workspace (computed once
//   at the start, updated on every accept): only the rows that move run the
//   tail.  The count is still the sum over every row of its bit, so it
//   equals the reference's full recount exactly.  The scoring pass stores
//   each row's bit for every alternative, and the accept takes the chosen
//   one's, so no tail runs twice.
// * The next layer's weights and the deeper layers' weights and biases sit
//   in shared memory, padded with zeros to W columns (12 or 16) and a
//   deeper layer to W rows, so a tail row runs in registers over fixed
//   loops with 16-byte loads and no predicates; an activation is a shift,
//   an add and two clamps whose constants are set per layer once.
// * The TM chain scores the candidate pair in one pass (two counts in one
//   reduction) and the nudges in groups of kGroup (kGroup counts in one
//   reduction), stopping after the group with the first hit.  The results
//   are those of the reference, which scores every nudge whenever the pair
//   fails: the first hit, or the first nudge's count when none hits.
//
// A multi-block version (a cooperative launch with a grid-wide reduction a
// step, the tail spread over every SM) is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kGroup = 8;               // nudges scored in one pass
constexpr int kNeg = -(1 << 30);        // the score of a row never correct
constexpr int kChainSteps = 4;          // ints a serial-chain step holds
constexpr int kTmSteps = 8;             // ints a TM step holds

// The network, as the wrapper packs it (kMetaInts ints).
struct Net {
  int L, k, M, q, n_steps, count0, n_db, wsize;
  int n[kMaxLayers + 1];                // layer widths, n[0] the input's
  int act[kMaxLayers];                  // 0 htanh 1 satlin 2 relu 3 hsig 4 lin
  int woff[kMaxLayers];                 // W[l] (rows padded to W) in the
                                        // packed weights, l > k
  int boff[kMaxLayers];                 // bias << FRAC of layer l (padded
                                        // to W), l > k + 1
};
constexpr int kMetaInts = 8 + (kMaxLayers + 1) + 3 * kMaxLayers;

// repro_torch.core.intmlp.act_requant as constants: clamp((acc >> sh) +
// off, lo, hi) >> q, clamped to 8 bits.
struct Act {
  int sh, off, lo, hi;
};

__device__ __forceinline__ Act act_of(int code, int q) {
  const int one = 1 << (q + 7);
  switch (code) {
    case 0: return {0, 0, -one, one};               // htanh
    case 1:
    case 2: return {0, 0, 0, one};                  // satlin, relu
    case 3: return {1, one >> 1, 0, one};           // hsig
    default: return {0, 0, INT_MIN, INT_MAX};       // lin
  }
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int requant(int acc, Act a, int q) {
  acc = min(max((acc >> a.sh) + a.off, a.lo), a.hi);
  return min(max(acc >> q, -128), 127);
}

// What a block keeps in shared memory besides the weights.
struct Shared {
  Net net;
  Act act[kMaxLayers];
  int red[2 * kGroup * 32];             // the reductions' slots
};

// 1 if the row whose final activations are x[0..n) is counted correct.
template <int W>
__device__ __forceinline__ int row_correct(const int (&x)[W], int n,
                                           long long lab, long long ls) {
  int smax = INT_MIN, slab = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < n) {
      const int s = wadd(wmul(x[c], n), n - 1 - c);
      smax = max(smax, s);
      if (c == ls) slab = s;
    }
  }
  if (lab < 0) slab = kNeg;
  return slab == smax;
}

template <int W>
__device__ __forceinline__ void load_w(int (&x)[W], const int* p) {
#pragma unroll
  for (int c = 0; c < W; c += 4) {
    const int4 v = *reinterpret_cast<const int4*>(p + c);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }
}

// The chain: its state in the workspace, and the scoring of a row.
template <int W>
struct Chain {
  const Shared& sh;
  const int* sw;                        // padded weights in shared memory
  int *aT, *accT, *hT;                  // layer k: inputs, accumulators,
                                        // outputs, column-major (n x M)
  int* accn;                            // layer k+1 accumulators (M x W)
  int *correct, *bits;                  // a row's bit; its candidates' bits
  const long long *lab, *lab_safe;
  int M, k, L, q, nk, n1, n2;
  bool last;

  __device__ Chain(const Shared& s, const int* w, int* ws,
                   const long long* lb, const long long* ls)
      : sh(s), sw(w), lab(lb), lab_safe(ls) {
    const Net& net = s.net;
    M = net.M;
    k = net.k;
    L = net.L;
    q = net.q;
    last = k == L - 1;
    nk = net.n[k];
    n1 = net.n[k + 1];
    n2 = last ? 0 : net.n[k + 2];
    accn = ws;                          // first: 16-byte aligned rows
    aT = accn + (last ? 0 : static_cast<size_t>(W) * M);
    accT = aT + static_cast<size_t>(nk) * M;
    hT = accT + static_cast<size_t>(n1) * M;
    correct = hT + static_cast<size_t>(n1) * M;
    bits = correct + M;
  }

  __device__ const int* wrow(int wj) const {
    return sw + sh.net.woff[k + 1] + wj * W;
  }

  // k is the last layer: layer k's outputs of row r, column wj at h (wj <
  // 0: the row as it is).
  __device__ int last_correct(int r, int wj, int h) const {
    int x[W];
#pragma unroll
    for (int c = 0; c < W; ++c)
      x[c] = c < n1 ? (c == wj ? h : hT[static_cast<size_t>(c) * M + r]) : 0;
    return row_correct<W>(x, n1, lab[r], lab_safe[r]);
  }

  // k is not the last layer: layer k+1's accumulator row r plus dcol *
  // W[k+1][wj], through layer k+1's activation and the deeper layers.
  __device__ int tail_correct(int r, int dcol, int wj) const {
    int x[W], w[W];
    load_w<W>(x, accn + static_cast<size_t>(r) * W);
    load_w<W>(w, wrow(wj));
    const Act a1 = sh.act[k + 1];
#pragma unroll
    for (int c = 0; c < W; ++c)
      x[c] = c < n2 ? requant(wadd(x[c], wmul(dcol, w[c])), a1, q) : 0;
    int n = n2;
    for (int l = k + 2; l < L; ++l) {
      const int* wl = sw + sh.net.woff[l];
      const int* bl = sw + sh.net.boff[l];
      int y[W];
#pragma unroll
      for (int c = 0; c < W; c += 4) {    // four outputs at a time
        int4 s4 = *reinterpret_cast<const int4*>(bl + c);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int4 v = *reinterpret_cast<const int4*>(wl + i * W + c);
          s4.x = wadd(s4.x, wmul(x[i], v.x));
          s4.y = wadd(s4.y, wmul(x[i], v.y));
          s4.z = wadd(s4.z, wmul(x[i], v.z));
          s4.w = wadd(s4.w, wmul(x[i], v.w));
        }
        y[c] = s4.x;
        y[c + 1] = s4.y;
        y[c + 2] = s4.z;
        y[c + 3] = s4.w;
      }
      const Act al = sh.act[l];
      n = sh.net.n[l + 1];
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = c < n ? requant(y[c], al, q) : 0;
    }
    return row_correct<W>(x, n, lab[r], lab_safe[r]);
  }

  // Row r's bit with column wj of layer k's output at h; dcol = h - its
  // current value.
  __device__ int candidate(int r, int wj, int h, int dcol) const {
    if (dcol == 0) return correct[r];
    return last ? last_correct(r, wj, h) : tail_correct(r, dcol, wj);
  }

  // The workspace copy of the state, and every row's bit.
  __device__ void load(const int* a_k, const int* acc_k, const int* a_k1,
                       const int* acc_n) {
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      for (int c = 0; c < nk; ++c)
        aT[static_cast<size_t>(c) * M + r] = a_k[static_cast<size_t>(r) * nk + c];
      for (int c = 0; c < n1; ++c) {
        accT[static_cast<size_t>(c) * M + r] = acc_k[r * n1 + c];
        hT[static_cast<size_t>(c) * M + r] = a_k1[r * n1 + c];
      }
      if (!last) {
        int* row = accn + static_cast<size_t>(r) * W;
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = c < n2 ? acc_n[r * n2 + c] : 0;
      }
      correct[r] = last ? last_correct(r, -1, 0) : tail_correct(r, 0, 0);
    }
  }

  // Apply an accepted step (weight [wi, wj] moved by dw, bias by db) to
  // this thread's rows; a row's new bit is alternative `alt`'s of `bits`.
  __device__ void apply(int wi, int wj, int dw, int db, int alt) {
    int w[W];
    if (!last) load_w<W>(w, wrow(wj));
    const Act ak = sh.act[k];
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      const size_t col = static_cast<size_t>(wj) * M + r;
      const int buf = wadd(wadd(accT[col],
                                wmul(aT[static_cast<size_t>(wi) * M + r], dw)),
                           db);
      const int h = requant(buf, ak, q);
      const int dcol = h - hT[col];
      accT[col] = buf;
      if (dcol == 0) continue;
      hT[col] = h;
      correct[r] = (bits[r] >> alt) & 1;
      if (!last) {
        int* row = accn + static_cast<size_t>(r) * W;
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = wadd(row[c], wmul(dcol, w[c]));
      }
    }
  }
};

// Sum of v[i] over the block, returned in v[i] to every thread: a shuffle
// reduction a warp, one slot a warp (two buffers of V x 32, alternating),
// one barrier, then every warp sums the slots.
template <int V>
__device__ __forceinline__ void block_sum(int (&v)[V], int* red,
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int* slot = red + parity * kGroup * 32;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int s = v[i];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) slot[i * 32 + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int s = lane < n_warps ? slot[i * 32 + lane] : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    v[i] = s;
  }
  parity ^= 1;
}

// Shared set-up of both kernels: the net and its activations, the packed
// weights and, after them, the nudges.
__device__ __forceinline__ void setup(const Net& net, Shared& s, int* sw,
                                      const int* wpack, const int* dbsh) {
  if (threadIdx.x == 0) {
    s.net = net;
    for (int l = 0; l < net.L; ++l) s.act[l] = act_of(net.act[l], net.q);
  }
  for (int i = threadIdx.x; i < net.wsize; i += blockDim.x) sw[i] = wpack[i];
  for (int i = threadIdx.x; i < net.n_db; i += blockDim.x)
    sw[net.wsize + i] = dbsh[i];
  __syncthreads();
}

template <int W, int T>
__global__ void __launch_bounds__(T, 1)
chain_scan_kernel(Net net, const int* __restrict__ a_k,
                  const int* __restrict__ acc_k0,
                  const int* __restrict__ a_k10,
                  const int* __restrict__ acc_n0,
                  const int* __restrict__ wpack,
                  const long long* __restrict__ lab,
                  const long long* __restrict__ lab_safe,
                  const int* __restrict__ steps, int* ws, int* out) {
  extern __shared__ __align__(16) int sw[];
  __shared__ Shared s;
  setup(net, s, sw, wpack, steps);
  Chain<W> ch(s, sw, ws, lab, lab_safe);
  ch.load(a_k, acc_k0, a_k10, acc_n0);
  const Act ak = s.act[net.k];
  const int M = net.M, q = net.q;
  int cnt = net.count0, parity = 0;
  for (int t = 0; t < net.n_steps; ++t) {
    const int* st = steps + t * kChainSteps;
    const int wi = st[0], wj = st[1], dw = st[2], db = st[3];
    int v[1] = {0};
    for (int r = threadIdx.x; r < M; r += T) {
      const size_t col = static_cast<size_t>(wj) * M + r;
      const int buf = wadd(wadd(ch.accT[col],
                                wmul(ch.aT[static_cast<size_t>(wi) * M + r],
                                     dw)), db);
      const int h = requant(buf, ak, q);
      const int bit = ch.candidate(r, wj, h, h - ch.hT[col]);
      ch.bits[r] = bit;
      v[0] += bit;
    }
    block_sum<1>(v, s.red, parity);
    const int cnt_c = v[0];
    const bool ok = cnt_c >= cnt;
    if (ok) {
      ch.apply(wi, wj, dw, db, 0);
      cnt = cnt_c;
    }
    if (threadIdx.x == 0) {
      out[2 * t] = cnt_c;
      out[2 * t + 1] = ok;
    }
  }
}

template <int W, int T>
__global__ void __launch_bounds__(T, 1)
tm_chain_kernel(Net net, const int* __restrict__ a_k,
                const int* __restrict__ acc_k0,
                const int* __restrict__ a_k10,
                const int* __restrict__ acc_n0,
                const int* __restrict__ wpack,
                const long long* __restrict__ lab,
                const long long* __restrict__ lab_safe,
                const int* __restrict__ steps, int* ws, int* out) {
  extern __shared__ __align__(16) int sw[];
  __shared__ Shared s;
  setup(net, s, sw, wpack, steps);      // the nudges lead the steps buffer
  const int* dbsh = sw + net.wsize;
  const int n_db = net.n_db;
  Chain<W> ch(s, sw, ws, lab, lab_safe);
  ch.load(a_k, acc_k0, a_k10, acc_n0);
  const Act ak = s.act[net.k];
  const int M = net.M, q = net.q;
  int cnt = net.count0, parity = 0;
  for (int t = 0; t < net.n_steps; ++t) {
    // a step's fields are read where they are used, so that few values
    // live across the passes over the rows
    const int* st = steps + n_db + t * kTmSteps;
    const int wi = st[0], wj = st[1];

    // the candidate pair, ranked by (count, value) descending; bits 0, 1
    int v[2] = {0, 0};
    const int n_alt = st[4] ? 2 : 1, dw0 = st[2], dw1 = st[3];
    for (int r = threadIdx.x; r < M; r += T) {
      const size_t col = static_cast<size_t>(wj) * M + r;
      const int base = ch.accT[col];
      const int a = ch.aT[static_cast<size_t>(wi) * M + r];
      const int old = ch.hT[col];
      int b = 0;
#pragma unroll 1
      for (int i = 0; i < n_alt; ++i) {   // one tail in the code, not two
        const int h = requant(wadd(base, wmul(a, i ? dw1 : dw0)), ak, q);
        b |= ch.candidate(r, wj, h, h - old) << i;
      }
      v[0] += b & 1;
      v[1] += b >> 1;
      ch.bits[r] = b;
    }
    block_sum<2>(v, s.red, parity);
    const int c0 = v[0], c1 = st[4] ? v[1] : -1;
    const bool sel = c1 > c0 || (c1 == c0 && st[7] > st[6]);
    const int cnt_best = sel ? c1 : c0, dw_best = st[sel ? 3 : 2];
    const bool pair_ok = cnt_best >= cnt, valid = st[5] != 0;

    // the bias nudges, in order, only when the pair fails; a group's bits
    // (one a nudge) replace the pair's
    bool db_ok = false;
    int db_idx = 0, cnt_db = 0, g_hit = 0;
    if (valid && !pair_ok) {
      for (int g = 0; g < n_db && !db_ok; g += kGroup) {
        const int ng = min(kGroup, n_db - g);
        // a thread's counts, 8 bits each (it owns at most 255 rows)
        unsigned lo = 0, hi = 0;
        for (int r = threadIdx.x; r < M; r += T) {
          const size_t col = static_cast<size_t>(wj) * M + r;
          const int base = wadd(
              ch.accT[col],
              wmul(ch.aT[static_cast<size_t>(wi) * M + r], dw_best));
          const int old = ch.hT[col];
          int b = 0;
#pragma unroll 1
          for (int i = 0; i < ng; ++i) {
            const int h = requant(wadd(base, dbsh[g + i]), ak, q);
            const int bi = ch.candidate(r, wj, h, h - old);
            b |= bi << i;
            if (i < 4) lo += bi << (8 * i);
            else hi += bi << (8 * (i - 4));
          }
          ch.bits[r] = b;
        }
        int cs[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          cs[i] = ((i < 4 ? lo : hi) >> (8 * (i & 3))) & 0xff;
        block_sum<kGroup>(cs, s.red, parity);
        if (g == 0) cnt_db = cs[0];
        int hit = -1, cnt_hit = 0;      // the group's first hit
#pragma unroll
        for (int i = kGroup - 1; i >= 0; --i) {
          if (i < ng && cs[i] >= cnt) {
            hit = i;
            cnt_hit = cs[i];
          }
        }
        if (hit >= 0) {
          db_ok = true;
          db_idx = g + hit;
          cnt_db = cnt_hit;
          g_hit = hit;
        }
      }
    }
    const bool ok = valid && (pair_ok || db_ok);
    const int db_fin = pair_ok || n_db == 0 ? 0 : dbsh[db_idx];
    const int cnt_dec = pair_ok ? cnt_best : cnt_db;
    if (ok) {
      ch.apply(wi, wj, dw_best, db_fin, pair_ok ? int(sel) : g_hit);
      cnt = cnt_dec;
    }
    if (threadIdx.x == 0) {
      int* o = out + 6 * t;
      o[0] = ok;
      o[1] = sel;
      o[2] = pair_ok;
      o[3] = db_idx;
      o[4] = cnt_best;
      o[5] = cnt_dec;
    }
  }
}

Net read_meta(const int* meta) {
  Net net;
  int* dst = &net.L;
  for (int i = 0; i < kMetaInts; ++i) dst[i] = meta[i];
  return net;
}

// Threads a block: 512 for the serial chain at W = 12, 256 otherwise, so
// that a thread may hold 128 or 255 registers and a tail row stays in them
// (the TM chain at W = 12 and either chain at W = 16 spilled at 512).
template <bool kTm, int W>
constexpr int threads() {
  return !kTm && W == 12 ? 512 : 256;
}

template <bool kTm, int W>
void launch_one(const Net& net, const int* a_k, const int* acc_k,
                const int* a_k1, const int* acc_n, const int* wpack,
                const long long* lab, const long long* lab_safe,
                const int* steps, int* ws, int* out, cudaStream_t stream) {
  constexpr int T = threads<kTm, W>();
  const size_t smem = static_cast<size_t>(net.wsize + net.n_db) * sizeof(int);
  if constexpr (kTm) {
    tm_chain_kernel<W, T><<<1, T, smem, stream>>>(
        net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe, steps, ws, out);
  } else {
    chain_scan_kernel<W, T><<<1, T, smem, stream>>>(
        net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe, steps, ws, out);
  }
}

// W: the padded width of the layers past k+1 (12 or 16; the wrapper picks
// it and pads the weights to it).
template <bool kTm>
cudaError_t launch(const int* meta, const int* a_k, const int* acc_k,
                   const int* a_k1, const int* acc_n, const int* wpack,
                   const long long* lab, const long long* lab_safe,
                   const int* steps, int* ws, int* out, int width,
                   cudaStream_t stream) {
  const Net net = read_meta(meta);
  if (width == 12) {
    launch_one<kTm, 12>(net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe,
                        steps, ws, out, stream);
  } else if (width == 16) {
    launch_one<kTm, 16>(net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe,
                        steps, ws, out, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

static_assert(sizeof(Net) == kMetaInts * sizeof(int), "Net is packed ints");

// The serial greedy chain over n_steps steps (wi, wj, dw, db) of layer k.
// meta: kMetaInts host ints (the Net); a_k (M, n_k), acc_k and a_k1
// (M, n_{k+1}), acc_n (M, n_{k+2}) or null when k is the last layer, all
// int32 row-major; wpack: W[k+1] (n_{k+1} rows), then W[l] (width rows)
// and bias[l] << FRAC for l > k + 1, int32, every row padded to `width`
// with zeros; lab and lab_safe (M,)
// int64; steps (n_steps, 4) int32; ws: M * (n_k + 2 n_{k+1} + width + 2)
// int32 of workspace (no width term when k is the last layer); out
// (n_steps, 2) int32: count, accepted.
extern "C" int chain_scan(const int* meta, const int* a_k, const int* acc_k,
                          const int* a_k1, const int* acc_n,
                          const int* wpack, const long long* lab,
                          const long long* lab_safe, const int* steps,
                          int* ws, int* out, int width, void* stream) {
  return static_cast<int>(launch<false>(meta, a_k, acc_k, a_k1, acc_n, wpack,
                                        lab, lab_safe, steps, ws, out, width,
                                        static_cast<cudaStream_t>(stream)));
}

// The TM decision-tree chain: as chain_scan, with steps the n_db nudges
// (bias << FRAC) then (n_steps, 8) int32 (wi, wj, dw0, dw1, has2, valid,
// pw0, pw1); out (n_steps, 6) int32: ok, sel, pair_ok, db_idx, cnt_best,
// cnt_dec.
extern "C" int tm_chain(const int* meta, const int* a_k, const int* acc_k,
                        const int* a_k1, const int* acc_n, const int* wpack,
                        const long long* lab, const long long* lab_safe,
                        const int* steps, int* ws, int* out, int width,
                        void* stream) {
  return static_cast<int>(launch<true>(meta, a_k, acc_k, a_k1, acc_n, wpack,
                                       lab, lab_safe, steps, ws, out, width,
                                       static_cast<cudaStream_t>(stream)));
}

extern "C" const char* chain_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* tm_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
