// Device decision chains of the batched evaluator, for Hopper (sm_90a).
//
// Replaces the two lax.scan chains of repro/eval/jaxtail.py: the serial
// greedy chain of tune_parallel (JaxState._build_chain, its scan at :346)
// and the time-multiplexed tuner's decision-tree chain
// (JaxState._build_tm_chain, its scan at :267).  Neither is a Pallas kernel;
// on the TPU each is one XLA loop over a whole candidate run.  Here each is
// one launch:
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
// Bound: latency.  Step t+1 reads the state that step t's accept wrote, and
// the accept needs a count over every row, so the chain is a sequence of
// reductions over the rows, and between two of them the rows whose layer-k
// output moves recompute the network tail.  The bytes a step must touch
// (three int32 columns of the state, and the rows it changes) take about a
// nanosecond at the memory's rate; what a step costs is the latency of its
// row pass, its reduction and its accept, paid in sequence.  Two routes:
//
// * cluster (the rule wherever its shared memory holds the rows): one chain
//   on one thread-block cluster of C CTAs (C in 2..16) on neighbouring SMs,
//   256 threads each.  CTA c owns a contiguous range of ceil(M / C) rows
//   and loads their state into its shared memory once: layer k's inputs,
//   accumulators and outputs column-major, layer k+1's accumulators
//   row-major padded to W (20 at W = 16, against bank conflicts), each row's
//   correct bit, its candidates' bits and its label.  No step reads or
//   writes device memory for row state, and a thread holds one or two rows
//   at the paper's shapes, so the tails of a step are spread over C SMs.
//   A reduction is one hardware cluster barrier: each warp reduces its
//   counts with shuffles, and lanes 0..C-1 store the warp's partials into a
//   slot of every CTA's shared memory (st.shared::cluster, distributed
//   shared memory); then barrier.cluster arrive.release / wait.acquire, and
//   every CTA sums the C x 8 partials itself, so all take the same accept
//   decision with no further synchronisation.  The slots are double
//   buffered by parity: a CTA writes parity p again only after the barrier
//   of the next reduction, which no CTA passes before it has read p.
//   Rank 0's thread 0 writes the outputs.
// * block (every case the cluster cannot hold, up to 65,280 rows): one
//   block of T threads (512 for the serial chain at W = 12, 256 otherwise,
//   so a tail row stays in registers) on one SM.  Thread i owns rows i,
//   i + T, ... of a workspace in device memory laid out as above (layer
//   k+1's accumulators at W), and a reduction is a warp shuffle, one
//   shared-memory slot a warp, one barrier, and every warp summing the
//   slots itself; the slots are double buffered, so no second barrier
//   guards their reuse.
//
// On both routes a row is only read and written by its own thread, so the
// reduction is all the synchronisation a step has; a serial step's fields
// are loaded (one 16-byte read-only load) during the step before, and:
//
// * A row whose layer-k output does not move under a candidate keeps its
//   correct-label bit (computed once at the start, updated on every
//   accept): only the rows that move run the tail.  The count is still the
//   sum over every row of its bit, so it equals the reference's full
//   recount exactly.  The scoring pass stores each row's bit for every
//   alternative, and the accept takes the chosen one's, so no tail runs
//   twice.
// * The next layer's weights and the deeper layers' weights and biases sit
//   in shared memory, padded with zeros to W columns (12 or 16) and a
//   deeper layer to W rows, so a tail row runs in registers over fixed
//   loops with 16-byte loads and no predicates; an activation is a shift,
//   an add and two clamps whose constants are set per layer once.
// * The TM chain scores the candidate pair in one pass (two counts in one
//   reduction, 16 bits each in one word) and the nudges in groups of
//   kGroup (kGroup counts in one reduction of kGroup / 2 words), stopping
//   after the group with the first hit.  The results
//   are those of the reference, which scores every nudge whenever the pair
//   fails: the first hit, or the first nudge's count when none hits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kGroup = 8;               // nudges scored in one pass
constexpr int kNeg = -(1 << 30);        // the score of a row never correct
constexpr int kChainSteps = 4;          // ints a serial-chain step holds
static_assert(kChainSteps == 4, "a serial step is read as one int4");
constexpr int kTmSteps = 8;             // ints a TM step holds

// The cluster route: threads a CTA, CTAs a cluster at most, the partials
// of one reduced value (a warp's of every CTA), and the slots of both
// parities in ints.
constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kSlots = kMaxCluster * (kClusterThreads / 32);
constexpr int kSlotInts = 2 * kGroup * kSlots;

// The TM chain reduces its counts two to a word, 16 bits each: a count is
// at most M, and neither route takes more than kMaxRows rows (the
// wrapper's limit, checked again at launch).
constexpr int kMaxRows = 255 * 256;
static_assert(kMaxRows < (1 << 16), "a count fits 16 bits");

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

// What a block keeps in static shared memory besides the weights.
struct Shared {
  Net net;
  Act act[kMaxLayers];
  int red[2 * kGroup * 32];             // the block route's reduction slots
};

// The row stride of layer k+1's accumulators: W, or W + 4 where W is a
// multiple of 8, so that eight rows' 16-byte loads meet no bank twice.
template <int W>
__host__ __device__ constexpr int acc_stride() {
  return W % 8 == 0 ? W + 4 : W;
}

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

// The chain: its rows' state and the scoring of a row.  The block route
// keeps the state of all M rows in a device-memory workspace, with the
// labels as the caller's int64 pair; the cluster route keeps a CTA's rows
// in its shared memory, AS the padded stride of layer k+1's accumulators,
// the label as one int (-1 for a row never counted, else lab_safe, passed
// as both lab and lab_safe).
template <int W, int AS = W, typename Lab = long long>
struct Chain {
  const Shared& sh;
  const int* sw;                        // padded weights in shared memory
  int *aT, *accT, *hT;                  // layer k: inputs, accumulators,
                                        // outputs, column-major (n x M)
  int* accn;                            // layer k+1 accumulators (M x AS)
  int *correct, *bits;                  // a row's bit; its candidates' bits
  const Lab *lab, *lab_safe;
  int M, k, L, q, nk, n1, n2;           // M: the rows this chain holds
  bool last;

  __device__ Chain(const Shared& s, const int* w, int* ws, const Lab* lb,
                   const Lab* ls, int rows)
      : sh(s), sw(w), lab(lb), lab_safe(ls) {
    const Net& net = s.net;
    M = rows;
    k = net.k;
    L = net.L;
    q = net.q;
    last = k == L - 1;
    nk = net.n[k];
    n1 = net.n[k + 1];
    n2 = last ? 0 : net.n[k + 2];
    accn = ws;                          // first: 16-byte aligned rows
    aT = accn + (last ? 0 : static_cast<size_t>(AS) * M);
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
    load_w<W>(x, accn + static_cast<size_t>(r) * AS);
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

  // Every row's bit as the state stands.
  __device__ int bit_now(int r) const {
    return last ? last_correct(r, -1, 0) : tail_correct(r, 0, 0);
  }

  // The block route's workspace copy of the state, and every row's bit.
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
        int* row = accn + static_cast<size_t>(r) * AS;
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = c < n2 ? acc_n[r * n2 + c] : 0;
      }
      correct[r] = bit_now(r);
    }
  }

  // Apply an accepted step (weight [wi, wj] moved by dw, bias by db) to
  // this thread's rows; a row's new bit is alternative `alt`'s of `bits`.
  __device__ void apply(int wi, int wj, int dw, int db, int alt) const {
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
        int* row = accn + static_cast<size_t>(r) * AS;
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = wadd(row[c], wmul(dcol, w[c]));
      }
    }
  }
};

__device__ __forceinline__ int warp_sum(int s) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    s = wadd(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// The block route's reduction: the sum of v[i] over the block, returned in
// v[i] to every thread; a shuffle reduction a warp, one slot a warp (two
// buffers of V x 32, alternating), one barrier, then every warp sums the
// slots.  Thread 0 writes the outputs.
struct BlockSum {
  int* red;
  int parity;

  template <int V>
  __device__ __forceinline__ void operator()(int (&v)[V]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int* slot = red + parity * kGroup * 32;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int s = warp_sum(v[i]);
      if (lane == 0) slot[i * 32 + warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = warp_sum(lane < n_warps ? slot[i * 32 + lane] : 0);
    parity ^= 1;
  }

  __device__ bool writer() const { return threadIdx.x == 0; }
};

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();                         // the .aligned form: whole warps
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Store v at `local`'s offset in the shared memory of the cluster's CTA
// `rank`.
__device__ __forceinline__ void store_remote(int* local, int rank, int v) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;"
               :: "r"(remote), "r"(v) : "memory");
}

// The cluster route's reduction: the sum of v[i] over the cluster,
// returned in v[i] to every thread.  A warp's sum goes to slot (rank,
// warp) of value i in every CTA (lane c stores into CTA c), one cluster
// barrier, then every warp of every CTA sums the C x 8 slots.  Two buffers
// of kGroup x kSlots, alternating.  Rank 0's thread 0 writes the outputs.
struct ClusterSum {
  int* slots;
  int n_ctas, rank, parity;

  template <int V>
  __device__ __forceinline__ void operator()(int (&v)[V]) {
    constexpr int n_warps = kClusterThreads / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* slot = slots + parity * kGroup * kSlots;
    const int mine = rank * n_warps + warp;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int s = warp_sum(v[i]);
      if (lane < n_ctas) store_remote(slot + i * kSlots + mine, lane, s);
    }
    cluster_barrier();
    const int n = n_ctas * n_warps;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int s = 0;
      for (int j = lane; j < n; j += 32)
        s = wadd(s, slot[i * kSlots + j]);
      v[i] = warp_sum(s);
    }
    parity ^= 1;
  }

  __device__ bool writer() const { return rank == 0 && threadIdx.x == 0; }
};

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

// The cluster route's set-up: this CTA's rows [r0, r0 + R), R = ceil(M /
// C) (fewer, or none, at the end), copied into its shared memory with
// coalesced reads and transposed there; then every row's bit, and one
// cluster barrier, after which every CTA of the cluster runs and its
// slots may be written.  The dynamic shared memory holds the slots, the
// weights and nudges, then the rows' state and labels.
template <int W>
__device__ Chain<W, acc_stride<W>(), int> load_slice(
    const Net& net, Shared& s, int* dyn, const int* wpack, const int* dbsh,
    const int* a_k, const int* acc_k, const int* a_k1, const int* acc_n,
    const long long* lab, const long long* lab_safe) {
  constexpr int AS = acc_stride<W>();
  int* sw = dyn + kSlotInts;
  setup(net, s, sw, wpack, dbsh);
  const int C = cluster_ctas(), per = (net.M + C - 1) / C;
  const int r0 = min(cluster_rank() * per, net.M), R = min(per, net.M - r0);
  int* ws = sw + ((net.wsize + net.n_db + 3) & ~3);
  const bool last = net.k == net.L - 1;
  const int nk = net.n[net.k], n1 = net.n[net.k + 1];
  const int n2 = last ? 0 : net.n[net.k + 2];
  int* code = ws + (last ? 0 : AS * R) + (nk + 2 * n1 + 2) * R;
  Chain<W, AS, int> ch(s, sw, ws, code, code, R);
  const int T = blockDim.x;
  for (int e = threadIdx.x; e < R * nk; e += T) {
    const int r = e / nk;
    ch.aT[(e - r * nk) * R + r] = a_k[static_cast<size_t>(r0) * nk + e];
  }
  for (int e = threadIdx.x; e < R * n1; e += T) {
    const int r = e / n1, c = e - r * n1;
    const size_t g = static_cast<size_t>(r0) * n1 + e;
    ch.accT[c * R + r] = acc_k[g];
    ch.hT[c * R + r] = a_k1[g];
  }
  if (!last) {
    for (int e = threadIdx.x; e < R * AS; e += T) {
      const int r = e / AS, c = e - r * AS;
      ch.accn[e] = c < n2 ? acc_n[static_cast<size_t>(r0 + r) * n2 + c] : 0;
    }
  }
  for (int r = threadIdx.x; r < R; r += T)
    code[r] = lab[r0 + r] < 0 ? -1 : static_cast<int>(lab_safe[r0 + r]);
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += T) ch.correct[r] = ch.bit_now(r);
  cluster_barrier();
  return ch;
}

// The serial chain's steps, on either route.
template <int T, typename Ch, typename Red>
__device__ __forceinline__ void serial_steps(const Net& net, const Ch& ch,
                                             Red& red,
                                             const int* __restrict__ steps,
                                             int* out) {
  const Act ak = ch.sh.act[net.k];
  const int M = ch.M, q = net.q;
  int cnt = net.count0;
  const int4* st4 = reinterpret_cast<const int4*>(steps);
  int4 next = net.n_steps ? __ldg(st4) : make_int4(0, 0, 0, 0);
  for (int t = 0; t < net.n_steps; ++t) {
    const int wi = next.x, wj = next.y, dw = next.z, db = next.w;
    if (t + 1 < net.n_steps) next = __ldg(st4 + t + 1);
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
    red(v);
    const int cnt_c = v[0];
    const bool ok = cnt_c >= cnt;
    if (ok) {
      ch.apply(wi, wj, dw, db, 0);
      cnt = cnt_c;
    }
    if (red.writer()) {
      out[2 * t] = cnt_c;
      out[2 * t + 1] = ok;
    }
  }
}

// The TM chain's steps, on either route; the nudges sit in shared memory
// at dbsh, the steps follow the nudges in `steps`.
template <int T, typename Ch, typename Red>
__device__ __forceinline__ void tm_steps(const Net& net, const Ch& ch,
                                         Red& red, const int* dbsh,
                                         const int* __restrict__ steps,
                                         int* out) {
  const int n_db = net.n_db;
  const Act ak = ch.sh.act[net.k];
  const int M = ch.M, q = net.q;
  int cnt = net.count0;
  for (int t = 0; t < net.n_steps; ++t) {
    // a step's fields are read where they are used, so that few values
    // live across the passes over the rows
    const int* st = steps + n_db + t * kTmSteps;
    const int wi = st[0], wj = st[1];

    // the candidate pair, ranked by (count, value) descending; bits 0, 1,
    // the two counts in one word
    int v[1] = {0};
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
      v[0] += (b & 1) | (b >> 1) << 16;
      ch.bits[r] = b;
    }
    red(v);
    const int c0 = v[0] & 0xffff;
    const int c1 = st[4] ? static_cast<int>(static_cast<unsigned>(v[0]) >> 16)
                         : -1;
    const bool sel = c1 > c0 || (c1 == c0 && st[7] > st[6]);
    const int cnt_best = sel ? c1 : c0, dw_best = st[sel ? 3 : 2];
    const bool pair_ok = cnt_best >= cnt, valid = st[5] != 0;

    // the bias nudges, in order, only when the pair fails; a group's bits
    // (one a nudge) replace the pair's, its counts two to a word
    bool db_ok = false;
    int db_idx = 0, cnt_db = 0, g_hit = 0;
    if (valid && !pair_ok) {
      for (int g = 0; g < n_db && !db_ok; g += kGroup) {
        const int ng = min(kGroup, n_db - g);
        int p[kGroup / 2] = {};
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
          }
          ch.bits[r] = b;
#pragma unroll
          for (int i = 0; i < kGroup / 2; ++i)
            p[i] += ((b >> 2 * i) & 1) | ((b >> (2 * i + 1)) & 1) << 16;
        }
        red(p);
        int cs[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          cs[i] = (static_cast<unsigned>(p[i >> 1]) >> (16 * (i & 1))) &
                  0xffff;
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
    if (red.writer()) {
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

// -- the block route ---------------------------------------------------------

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
  Chain<W> ch(s, sw, ws, lab, lab_safe, net.M);
  ch.load(a_k, acc_k0, a_k10, acc_n0);
  BlockSum red{s.red, 0};
  serial_steps<T>(net, ch, red, steps, out);
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
  Chain<W> ch(s, sw, ws, lab, lab_safe, net.M);
  ch.load(a_k, acc_k0, a_k10, acc_n0);
  BlockSum red{s.red, 0};
  tm_steps<T>(net, ch, red, sw + net.wsize, steps, out);
}

// -- the cluster route -------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kClusterThreads, 1)
chain_scan_cluster_kernel(Net net, const int* __restrict__ a_k,
                          const int* __restrict__ acc_k0,
                          const int* __restrict__ a_k10,
                          const int* __restrict__ acc_n0,
                          const int* __restrict__ wpack,
                          const long long* __restrict__ lab,
                          const long long* __restrict__ lab_safe,
                          const int* __restrict__ steps, int* out) {
  extern __shared__ __align__(16) int dyn[];
  __shared__ Shared s;
  const auto ch = load_slice<W>(net, s, dyn, wpack, steps, a_k, acc_k0,
                                a_k10, acc_n0, lab, lab_safe);
  ClusterSum red{dyn, cluster_ctas(), cluster_rank(), 0};
  serial_steps<kClusterThreads>(net, ch, red, steps, out);
  cluster_barrier();                    // no CTA leaves while its slots
                                        // may still be written
}

template <int W>
__global__ void __launch_bounds__(kClusterThreads, 1)
tm_chain_cluster_kernel(Net net, const int* __restrict__ a_k,
                        const int* __restrict__ acc_k0,
                        const int* __restrict__ a_k10,
                        const int* __restrict__ acc_n0,
                        const int* __restrict__ wpack,
                        const long long* __restrict__ lab,
                        const long long* __restrict__ lab_safe,
                        const int* __restrict__ steps, int* out) {
  extern __shared__ __align__(16) int dyn[];
  __shared__ Shared s;
  const auto ch = load_slice<W>(net, s, dyn, wpack, steps, a_k, acc_k0,
                                a_k10, acc_n0, lab, lab_safe);
  ClusterSum red{dyn, cluster_ctas(), cluster_rank(), 0};
  tm_steps<kClusterThreads>(net, ch, red, dyn + kSlotInts + net.wsize, steps,
                            out);
  cluster_barrier();
}

Net read_meta(const int* meta) {
  Net net;
  int* dst = &net.L;
  for (int i = 0; i < kMetaInts; ++i) dst[i] = meta[i];
  return net;
}

// Threads a block on the block route: 512 for the serial chain at W = 12,
// 256 otherwise, so that a thread may hold 128 or 255 registers and a tail
// row stays in them (the TM chain at W = 12 and either chain at W = 16
// spilled at 512).
template <bool kTm, int W>
constexpr int threads() {
  return !kTm && W == 12 ? 512 : 256;
}

using ClusterKernel = void (*)(Net, const int*, const int*, const int*,
                               const int*, const int*, const long long*,
                               const long long*, const int*, int*);

template <bool kTm, int W>
ClusterKernel cluster_kernel() {
  if constexpr (kTm) return tm_chain_cluster_kernel<W>;
  else return chain_scan_cluster_kernel<W>;
}

// Dynamic shared memory bytes a CTA of the cluster route needs: the slots,
// the weights and nudges, then ceil(M / C) rows of state and label.
template <int W>
size_t cluster_bytes(const Net& net, int n_ctas) {
  const bool last = net.k == net.L - 1;
  const int per = (net.M + n_ctas - 1) / n_ctas;
  const int row = (last ? 0 : acc_stride<W>()) + net.n[net.k] +
                  2 * net.n[net.k + 1] + 3;
  return sizeof(int) * (kSlotInts + ((net.wsize + net.n_db + 3) & ~3) +
                        static_cast<size_t>(per) * row);
}

// A cluster of n_ctas CTAs with `smem` bytes of dynamic shared memory
// each: the kernel's attributes set, the launch configured.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int n_ctas, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(n_ctas);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t opt_in(ClusterKernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool kTm, int W>
cudaError_t launch_one(const Net& net, const int* a_k, const int* acc_k,
                       const int* a_k1, const int* acc_n, const int* wpack,
                       const long long* lab, const long long* lab_safe,
                       const int* steps, int* ws, int* out, int n_ctas,
                       int smem_bytes, cudaStream_t stream) {
  if (n_ctas == 0) {                    // the block route
    constexpr int T = threads<kTm, W>();
    const size_t smem =
        static_cast<size_t>(net.wsize + net.n_db) * sizeof(int);
    if constexpr (kTm) {
      tm_chain_kernel<W, T><<<1, T, smem, stream>>>(
          net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe, steps, ws, out);
    } else {
      chain_scan_kernel<W, T><<<1, T, smem, stream>>>(
          net, a_k, acc_k, a_k1, acc_n, wpack, lab, lab_safe, steps, ws, out);
    }
    return cudaGetLastError();
  }
  // the cluster route, with the wrapper's reckoning of its shared memory
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (n_ctas < 1 || n_ctas > kMaxCluster ||
      smem < cluster_bytes<W>(net, n_ctas))
    return cudaErrorInvalidValue;
  const ClusterKernel kernel = cluster_kernel<kTm, W>();
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch launch(n_ctas, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, net, a_k, acc_k, a_k1, acc_n,
                           wpack, lab, lab_safe, steps, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// W: the padded width of the layers past k+1 (12 or 16; the wrapper picks
// it and pads the weights to it).
template <bool kTm>
cudaError_t launch(const int* meta, const int* a_k, const int* acc_k,
                   const int* a_k1, const int* acc_n, const int* wpack,
                   const long long* lab, const long long* lab_safe,
                   const int* steps, int* ws, int* out, int width, int n_ctas,
                   int smem, cudaStream_t stream) {
  const Net net = read_meta(meta);
  if (net.M > kMaxRows) return cudaErrorInvalidValue;
  if (width == 12)
    return launch_one<kTm, 12>(net, a_k, acc_k, a_k1, acc_n, wpack, lab,
                               lab_safe, steps, ws, out, n_ctas, smem, stream);
  if (width == 16)
    return launch_one<kTm, 16>(net, a_k, acc_k, a_k1, acc_n, wpack, lab,
                               lab_safe, steps, ws, out, n_ctas, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

static_assert(sizeof(Net) == kMetaInts * sizeof(int), "Net is packed ints");

// The serial greedy chain over n_steps steps (wi, wj, dw, db) of layer k.
// meta: kMetaInts host ints (the Net); a_k (M, n_k), acc_k and a_k1
// (M, n_{k+1}), acc_n (M, n_{k+2}) or null when k is the last layer, all
// int32 row-major; wpack: W[k+1] (n_{k+1} rows), then W[l] (width rows)
// and bias[l] << FRAC for l > k + 1, int32, every row padded to `width`
// with zeros; lab and lab_safe (M,) int64; steps (n_steps, 4) int32; out
// (n_steps, 2) int32: count, accepted.  n_ctas = 0: the block route, with
// ws M * (n_k + 2 n_{k+1} + width + 2) int32 of workspace (no width term
// when k is the last layer); n_ctas in 1..16: the cluster route on a
// cluster of n_ctas CTAs with smem bytes of dynamic shared memory each (at
// least what the kernel needs, else cudaErrorInvalidValue), ws unused.
extern "C" int chain_scan(const int* meta, const int* a_k, const int* acc_k,
                          const int* a_k1, const int* acc_n,
                          const int* wpack, const long long* lab,
                          const long long* lab_safe, const int* steps,
                          int* ws, int* out, int width, int n_ctas, int smem,
                          void* stream) {
  return static_cast<int>(launch<false>(meta, a_k, acc_k, a_k1, acc_n, wpack,
                                        lab, lab_safe, steps, ws, out, width,
                                        n_ctas, smem,
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
                        int n_ctas, int smem, void* stream) {
  return static_cast<int>(launch<true>(meta, a_k, acc_k, a_k1, acc_n, wpack,
                                       lab, lab_safe, steps, ws, out, width,
                                       n_ctas, smem,
                                       static_cast<cudaStream_t>(stream)));
}

// The current device's limits for the cluster route: *optin the shared
// memory a block may opt into, and *clusters how many clusters of n_ctas
// CTAs of the chain (tm = 0) or TM (tm = 1) kernel at `width`, each with
// smem bytes of dynamic shared memory, the device can hold at once (0:
// none, also where the bytes pass the opt-in).
extern "C" int chain_cluster_limits(int tm, int width, int n_ctas, int smem,
                                    int* optin, int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *clusters = 0;
  if (smem + static_cast<int>(sizeof(Shared)) > *optin) return 0;
  ClusterKernel kernel;
  if (width == 12) kernel = tm ? cluster_kernel<true, 12>()
                               : cluster_kernel<false, 12>();
  else if (width == 16) kernel = tm ? cluster_kernel<true, 16>()
                                    : cluster_kernel<false, 16>();
  else return static_cast<int>(cudaErrorInvalidValue);
  err = opt_in(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(n_ctas, static_cast<size_t>(smem), nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg));
}

extern "C" const char* chain_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* tm_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* chain_cluster_limits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
