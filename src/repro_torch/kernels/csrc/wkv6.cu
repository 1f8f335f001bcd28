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
//   s_ij  = w_i s_ij + kv_ij
//
// r, k, v, w, y: (B, S, H, HD) f32, contiguous; u: (H, HD); s0, sS:
// (B, H, HD, HD).
//
// Bound: bytes.  A step reads r, k, v, w and writes y, 20 bytes a channel,
// and the state is read and written once a launch; the ~5 flops a state
// entry a step are far below the card's rate.  Parallelism comes only from
// the B * H chains, each sequential in t.
//
// Design (the first, simple one).  One block of HD threads per (h, b);
// thread j keeps column s[:, j] in HD registers for the whole launch.  Each
// step, thread j puts (r_j, k_j, w_j, u_j) into a float4 slot of shared
// memory, double-buffered so that one barrier a step suffices (a thread
// writes step t + 1's buffer only after the barrier of step t, which every
// thread passes only once done with step t - 1's), keeps v_j in a
// register, and loads the next step's r, k, w, v while this one computes.
// The output adds in i order from the state before the step; then the
// state update is __fadd_rn(__fmul_rn(w_i, s_ij), kv_ij) with kv_ij =
// __fmul_rn(k_i, v_j) rounded once and used by both: the plain version's
// two eager ops, so the final state is bit-identical to it.
//
// __launch_bounds__(HD, 1): the kernel asks for one block a multiprocessor,
// so ptxas may give a thread the registers to hold its state column and
// several of a step's shared-memory loads in flight (at HD = 64, 151
// registers against 96 and a spill without the second argument, and a
// step 2.2-2.7 times as fast on an H100: experiments/wkv6_variants.py,
// variant lb0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sS, int S, int H) {
  __shared__ float4 step_in[2][HD];     // (r_i, k_i, w_i, u_i)
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float uj = u[h * HD + j];

  const size_t state = (static_cast<size_t>(b) * H + h) * HD * HD;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[state + i * HD + j];

  // element j of (b, t, h): ((b * S + t) * H + h) * HD + j
  const size_t t_stride = static_cast<size_t>(H) * HD;
  size_t at = (static_cast<size_t>(b) * S * H + h) * HD + j;
  float nr = r[at], nk = k[at], nv = v[at], nw = w[at];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    step_in[buf][j] = make_float4(nr, nk, nw, uj);
    const float vj = nv;
    const size_t here = at;
    if (t + 1 < S) {                    // the next step's inputs, in flight
      at += t_stride;                   // while this one computes
      nr = r[at];
      nk = k[at];
      nv = v[at];
      nw = w[at];
    }
    __syncthreads();
    float out = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float4 e = step_in[buf][i];                // broadcast
      const float kv = __fmul_rn(e.y, vj);
      out = fmaf(e.x, __fadd_rn(s[i], __fmul_rn(e.w, kv)), out);
      s[i] = __fadd_rn(__fmul_rn(e.z, s[i]), kv);
    }
    y[here] = out;
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sS[state + i * HD + j] = s[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sS, int B, int S,
           int H, cudaStream_t stream) {
  wkv6_kernel<HD><<<dim3(H, B), HD, 0, stream>>>(r, k, v, w, u, s0, y, sS,
                                                  S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv6(const void* r_, const void* k_, const void* v_,
                    const void* w_, const void* u_, const void* s0_, void* y_,
                    void* sS_, int B, int S, int H, int hd, void* stream_) {
  const float* r = static_cast<const float*>(r_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  const float* w = static_cast<const float*>(w_);
  const float* u = static_cast<const float*>(u_);
  const float* s0 = static_cast<const float*>(s0_);
  float* y = static_cast<float*>(y_);
  float* sS = static_cast<float*>(sS_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, y, sS, B, S, H, stream);
    case 32:
      return launch<32>(r, k, v, w, u, s0, y, sS, B, S, H, stream);
    case 64:
      return launch<64>(r, k, v, w, u, s0, y, sS, B, S, H, stream);
    case 128:
      return launch<128>(r, k, v, w, u, s0, y, sS, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
