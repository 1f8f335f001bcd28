// Block-table KV gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_gather.py::
// paged_gather_kernel.  out[b, j] = pool[table[b, j]]: a pure copy of whole
// KV blocks, pool (NB, bs, H, D) and table (B, nb) -> out (B, nb, bs, H, D).
//
// Bound: bytes.  Every gathered block is read once and written once, with
// no arithmetic.  Design: one thread block per (b, j) pair reads its own
// table entry (the TPU's scalar prefetch has no counterpart; the entry is
// one 4-byte load) and copies the block's bs*H*D elements with 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses.
// A block of the pool is contiguous, so the copy is one straight run of
// block_bytes.  The wrapper clamps sentinel entries to NB - 1 beforehand,
// exactly as the plain version's index_select does, so the result is bit
// identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void paged_gather_kernel(const V* __restrict__ pool,
                                    const int32_t* __restrict__ table,
                                    V* __restrict__ out,
                                    long long vecs_per_block) {
  const long long row = blockIdx.x;                 // b * nb + j
  const long long phys = table[row];
  const V* src = pool + phys * vecs_per_block;
  V* dst = out + row * vecs_per_block;
  for (long long i = threadIdx.x; i < vecs_per_block; i += blockDim.x) {
    dst[i] = src[i];
  }
}

template <typename V>
cudaError_t launch(const void* pool, const void* table, void* out,
                   int n_rows, long long block_bytes, cudaStream_t stream) {
  const long long vecs = block_bytes / (long long)sizeof(V);
  const int threads = vecs >= 256 ? 256 : (vecs >= 32 ? 128 : 32);
  paged_gather_kernel<V><<<n_rows, threads, 0, stream>>>(
      static_cast<const V*>(pool), static_cast<const int32_t*>(table),
      static_cast<V*>(out), vecs);
  return cudaGetLastError();
}

}  // namespace

// pool: the (NB, bs, H, D) block pool; table: (n_rows,) int32 physical
// block ids, all < NB; out: (n_rows, bs, H, D).  block_bytes = bs*H*D*itemsize.
// The widest access that divides block_bytes and both pointers' alignment
// is used (16, 4 or 1 bytes).  Returns cudaGetLastError() after the launch.
extern "C" int paged_gather(const void* pool, const void* table, void* out,
                            int n_rows, long long block_bytes, void* stream) {
  if (n_rows == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(block_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return launch<int4>(pool, table, out, n_rows, block_bytes, s);
  if (align % 4 == 0) return launch<int32_t>(pool, table, out, n_rows, block_bytes, s);
  return launch<char>(pool, table, out, n_rows, block_bytes, s);
}

extern "C" const char* paged_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
