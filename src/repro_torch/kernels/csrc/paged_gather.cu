// Block-table KV gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_gather.py::
// paged_gather_kernel.  out[b, j] = pool[table[b, j]]: a pure copy of whole
// KV blocks, pool (NB, bs, H, D) and table (B, nb) -> out (B, nb, bs, H, D).
// The pair entry gathers two pools (a layer's K and V) through one table
// in one launch: grid (chunks, 2), blockIdx.y picks the leaf.
//
// Bound: bytes.  Every gathered block is read once and written once, with
// no arithmetic.  At the serving path's shape (pool (256, 32, 2, 64) bf16,
// 4 x 32 table entries, 8 KiB blocks) the whole copy is 1 MiB a leaf, so
// its time is a launch and a few trips to memory: the design keeps every
// block of the gather in flight at once and puts nothing else on the path.
//
// * The table is read as it comes, int32 or int64, and an entry >= NB --
//   the unallocated sentinel NB -- reads block NB - 1, exactly as the plain
//   version's index_select on the clamped table does (a negative entry,
//   which no caller passes, reads NB - 1 too rather than memory before the
//   pool).  So the wrapper launches no cast and no clamp kernel.
// * Bulk route, where both pools, both outputs and the block size are on
//   16-byte boundaries: a thread block copies one chunk of up to kChunk
//   bytes of one block.  One thread reads its table entry, asks the copy
//   engine for the whole chunk (cp.async.bulk into shared memory,
//   completed on an mbarrier) and, when it has landed, writes it out with
//   one cp.async.bulk from shared memory.  Every chunk of the gather is
//   then in flight in one memory round trip, and no thread spends
//   registers or instructions on addresses.
// * Vector route, everywhere else (and selectable for comparison): 128
//   threads copy a tile of kVecUnroll vectors each, every load of the tile
//   made before any store; 16-, 4- or 1-byte vectors, the widest that
//   divides both pointers and the block size.
// * The kernel is launched with programmatic dependent launch (kPdl), so
//   its launch and its blocks' set-up overlap the end of the kernel before
//   it; each block waits (griddepcontrol.wait) before it reads the table or
//   a pool, either of which that kernel may have written.  Reading the
//   table before the wait measured the same (experiments/
//   paged_gather_variants.py, variant "early") and would race a table
//   written by the kernel just before.
//
// The result is a copy, so it is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr bool kPdl = true;         // programmatic dependent launch
constexpr int kChunk = 16384;       // bytes a bulk thread block copies
constexpr int kVecThreads = 128;
constexpr int kVecUnroll = 4;       // vectors a thread holds at once

struct Leaves {                     // up to two pools gathered together
  const char* pool[2];
  char* out[2];
};

// Table entry i as a physical block id in [0, NB).
__device__ __forceinline__ long long block_id(const void* table, int is64,
                                              long long i, long long NB) {
  const long long e = is64 ? static_cast<const long long*>(table)[i]
                           : static_cast<const int32_t*>(table)[i];
  return static_cast<unsigned long long>(e) >=
                 static_cast<unsigned long long>(NB)
             ? NB - 1
             : e;
}

__device__ __forceinline__ void wait_for_producer() {
  if (kPdl) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
gather_bulk_kernel(Leaves lv, const void* __restrict__ table, int is64,
                   long long NB, long long block_bytes, int chunks) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;               // one thread drives the copy
  const long long row = blockIdx.x / chunks;
  const long long off = (long long)(blockIdx.x % chunks) * kChunk;
  const uint32_t n = (uint32_t)(block_bytes - off < kChunk ? block_bytes - off
                                                           : kChunk);
  wait_for_producer();
  const long long phys = block_id(table, is64, row, NB);
  const char* src = (blockIdx.y ? lv.pool[1] : lv.pool[0]) +
                    phys * block_bytes + off;
  char* dst = (blockIdx.y ? lv.out[1] : lv.out[0]) + row * block_bytes + off;
  const uint32_t b = smem_u32(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(n)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(buf)),
      "l"(src), "r"(n), "r"(b)
      : "memory");
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(buf)), "r"(n)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <typename V>
__global__ void __launch_bounds__(kVecThreads)
gather_vec_kernel(Leaves lv, const void* __restrict__ table, int is64,
                  long long NB, long long vecs, int tiles) {
  const long long row = blockIdx.x / tiles;
  const long long base =
      (long long)(blockIdx.x % tiles) * (kVecThreads * kVecUnroll) +
      threadIdx.x;
  wait_for_producer();
  const long long phys = block_id(table, is64, row, NB);
  const V* __restrict__ src =
      reinterpret_cast<const V*>(blockIdx.y ? lv.pool[1] : lv.pool[0]) +
      phys * vecs;
  V* __restrict__ dst =
      reinterpret_cast<V*>(blockIdx.y ? lv.out[1] : lv.out[0]) + row * vecs;
  V r[kVecUnroll];
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = base + u * kVecThreads;
    if (i < vecs) r[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = base + u * kVecThreads;
    if (i < vecs) dst[i] = r[u];
  }
}

template <typename Kernel, typename... Args>
cudaError_t start(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kPdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename V>
cudaError_t launch_vec(const Leaves& lv, int n_leaves, const void* table,
                       int is64, long long NB, int n_rows,
                       long long block_bytes, cudaStream_t s) {
  const long long vecs = block_bytes / (long long)sizeof(V);
  const long long tile = (long long)kVecThreads * kVecUnroll;
  const int tiles = (int)((vecs + tile - 1) / tile);
  return start(gather_vec_kernel<V>, dim3((unsigned)(n_rows * tiles),
                                          n_leaves),
               kVecThreads, 0, s, lv, table, is64, NB, vecs, tiles);
}

// route: 0 the rule (bulk where aligned), 1 the vector route
cudaError_t launch(const Leaves& lv, int n_leaves, const void* table,
                   int is64, long long NB, int n_rows, long long block_bytes,
                   int route, cudaStream_t s) {
  if (n_rows == 0 || block_bytes == 0) return cudaSuccess;
  uintptr_t align = static_cast<uintptr_t>(block_bytes);
  for (int l = 0; l < n_leaves; ++l) {
    align |= reinterpret_cast<uintptr_t>(lv.pool[l]) |
             reinterpret_cast<uintptr_t>(lv.out[l]);
  }
  if (route == 0 && align % 16 == 0) {
    const int chunks = (int)((block_bytes + kChunk - 1) / kChunk);
    const size_t smem = block_bytes < kChunk ? block_bytes : kChunk;
    return start(gather_bulk_kernel, dim3((unsigned)(n_rows * chunks),
                                          n_leaves),
                 32, smem, s, lv, table, is64, NB, block_bytes, chunks);
  }
  if (align % 16 == 0)
    return launch_vec<int4>(lv, n_leaves, table, is64, NB, n_rows,
                            block_bytes, s);
  if (align % 4 == 0)
    return launch_vec<int32_t>(lv, n_leaves, table, is64, NB, n_rows,
                               block_bytes, s);
  return launch_vec<char>(lv, n_leaves, table, is64, NB, n_rows, block_bytes,
                          s);
}

}  // namespace

// pool: the (NB, bs, H, D) block pool; table: (n_rows,) block ids, int64
// where is64 else int32, each >= NB read as NB - 1; out: (n_rows, bs, H, D).
// block_bytes = bs*H*D*itemsize.  route 0 takes the bulk route where every
// pointer and block_bytes are on 16-byte boundaries, route 1 the vector
// route.  Returns cudaGetLastError() after the launch.
extern "C" int paged_gather(const void* pool, const void* table, void* out,
                            int n_rows, long long NB, long long block_bytes,
                            int is64, int route, void* stream) {
  Leaves lv = {{static_cast<const char*>(pool), nullptr},
               {static_cast<char*>(out), nullptr}};
  return static_cast<int>(launch(lv, 1, table, is64, NB, n_rows, block_bytes,
                                 route, static_cast<cudaStream_t>(stream)));
}

// The same for two pools of one shape and type (a layer's K and V) through
// one table, in one launch.
extern "C" int paged_gather_pair(const void* k_pool, const void* v_pool,
                                 const void* table, void* k_out, void* v_out,
                                 int n_rows, long long NB,
                                 long long block_bytes, int is64, int route,
                                 void* stream) {
  Leaves lv = {{static_cast<const char*>(k_pool),
                static_cast<const char*>(v_pool)},
               {static_cast<char*>(k_out), static_cast<char*>(v_out)}};
  return static_cast<int>(launch(lv, 2, table, is64, NB, n_rows, block_bytes,
                                 route, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* paged_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* paged_gather_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
