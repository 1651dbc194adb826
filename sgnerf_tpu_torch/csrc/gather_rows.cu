// K7: row gather out[s] = table[idx[s]], and its staged form (the probes P).
//
// Replaces the TPU kernel sgnerf_tpu/ops/pallas_gather.py
// `gather_rows_pallas` (body `_gather_kernel`), and the row copies and
// gathers of the TPU-toolchain probes (dev_scripts/probe_pallas_bisect*.py,
// probe_pallas_gather*.py). Function: each output row s is the table row
// idx[s], copied byte for byte, so any dtype works. Ids are clamped to
// [0, T): the callers pass clipped ids (the JAX entry requires them), and a
// stray id never reads outside the table.
//
// What bounds it on an H100: bytes. Every output row is one table row read
// from HBM and written once (a table larger than the 50 MB L2 sends the
// reads to HBM); there is no arithmetic.
//
// `gather_rows` (first form): the TPU kernel keeps `wave` row DMAs in
// flight on a semaphore ring. Here the threads of a warp copy through
// registers: the warp takes 32 * V consecutive vectors of the output
// (row-major, so a 640-byte row is 40 16-byte vectors), each lane loads its
// V vectors (unrolled, every load before the first store) and then
// stores them. V is the largest power of two at or below wave * (vectors a
// row) / 32, so a warp holds about `wave` rows in flight. Vectors are 16
// bytes when the row bytes and both base pointers allow it, else 8, 4, 2
// or 1.
//
// `gather_rows_staged` (the probes' VMEM-staged DMA ring): one thread of
// each warp runs a ring of `wave` shared-memory slots, one row each. A TMA
// 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) brings a row into
// its slot and signals the slot's mbarrier; a bulk store
// (cp.async.bulk.global.shared::cta) writes it out, and the slot is loaded
// again once that store has read it (bulk_group wait). Bulk copies move
// multiples of 16 bytes between 16-byte aligned addresses, so this form
// takes only such rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // gather_rows: threads a block
constexpr int kMaxStagedWarps = 4;         // staged: pipes (warps) a block
constexpr int kRowsPerPipe = 8;            // staged: waves of rows a pipe
constexpr size_t kMaxSmem = 232448;        // bytes of shared memory a block may use

template <typename Vec, int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table,
                   const int32_t* __restrict__ idx, Vec* __restrict__ out,
                   long long total, int nvec, int T) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                         (threadIdx.x >> 5);
  const long long base = warp * 32LL * V;
  // row and vector of the warp's first item, once; the rest in 32 bits
  const long long s0 = base / nvec;
  const int c0 = static_cast<int>(base - s0 * nvec);
  Vec buf[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int t = c0 + lane + 32 * k;
    if (base + lane + 32 * k < total) {
      const long long s = s0 + t / nvec;
      const int r = min(max(__ldg(idx + s), 0), T - 1);
      buf[k] = __ldg(table + static_cast<long long>(r) * nvec + t % nvec);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long i = base + lane + 32 * k;
    if (i < total) out[i] = buf[k];
  }
}

template <typename Vec>
int launch_vec(const void* table, const int32_t* idx, void* out, long long S,
               int row_bytes, int T, int wave, cudaStream_t stream) {
  const int nvec = row_bytes / static_cast<int>(sizeof(Vec));
  const long long total = S * nvec;
  long long want = static_cast<long long>(wave) * nvec / 32;
  int V = 1;
  while (V < 32 && 2LL * V <= want) V *= 2;
  const long long per_block = static_cast<long long>(kThreads) * V;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Vec* t = static_cast<const Vec*>(table);
  Vec* o = static_cast<Vec*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (V) {
#define SGNERF_GATHER_CASE(v)                                              \
  case v:                                                                  \
    gather_rows_kernel<Vec, v><<<grid, kThreads, 0, stream>>>(t, idx, o,   \
                                                              total, nvec, \
                                                              T);          \
    break;
    SGNERF_GATHER_CASE(1)
    SGNERF_GATHER_CASE(2)
    SGNERF_GATHER_CASE(4)
    SGNERF_GATHER_CASE(8)
    SGNERF_GATHER_CASE(16)
    SGNERF_GATHER_CASE(32)
#undef SGNERF_GATHER_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

__host__ __device__ inline size_t bar_bytes(int pipes, int wave) {
  return (static_cast<size_t>(pipes) * wave * sizeof(uint64_t) + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One pipe per warp (its lane 0): rows [begin, end) of the output through
// a ring of `wave` slots of row_bytes each.
__global__ void gather_rows_staged_kernel(const char* __restrict__ table,
                                          const int32_t* __restrict__ idx,
                                          char* __restrict__ out, long long S,
                                          int row_bytes, int T, int wave,
                                          long long rows_per_pipe) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0) return;
  const int pipes = blockDim.x >> 5;
  // [the pipes' mbarriers, padded to 16 bytes | the pipes' slots]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * wave;
  unsigned char* slots = smem + bar_bytes(pipes, wave) +
                         static_cast<size_t>(warp) * wave * row_bytes;
  const long long pipe = static_cast<long long>(blockIdx.x) * pipes + warp;
  const long long begin = pipe * rows_per_pipe;
  const long long end = min(S, begin + rows_per_pipe);
  if (begin >= end) return;
  const long long n = end - begin;
  for (int k = 0; k < wave; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + k))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t bytes = static_cast<uint32_t>(row_bytes);
  auto src_row = [&](long long j) {
    const int r = min(max(__ldg(idx + begin + j), 0), T - 1);
    return table + static_cast<long long>(r) * row_bytes;
  };
  for (long long j = 0; j < n && j < wave; ++j)
    bulk_load(smem_addr(slots + j * row_bytes), src_row(j), bytes,
              smem_addr(bars + j));
  for (long long j = 0; j < n; ++j) {
    const int slot = static_cast<int>(j % wave);
    bar_wait(smem_addr(bars + slot), static_cast<uint32_t>((j / wave) & 1));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            out + (begin + j) * row_bytes),
        "r"(smem_addr(slots + static_cast<size_t>(slot) * row_bytes)), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // Load a slot again once its store has read it: the previous store's
    // slot, so this store stays in flight, except with a single slot,
    // whose next row must arrive before the next wait
    long long prev = j - 1;
    if (wave == 1) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      prev = j;
    } else {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    if (prev >= 0 && prev + wave < n) {
      const int ps = static_cast<int>(prev % wave);
      bulk_load(smem_addr(slots + static_cast<size_t>(ps) * row_bytes),
                src_row(prev + wave), bytes, smem_addr(bars + ps));
    }
  }
  // every store complete before the pipe's slots go away
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table (T, row_bytes) bytes, idx (S,) int32 -> out (S, row_bytes) bytes.
// 1 <= wave <= 1024. Launches on `stream`; returns cudaGetLastError().
int gather_rows(const void* table, const int32_t* idx, void* out, long long S,
                int row_bytes, int T, int wave, cudaStream_t stream) {
  if (S < 0 || row_bytes < 1 || T < 1 || wave < 1 || wave > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (a % 16 == 0) return launch_vec<int4>(table, idx, out, S, row_bytes, T, wave, stream);
  if (a % 8 == 0) return launch_vec<int2>(table, idx, out, S, row_bytes, T, wave, stream);
  if (a % 4 == 0) return launch_vec<int>(table, idx, out, S, row_bytes, T, wave, stream);
  if (a % 2 == 0) return launch_vec<short>(table, idx, out, S, row_bytes, T, wave, stream);
  return launch_vec<char>(table, idx, out, S, row_bytes, T, wave, stream);
}

// The staged form: the same function through shared memory by TMA bulk
// copies. row_bytes a multiple of 16, table and out 16-byte aligned, and
// one pipe's wave * (row_bytes + 8) bytes of shared memory within 227 KB.
int gather_rows_staged(const void* table, const int32_t* idx, void* out,
                       long long S, int row_bytes, int T, int wave,
                       cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if (S < 0 || row_bytes < 16 || a % 16 != 0 || T < 1 || wave < 1 ||
      wave > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto smem_of = [&](int w) {
    return bar_bytes(w, wave) + static_cast<size_t>(w) * wave * row_bytes;
  };
  int warps = kMaxStagedWarps;
  while (warps > 1 && smem_of(warps) > kMaxSmem) --warps;
  const size_t smem = smem_of(warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      gather_rows_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows_per_pipe = static_cast<long long>(kRowsPerPipe) * wave;
  const long long pipes = (S + rows_per_pipe - 1) / rows_per_pipe;
  const long long blocks = (pipes + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_staged_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                              stream>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(out), S,
      row_bytes, T, wave, rows_per_pipe);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
