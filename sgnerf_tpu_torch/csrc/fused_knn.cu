// K1: fused K-nearest select over gathered merged-neighbourhood cache rows.
//
// Replaces the TPU kernel sgnerf_tpu/ops/fused_knn.py `fused_knn_select`
// (body `_kernel` and `_select_k`). Function, per shading point m:
//   * decode C candidates from one planar int16 cache row
//     [x(C) | y(C) | z(C) | id_lo(C) | id_hi(C)]: bf16 offsets from the voxel
//     centre and int32 point ids;
//   * d2 = |offset - delta[m]|^2, with delta = shading point - voxel centre;
//   * reject ids < 0, slot_ok[m] == 0 and d2 > r2 (r2 <= 0 disables);
//   * K rounds of argmin on (d2, candidate index): the smallest d2, ties to
//     the lowest index (XLA top_k order); -1 once no valid candidate is left.
//
// What bounds it on an H100: bytes. Each shading point reads one 640-byte
// row (C = 64) and 16 bytes of delta/ok and writes 32 bytes; the arithmetic
// is ~10 flops per candidate. Design: one warp per shading point, two
// candidates per lane, so a row is read by 32 lanes in 64-byte coalesced
// segments per plane and never leaves registers. Each round is one
// butterfly of __shfl_xor_sync over the (d2, index) pair; the winning lane
// clears its candidate. The TPU kernel's `lane << 25 | id` packed min is a
// lane-reduction trick of that chip and is not carried over: ids are any
// int32 here. d2 uses __fmul_rn/__fadd_rn so nvcc cannot contract it into
// FMAs: the ids then equal the plain PyTorch version's bit for bit.
//
// K6: the same select over per-tile distinct rows (`knn_mode="dedup"`).
// Replaces sgnerf_tpu/ops/fused_knn.py `fused_knn_select_tiled`
// (`_kernel_tiled`). Rays of neighbouring pixels cross the same voxels, so
// a tile of T consecutive shading points gathers each distinct cache row
// once (`tile_unique`, U rows a tile) and point m reads row inv[m] of its
// tile (inv == U: invalid or overflowed, no neighbours). The TPU kernel
// redistributes rows with a one-hot matmul and carries ids as 8-bit limbs
// (exact below 2^24); here a block stages its tile's U rows in shared
// memory (U = 160, C = 64: 100 KB) and each warp runs K1's select on the
// staged row, so ids are any int32. Bound by bytes: the tile rows, inv,
// delta and ok are read once, the ids written once.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPointsPerTiledBlock = 256;  // K6: points of a tile a block takes
constexpr size_t kMaxSmem = 232448;        // bytes of shared memory a block may use

__device__ __forceinline__ float bf16_bits(int16_t b) {
  return __uint_as_float(static_cast<uint32_t>(static_cast<uint16_t>(b)) << 16);
}

// One warp selects the K nearest of the C candidates of `row` (a planar
// cache row in global or shared memory) for the point at delta (px,py,pz)
// and writes them to out[0..K). ok = false rejects every candidate.
__device__ __forceinline__ void warp_select(const int16_t* row, float px,
                                            float py, float pz, bool ok,
                                            float r2, int C, int K, int lane,
                                            int32_t* out) {
  float d0 = FLT_MAX, d1 = FLT_MAX;
  int32_t p0 = -1, p1 = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    if (c < C) {
      const float ex = __fsub_rn(bf16_bits(row[c]), px);
      const float ey = __fsub_rn(bf16_bits(row[C + c]), py);
      const float ez = __fsub_rn(bf16_bits(row[2 * C + c]), pz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                 __fmul_rn(ez, ez));
      const uint32_t lo = static_cast<uint16_t>(row[3 * C + c]);
      const uint32_t hi = static_cast<uint16_t>(row[4 * C + c]);
      const int32_t pid = static_cast<int32_t>((hi << 16) | lo);
      const bool valid = ok && pid >= 0 && (dd <= r2 || r2 <= 0.0f);
      if (h == 0) {
        d0 = valid ? dd : FLT_MAX;
        p0 = pid;
      } else {
        d1 = valid ? dd : FLT_MAX;
        p1 = pid;
      }
    }
  }

  for (int r = 0; r < K; ++r) {
    // lane-local best; candidate `lane` precedes `lane + 32` on ties
    float bd = d0;
    int bi = lane;
    if (d1 < d0) {
      bd = d1;
      bi = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int owner = bi & 31;
    const int32_t q0 = __shfl_sync(kFull, p0, owner);
    const int32_t q1 = __shfl_sync(kFull, p1, owner);
    if (lane == 0) out[r] = bd < FLT_MAX ? (bi < 32 ? q0 : q1) : -1;
    if (lane == owner) {
      if (bi < 32) d0 = FLT_MAX; else d1 = FLT_MAX;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_knn_kernel(const int16_t* __restrict__ rows,
                 const float* __restrict__ delta,
                 const uint8_t* __restrict__ slot_ok, float r2, int M, int C,
                 int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // m is uniform across the warp
  warp_select(rows + static_cast<size_t>(m) * 5 * C, delta[3 * m],
              delta[3 * m + 1], delta[3 * m + 2], slot_ok[m] != 0, r2, C, K,
              lane, out + static_cast<size_t>(m) * K);
}

// K6: block (tile, part) stages the tile's U distinct rows in shared memory,
// then its warps take the part's points in turn; point m reads row inv[m]
// (inv == U: no row, every candidate rejected).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_knn_tiled_kernel(const int16_t* __restrict__ rows,
                       const int32_t* __restrict__ inv,
                       const float* __restrict__ delta,
                       const uint8_t* __restrict__ slot_ok, float r2, int T,
                       int U, int C, int K, int pts_per_block,
                       int32_t* __restrict__ out) {
  extern __shared__ int4 staged[];
  int16_t* trows = reinterpret_cast<int16_t*>(staged);
  const int tile = blockIdx.x;
  const size_t row_len = static_cast<size_t>(5) * C;
  const int16_t* src = rows + static_cast<size_t>(tile) * U * row_len;
  const size_t n16 = static_cast<size_t>(U) * row_len;
  if (n16 % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // 16-byte copies (C = 64: 640-byte rows)
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (size_t i = threadIdx.x; i < n16 / 8; i += blockDim.x) staged[i] = s4[i];
  } else {
    for (size_t i = threadIdx.x; i < n16; i += blockDim.x) trows[i] = src[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int begin = blockIdx.y * pts_per_block;
  const int end = min(T, begin + pts_per_block);
  for (int p = begin + (threadIdx.x >> 5); p < end; p += kWarpsPerBlock) {
    const size_t m = static_cast<size_t>(tile) * T + p;
    const int v = inv[m];
    warp_select(trows + static_cast<size_t>(v < U ? v : U - 1) * row_len,
                delta[3 * m], delta[3 * m + 1], delta[3 * m + 2],
                slot_ok[m] != 0 && v < U, r2, C, K, lane, out + m * K);
  }
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows (M, 5C) int16, delta (M, 3) f32, slot_ok (M,) uint8 -> out (M, K)
// int32. C <= 64, 1 <= K <= C. Launches on `stream`; returns
// cudaGetLastError() after the launch.
int fused_knn_select(const int16_t* rows, const float* delta,
                     const uint8_t* slot_ok, float r2, int M, int C, int K,
                     int32_t* out, cudaStream_t stream) {
  if (C < 1 || C > 64 || K < 1 || K > C || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int blocks = (M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_knn_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      rows, delta, slot_ok, r2, M, C, K, out);
  return static_cast<int>(cudaGetLastError());
}

// K6. rows (nt*U, 5C) int16: tile t's distinct rows at t*U..t*U+U-1;
// inv (nt*T,) int32 in [0, U] (U: no row), delta (nt*T, 3) f32, slot_ok
// (nt*T,) uint8 -> out (nt*T, K) int32. C <= 64, 1 <= K <= C, U * 10 C
// bytes of shared memory within 227 KB. Launches on `stream`; returns
// cudaGetLastError().
int fused_knn_select_tiled(const int16_t* rows, const int32_t* inv,
                           const float* delta, const uint8_t* slot_ok,
                           float r2, int nt, int T, int U, int C, int K,
                           int32_t* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(U) * 5 * C * sizeof(int16_t);
  if (C < 1 || C > 64 || K < 1 || K > C || nt < 0 || T < 1 || U < 1 ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_knn_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nt, (T + kPointsPerTiledBlock - 1) / kPointsPerTiledBlock);
  fused_knn_tiled_kernel<<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      rows, inv, delta, slot_ok, r2, T, U, C, K, kPointsPerTiledBlock, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
