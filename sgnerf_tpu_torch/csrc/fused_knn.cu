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
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_bits(int16_t b) {
  return __uint_as_float(static_cast<uint32_t>(static_cast<uint16_t>(b)) << 16);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_knn_kernel(const int16_t* __restrict__ rows,
                 const float* __restrict__ delta,
                 const uint8_t* __restrict__ slot_ok, float r2, int M, int C,
                 int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // m is uniform across the warp
  const int16_t* row = rows + static_cast<size_t>(m) * 5 * C;
  const float px = delta[3 * m], py = delta[3 * m + 1], pz = delta[3 * m + 2];
  const bool ok = slot_ok[m] != 0;

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
    if (lane == 0)
      out[static_cast<size_t>(m) * K + r] = bd < FLT_MAX ? (bi < 32 ? q0 : q1) : -1;
    if (lane == owner) {
      if (bi < 32) d0 = FLT_MAX; else d1 = FLT_MAX;
    }
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

}  // extern "C"
