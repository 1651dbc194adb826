// K1 and K6: the K-nearest select over merged-neighbourhood cache rows.
//
// K1 replaces the TPU kernel sgnerf_tpu/ops/fused_knn.py `fused_knn_select`
// (body `_kernel` and `_select_k`); K6 replaces `fused_knn_select_tiled`
// (`_kernel_tiled`), the same select over per-tile distinct rows
// (`knn_mode="dedup"`). Function, per shading point m:
//   * decode C candidates from one planar int16 cache row
//     [x(C) | y(C) | z(C) | id_lo(C) | id_hi(C)]: bf16 offsets from the voxel
//     centre and int32 point ids;
//   * d2 = |offset - delta[m]|^2, with delta = shading point - voxel centre;
//   * reject ids < 0, slot_ok[m] == 0 and d2 > r2 (r2 <= 0 disables);
//   * the K smallest (d2, candidate index) in order, ties to the lowest
//     index (XLA top_k order); -1 once no valid candidate is left.
// d2 uses __fmul_rn/__fadd_rn so nvcc cannot contract it into FMAs: the ids
// equal the plain PyTorch version's bit for bit. A valid d2 is a finite
// non-negative f32 below FLT_MAX, so it orders as its unsigned bits; a
// rejected candidate (or a d2 the plain version would also leave at -1)
// takes the key 0xffffffff, above every valid one.
//
// What bounds K1 on an H100: bytes. A point reads one 640-byte row (C = 64)
// and 16 bytes of delta/ok and writes 32 bytes; at the eval chunk (221,184
// points) that is 0.045 ms at 3.35 TB/s. Its first port (one warp a point,
// K rounds of a 5-step (d2, index) butterfly, ~96 shuffles a point at
// K = 8, all on one serial chain) was bound by the select instead: 0.222 ms.
//
// The select here: 8 lanes a point, 4 points a warp. Lane g of a point
// takes the candidates c = g*N .. g*N+N-1 (N = ceil(C/8)); at C = 64 it
// reads each plane as one 16-byte load, the point's 8 lanes on 128
// contiguous bytes. Each lane sorts its N keys in registers (odd-even
// transposition: stable, so equal d2 stay in index order), then the 8
// sorted lists are merged K times: the point's smallest head key by 3
// __shfl_xor_sync steps, and of the lanes whose head equals it the lowest
// (one __ballot_sync) wins, since a lower lane holds lower indices. The
// winner writes its head's id and pops it. That is 3 shuffles a round for
// 4 points, ~6 a point at K = 8, and a warp stops early once every point
// of it is out of candidates. The list length is N <= 8 whatever K is, so
// every 1 <= K <= C <= 64 runs on the same code.
//
// K6: rays of neighbouring pixels cross the same voxels, so a tile of T
// consecutive shading points gathers each distinct cache row once
// (`tile_unique`, U rows a tile) and point m reads row inv[m] of its tile
// (inv == U: invalid or overflowed, no neighbours). The TPU kernel
// redistributes rows with a one-hot matmul and carries ids as 8-bit limbs;
// here the rows are staged in shared memory and read by K1's select, so
// ids are any int32. Its first port staged a whole tile in each of the 6
// blocks that shared it (100 KB at U = 160, 2 blocks an SM) and was bound
// by the shuffle select (0.317 ms against a 0.0076 ms bytes bound). Now a
// persistent grid (the blocks that fit on the card at once) splits the
// points into one contiguous range a block, so the work is even; a block
// stages each tile its range touches once and selects its points from
// shared memory. The C entry works the grid out itself (k6_grid: SMs x
// resident blocks an SM, then an even split of the points). At the eval
// chunk (264 blocks of 838 points, tiles of 1536) a tile is staged by the
// 2 or 3 blocks whose ranges meet it, 407 stagings against the first
// port's 864; the row table (14.7 MB) fits the 50 MB L2, so only a tile's
// first staging needs to read device memory.
// Rows stay unpadded (stride 10 C bytes):
// a 16-byte shared load is served a quarter-warp at a time, and a quarter
// warp is one point's 8 lanes on 128 contiguous bytes, so it meets no bank
// conflict.
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                    // lanes a shading point
constexpr int kThreads = 256;                // K1's block
constexpr int kTiledThreads = 512;           // K6's block
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;      // key of a rejected candidate
constexpr size_t kMaxSmem = 232448;          // shared memory a block may use

// bf16 in the low / high half of a 32-bit word, as f32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t candidate_key(float x, float y, float z,
                                                  int32_t pid, float px,
                                                  float py, float pz, bool ok,
                                                  float r2) {
  const float ex = __fsub_rn(x, px);
  const float ey = __fsub_rn(y, py);
  const float ez = __fsub_rn(z, pz);
  const float dd = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                             __fmul_rn(ez, ez));
  const bool valid = ok && pid >= 0 && (dd <= r2 || r2 <= 0.0f) &&
                     dd < FLT_MAX;
  return valid ? __float_as_uint(dd) : kNone;
}

// Lane g's N keys and ids of `row` (planar, global or shared memory). VEC:
// C = 64, N = 8 and a 16-byte aligned row: one 16-byte load a plane.
template <int N, bool VEC>
__device__ __forceinline__ void lane_keys(const int16_t* row, int C, int g,
                                          float px, float py, float pz,
                                          bool ok, float r2,
                                          uint32_t (&key)[N],
                                          int32_t (&pid)[N]) {
  if constexpr (VEC) {
    static_assert(N == 8, "the 16-byte path takes 8 candidates a lane");
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4 vx = r4[g], vy = r4[8 + g], vz = r4[16 + g];
    const uint4 vl = r4[24 + g], vh = r4[32 + g];
    const uint32_t wx[4] = {vx.x, vx.y, vx.z, vx.w};
    const uint32_t wy[4] = {vy.x, vy.y, vy.z, vy.w};
    const uint32_t wz[4] = {vz.x, vz.y, vz.z, vz.w};
    const uint32_t wl[4] = {vl.x, vl.y, vl.z, vl.w};
    const uint32_t wh[4] = {vh.x, vh.y, vh.z, vh.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int w = i >> 1;
      const bool hi = i & 1;
      const float x = hi ? bf16_hi(wx[w]) : bf16_lo(wx[w]);
      const float y = hi ? bf16_hi(wy[w]) : bf16_lo(wy[w]);
      const float z = hi ? bf16_hi(wz[w]) : bf16_lo(wz[w]);
      // id = hi16 << 16 | lo16 of the element's halves
      pid[i] = static_cast<int32_t>(
          __byte_perm(wl[w], wh[w], hi ? 0x7632 : 0x5410));
      key[i] = candidate_key(x, y, z, pid[i], px, py, pz, ok, r2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = g * N + i;
      key[i] = kNone;
      pid[i] = -1;
      if (c < C) {
        const auto u = [&](int plane) {
          return static_cast<uint32_t>(
              static_cast<uint16_t>(row[plane * C + c]));
        };
        pid[i] = static_cast<int32_t>((u(4) << 16) | u(3));
        key[i] = candidate_key(bf16_lo(u(0)), bf16_lo(u(1)), bf16_lo(u(2)),
                               pid[i], px, py, pz, ok, r2);
      }
    }
  }
}

// Sorts a lane's (key, id) pairs by key; equal keys keep their order.
template <int N>
__device__ __forceinline__ void lane_sort(uint32_t (&key)[N],
                                          int32_t (&pid)[N]) {
#pragma unroll
  for (int pass = 0; pass < N; ++pass) {
#pragma unroll
    for (int i = pass & 1; i + 1 < N; i += 2) {
      const bool swap = key[i] > key[i + 1];
      const uint32_t k0 = key[i], k1 = key[i + 1];
      const int32_t p0 = pid[i], p1 = pid[i + 1];
      key[i] = swap ? k1 : k0;
      key[i + 1] = swap ? k0 : k1;
      pid[i] = swap ? p1 : p0;
      pid[i + 1] = swap ? p0 : p1;
    }
  }
}

// The K rounds of a warp's 4 points: each point's smallest head key over
// its 8 lanes; the lowest lane holding it writes its id (-1 once the point
// has no candidate left) to out[r] and pops it. Every lane of the warp
// calls this; `live` is false for a point past the end (it writes nothing).
template <int N>
__device__ __forceinline__ void merge_rounds(uint32_t (&key)[N],
                                             int32_t (&pid)[N], int K,
                                             int lane, bool live,
                                             int32_t* out) {
  const int g = lane & (kLanes - 1);
  const int base = lane & ~(kLanes - 1);
  for (int r = 0; r < K; ++r) {
    uint32_t m = key[0];
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const uint32_t o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    if (__all_sync(kFull, m == kNone)) {   // every point of the warp is done
      if (live)
        for (int j = r + g; j < K; j += kLanes) out[j] = -1;
      return;
    }
    const unsigned ties = (__ballot_sync(kFull, key[0] == m) >> base) & 0xffu;
    if (g == __ffs(ties) - 1) {
      if (live) out[r] = m != kNone ? pid[0] : -1;
#pragma unroll
      for (int i = 0; i + 1 < N; ++i) {
        key[i] = key[i + 1];
        pid[i] = pid[i + 1];
      }
      key[N - 1] = kNone;
    }
  }
}

template <int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_knn_kernel(const int16_t* __restrict__ rows,
                 const float* __restrict__ delta,
                 const uint8_t* __restrict__ slot_ok, float r2, int M, int C,
                 int K, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * (kThreads / kLanes) +
                    (threadIdx.x >> 5) * (32 / kLanes);
  if (first >= M) return;                  // the warp's 4 points are past M
  const int m = first + lane / kLanes;
  const bool live = m < M;
  uint32_t key[N];
  int32_t pid[N];
  const size_t mm = live ? static_cast<size_t>(m) : 0;
  lane_keys<N, VEC>(rows + mm * 5 * C, C, lane & (kLanes - 1), delta[3 * mm],
                    delta[3 * mm + 1], delta[3 * mm + 2],
                    live && slot_ok[mm] != 0, r2, key, pid);
  lane_sort<N>(key, pid);
  merge_rounds<N>(key, pid, K, lane, live, out + mm * K);
}

// K6: block b takes points [b * per_block, min(M, (b + 1) * per_block)),
// stages each tile its range touches once and selects that tile's points
// of the range from shared memory, 4 points a warp (inv == U: no row).
template <int N, bool VEC>
__global__ void __launch_bounds__(kTiledThreads, 2)
fused_knn_tiled_kernel(const int16_t* __restrict__ rows,
                       const int32_t* __restrict__ inv,
                       const float* __restrict__ delta,
                       const uint8_t* __restrict__ slot_ok, float r2, int M,
                       int T, int U, int C, int K, int per_block,
                       int32_t* __restrict__ out) {
  extern __shared__ int4 staged[];
  const int16_t* trows = reinterpret_cast<const int16_t*>(staged);
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * per_block;
  const int p1 = min(M, p0 + per_block);
  const size_t row_len = static_cast<size_t>(5) * C;
  const size_t n16 = static_cast<size_t>(U) * row_len;
  for (int t = p0 / T; t * T < p1; ++t) {
    __syncthreads();                       // the last tile's readers are done
    const int16_t* src = rows + static_cast<size_t>(t) * n16;
    if (n16 % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      for (size_t i = threadIdx.x; i < n16 / 8; i += blockDim.x)
        staged[i] = s4[i];
    } else {
      int16_t* d = reinterpret_cast<int16_t*>(staged);
      for (size_t i = threadIdx.x; i < n16; i += blockDim.x) d[i] = src[i];
    }
    __syncthreads();
    const int a = max(p0, t * T), b = min(p1, (t + 1) * T);
    for (int first = a + (threadIdx.x >> 5) * (32 / kLanes); first < b;
         first += kTiledThreads / kLanes) {
      const int p = first + lane / kLanes;
      const bool live = p < b;
      const size_t pp = live ? static_cast<size_t>(p) : static_cast<size_t>(a);
      const int v = inv[pp];
      const bool has_row = static_cast<unsigned>(v) < static_cast<unsigned>(U);
      uint32_t key[N];
      int32_t pid[N];
      lane_keys<N, VEC>(trows + (has_row ? v : 0) * row_len, C,
                        lane & (kLanes - 1), delta[3 * pp], delta[3 * pp + 1],
                        delta[3 * pp + 2],
                        live && has_row && slot_ok[pp] != 0, r2, key, pid);
      lane_sort<N>(key, pid);
      merge_rounds<N>(key, pid, K, lane, live, out + pp * K);
    }
  }
}

// Instantiations: N = ceil(C / 8) in 1..8 with scalar loads, and the
// 16-byte path at C = 64.
using K1Fn = void (*)(const int16_t*, const float*, const uint8_t*, float, int,
                      int, int, int32_t*);
using K6Fn = void (*)(const int16_t*, const int32_t*, const float*,
                      const uint8_t*, float, int, int, int, int, int, int,
                      int32_t*);

template <int N>
struct Pick {
  static K1Fn k1(int n) {
    return n == N ? fused_knn_kernel<N, false> : Pick<N - 1>::k1(n);
  }
  static K6Fn k6(int n) {
    return n == N ? fused_knn_tiled_kernel<N, false> : Pick<N - 1>::k6(n);
  }
};
template <>
struct Pick<0> {
  static K1Fn k1(int) { return nullptr; }
  static K6Fn k6(int) { return nullptr; }
};

K1Fn k1_for(int C, bool aligned) {
  if (C == 64 && aligned) return fused_knn_kernel<8, true>;
  return Pick<8>::k1((C + kLanes - 1) / kLanes);
}

K6Fn k6_for(int C) {
  // staged rows start 16-byte aligned; at C = 64 every row does
  if (C == 64) return fused_knn_tiled_kernel<8, true>;
  return Pick<8>::k6((C + kLanes - 1) / kLanes);
}

size_t tiled_smem(int U, int C) {
  return static_cast<size_t>(U) * 5 * C * sizeof(int16_t);
}

// K6's persistent grid for M points: as many blocks as fit the card at
// once (SMs x resident blocks an SM of `fn` with `smem` bytes), but none
// with fewer points than one pass of its warps; block b takes the points
// [b * per_block, min(M, (b + 1) * per_block)). The resident count is
// asked once a (device, C, U).
cudaError_t k6_grid(K6Fn fn, int C, int U, size_t smem, int M,
                    int* per_block, int* blocks) {
  static thread_local int key[3] = {-1, 0, 0}, slots = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (key[0] != dev || key[1] != C || key[2] != U) {
    int sms, per_sm;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, kTiledThreads, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    key[0] = dev, key[1] = C, key[2] = U;
  }
  const int pass = kTiledThreads / kLanes;
  const int want = std::max(1, std::min(slots, (M + pass - 1) / pass));
  *per_block = std::max(1, (M + want - 1) / want);
  *blocks = (M + *per_block - 1) / *per_block;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows (M, 5C) int16, delta (M, 3) f32, slot_ok (M,) uint8 -> out (M, K)
// int32. 1 <= K <= C <= 64. Launches on `stream`; returns
// cudaGetLastError() after the launch.
int fused_knn_select(const int16_t* rows, const float* delta,
                     const uint8_t* slot_ok, float r2, int M, int C, int K,
                     int32_t* out, cudaStream_t stream) {
  if (C < 1 || C > 64 || K < 1 || K > C || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const K1Fn fn = k1_for(C, reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const int per_block = kThreads / kLanes;
  fn<<<(M + per_block - 1) / per_block, kThreads, 0, stream>>>(
      rows, delta, slot_ok, r2, M, C, K, out);
  return static_cast<int>(cudaGetLastError());
}

// K6. rows (nt*U, 5C) int16: tile t's distinct rows at t*U..t*U+U-1;
// inv (nt*T,) int32 in [0, U] (U: no row), delta (nt*T, 3) f32, slot_ok
// (nt*T,) uint8 -> out (nt*T, K) int32. 1 <= K <= C <= 64; U * 10 C bytes
// of shared memory within 227 KB, else cudaErrorInvalidValue before any
// launch. Launches on `stream`; returns cudaGetLastError().
int fused_knn_select_tiled(const int16_t* rows, const int32_t* inv,
                           const float* delta, const uint8_t* slot_ok,
                           float r2, int nt, int T, int U, int C, int K,
                           int32_t* out, cudaStream_t stream) {
  const size_t smem = tiled_smem(U, C);
  if (C < 1 || C > 64 || K < 1 || K > C || nt < 0 || T < 1 || U < 1 ||
      smem > kMaxSmem || static_cast<long long>(nt) * T > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt == 0) return 0;
  const K6Fn fn = k6_for(C);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = nt * T;
  int per_block, blocks;
  if ((e = k6_grid(fn, C, U, smem, M, &per_block, &blocks)) != cudaSuccess)
    return static_cast<int>(e);
  fn<<<blocks, kTiledThreads, smem, stream>>>(
      rows, inv, delta, slot_ok, r2, M, T, U, C, K, per_block, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, shared memory a block (bytes) and blocks an SM of K1
// ([0]) and K6 ([1], with U rows a tile) at C candidates, for the kernels
// a call with a 16-byte aligned row table picks.
int fused_knn_occupancy(int C, int U, int* regs, int* smem, int* blocks) {
  if (C < 1 || C > 64 || U < 1 || tiled_smem(U, C) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fns[2] = {reinterpret_cast<const void*>(k1_for(C, true)),
                        reinterpret_cast<const void*>(k6_for(C))};
  const int threads[2] = {kThreads, kTiledThreads};
  const size_t dyn[2] = {0, tiled_smem(U, C)};
  for (int i = 0; i < 2; ++i) {
    cudaError_t e;
    if (i == 1 && (e = cudaFuncSetAttribute(
                       fns[1], cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dyn[1]))) != cudaSuccess)
      return static_cast<int>(e);
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, fns[i])) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks[i], fns[i], threads[i], dyn[i])) != cudaSuccess)
      return static_cast<int>(e);
    regs[i] = attr.numRegs;
    smem[i] = static_cast<int>(attr.sharedSizeBytes + dyn[i]);
  }
  return 0;
}

}  // extern "C"
