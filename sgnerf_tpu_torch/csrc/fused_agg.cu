// K2: fused aggregator forward — PE -> block1 -> per-neighbour alpha ->
// weighted K-reduction, for the eval render, the train step's forward and
// the growing probe.
//
// Replaces the TPU kernel sgnerf_tpu/ops/fused_agg.py `fused_block1_alpha`
// forward (`_pallas_forward` -> `_kernel` -> `_block1_alpha_body`).
// Function, per neighbour row r (M*K rows, K rows per shading point):
//   x_r   = [feat | PE(feat, nf) | PE(d, df)] in the reference's interleaved
//           layout, against the unpermuted block1 weights;
//   h_r   = LeakyReLU_0.01(... LeakyReLU_0.01(x_r W0 + b0) ... W_{n-1} + b_{n-1});
//   a_r   = softplus(h_r . wa + ba - 1);
//   out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}]            -> (M, C+1).
// bf16 mode: bf16 products with f32 sums (the reference's `_dot_mm`); f32
// mode: 3xTF32 products with f32 sums.
//
// Only the live rows (w != 0) are shaded. An eval frame's chunks hold a
// neighbour in 18-28% of their slots; an empty slot has w = 0 (the
// aggregator multiplies w by the mask) and a finite h, so its term w h is
// +-0 and leaves every partial sum of the K-sum, which starts at +0, as it
// is. A plan, built on the device from w before the body runs (three
// small launches: each point's live count and the zeros of the points
// with none; an exclusive scan; each live row's place), packs the live
// rows of whole points into tiles: with T = tile_rows, Kmax the chunk's
// largest count and g the counts' greatest common divisor (every offset is
// a multiple of g), the stride S = g floor((T - Kmax + g) / g), and tile t
// takes the points whose offset lies in [t S, (t + 1) S), at most
// S - g + Kmax <= T rows. The body reads a tile's rows through the
// plan's list; each wgmma row depends on its own A row alone and each
// point's live rows are summed in k order, so every output row has the
// bits of the dense K2 that shaded every slot (but for a sum of live
// terms that is exactly -0, which a dead +0 after it turned to +0). The
// tile count stays on the
// device: a persistent grid (the blocks an SM holds, times the SMs) walks
// tiles blockIdx.x, + gridDim.x, .. up to it; nothing waits on the host.
// The stride is at least T - K + 1; at full fill (g = Kmax = K) it is
// K floor(T / K), the dense kernel's tiles of floor(T / K) points, and the
// body sums such a tile as the dense kernel did. What full fill costs
// over the dense kernel is then the plan's launches and the reads through
// the row list.
//
// What bounds it on an H100: the tensor cores, over the live rows. A
// canonical 9216-ray chunk shaded in full is 4.9e11 FLOP of products:
// 0.50 ms at the bf16 peak (989 TFLOP/s) and, in f32 mode, three tf32
// passes at 495 TFLOP/s (3.0 ms), against 0.14 ms of HBM traffic; at 27%
// fill over tiles 89% full (f32) the products are a third of that. Next
// come the L2 traffic of the weights every tile streams and the CUDA-core
// work around the products. Design: one block of two warpgroups per tile
// of 128 rows (bf16) or 64 (f32); the tile body, fused_agg_body.cuh
// (shared with K3's recompute), runs every block1 product as Hopper wgmma
// (bf16, or 3xTF32 in f32 mode) from A in shared memory and a TMA-fed
// ring of pre-packed weight k-slices, and writes only the (M, C+1) rows.
#include "fused_agg_body.cuh"

#include <algorithm>
#include <climits>
#include <mutex>
#include <vector>

using namespace sgnerf_agg;

namespace {

// ---- the plan: a chunk's live rows (w != 0) packed into tiles of whole
// points, built on the device from w in three launches (count, scan,
// place), so that no count passes through the host.
constexpr int kPlanThreads = 256;
constexpr int kPlanPer = 4;                           // points a thread
constexpr int kPlanPts = kPlanThreads * kPlanPer;     // points a block
constexpr int kScanThreads = 1024;

// The plan's int32 words (ops/fused_agg.py `_plan_layout` reads it): [0]
// tiles nt, [1] the rows of the tiles that hold a row (tile_rows each: the
// counter k2.rows), [2] live rows, [3] the stride S; tile_row0 (nt_max +
// 1: tile t holds rows[tile_row0[t] .. tile_row0[t + 1])); rows (the
// live rows' m K + k, in point order and each point's k in order); each
// point's live-row count (a byte a point); each plan block's live rows,
// then their exclusive prefix; each plan block's largest count and its
// counts' gcd (bstat: largest | gcd << 8).
struct PlanLayout {
  int tp;              // the least stride, tile_rows - K + 1
  int nb;              // plan blocks
  int nt_max;          // tiles at most (every slot live, stride tp)
  size_t tiles, rows, cnt, bsum, bstat, words;  // offsets in words; total
};

PlanLayout plan_layout(int M, int K, bool bf16) {
  PlanLayout P;
  P.tp = tile_rows(bf16) - K + 1;
  P.nb = (M + kPlanPts - 1) / kPlanPts;
  const long long live = static_cast<long long>(M) * K;
  P.nt_max = static_cast<int>((live + P.tp - 1) / P.tp);
  P.tiles = 4;
  P.rows = P.tiles + P.nt_max + 1;
  P.cnt = P.rows + static_cast<size_t>(live);
  P.bsum = P.cnt + (static_cast<size_t>(M) + 3) / 4;
  P.bstat = P.bsum + P.nb;
  P.words = P.bstat + P.nb;
  return P;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The exclusive prefix of v over the block's threads, and the block's sum
// in *sum; `warps` is a shared array of one int a warp. Every thread calls it.
template <int THREADS>
__device__ __forceinline__ int block_excl_scan(int v, int* warps, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < THREADS / 32 ? warps[lane] : 0;
    const int wi = warp_incl_scan(w);
    if (lane < THREADS / 32) warps[lane] = wi;
  }
  __syncthreads();
  const int excl = (warp ? warps[warp - 1] : 0) + incl - v;
  *sum = warps[THREADS / 32 - 1];
  __syncthreads();  // warps is free again
  return excl;
}

__device__ __forceinline__ int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The largest of mx and the gcd of g over the block's threads (gcd(0, x)
// = x), in every thread; `warps` holds a pair of ints a warp.
template <int THREADS>
__device__ __forceinline__ void block_max_gcd(int& mx, int& g, int* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    g = gcd_int(g, __shfl_xor_sync(0xffffffffu, g, o));
  }
  if (lane == 0) warps[2 * warp] = mx, warps[2 * warp + 1] = g;
  __syncthreads();
  mx = 0, g = 0;
  for (int i = 0; i < THREADS / 32; ++i)
    mx = max(mx, warps[2 * i]), g = gcd_int(g, warps[2 * i + 1]);
  __syncthreads();  // warps is free again
}

// Plan 1: each point's live-row count, each plan block's live rows, its
// largest count and its counts' gcd, and the (C+1) zeros of every point
// with no live row (no tile holds it).
__global__ void __launch_bounds__(kPlanThreads)
fused_agg_kernel_plan_count(const float* __restrict__ wgt, int M, int K,
                            int C, unsigned char* __restrict__ cnt,
                            int* __restrict__ bsum, int* __restrict__ bstat,
                            float* __restrict__ out) {
  __shared__ unsigned char s_cnt[kPlanPts];
  __shared__ int warps[2 * (kPlanThreads / 32)];
  const int p0 = blockIdx.x * kPlanPts;
  const int n = min(kPlanPts, M - p0);
  const int tid = threadIdx.x;
  int mine = 0, mx = 0, g = 0;
  for (int i = tid; i < n; i += kPlanThreads) {
    const float* w = wgt + static_cast<size_t>(p0 + i) * K;
    int c = 0;
    for (int k = 0; k < K; ++k) c += w[k] != 0.0f;
    s_cnt[i] = static_cast<unsigned char>(c);
    cnt[p0 + i] = static_cast<unsigned char>(c);
    mine += c;
    mx = max(mx, c);
    g = gcd_int(g, c);
  }
  int sum = 0;
  block_excl_scan<kPlanThreads>(mine, warps, &sum);
  block_max_gcd<kPlanThreads>(mx, g, warps);
  if (tid == 0) bsum[blockIdx.x] = sum, bstat[blockIdx.x] = mx | g << 8;
  const int lane = tid & 31;
  for (int i = tid >> 5; i < n; i += kPlanThreads / 32) {
    if (s_cnt[i] != 0) continue;
    float* o = out + static_cast<size_t>(p0 + i) * (C + 1);
    for (int c = lane; c <= C; c += 32) o[c] = 0.0f;
  }
}

// Plan 2 (one block): the blocks' exclusive prefix of live rows in place,
// the live rows, the stride S from the chunk's largest count Kmax and its
// counts' gcd g (S = g floor((T - Kmax + g) / g): offsets are multiples
// of g, so a tile holds at most S - g + Kmax <= T rows), the tiles
// nt = ceil(live / S) and tile_row0[nt].
__global__ void __launch_bounds__(kScanThreads)
fused_agg_kernel_plan_scan(int* __restrict__ bsum,
                           const int* __restrict__ bstat, int nb, int T,
                           int* __restrict__ meta,
                           int* __restrict__ tile_row0) {
  __shared__ int warps[2 * (kScanThreads / 32)];
  int carry = 0;  // the same in every thread
  int mx = 0, g = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? bsum[i] : 0;
    if (i < nb) mx = max(mx, bstat[i] & 0xff), g = gcd_int(g, bstat[i] >> 8);
    int sum = 0;
    const int excl = block_excl_scan<kScanThreads>(v, warps, &sum);
    if (i < nb) bsum[i] = carry + excl;
    carry += sum;
  }
  block_max_gcd<kScanThreads>(mx, g, warps);
  if (threadIdx.x == 0) {
    const int S = carry ? g * ((T - mx + g) / g) : T;
    const int nt = (carry + S - 1) / S;
    meta[0] = nt;
    meta[1] = 0;  // plan 3 adds the rows of the tiles that hold a row
    meta[2] = carry;
    meta[3] = S;
    tile_row0[nt] = carry;
  }
}

// Plan 3: each live row's place. Point m's live rows take rows[o ..
// o + c) from its offset o (the exclusive prefix of the counts), in k
// order. Tile t holds the points whose offset lies in [t S, (t + 1) S):
// at most tile_rows rows, each point whole. Its first row tile_row0[t] is
// the first offset at or past t S: the row at t S is that point's first,
// or lies inside a point and the next point starts the tile.
__global__ void __launch_bounds__(kPlanThreads)
fused_agg_kernel_plan_place(const float* __restrict__ wgt,
                            const unsigned char* __restrict__ cnt,
                            const int* __restrict__ bsum, int M, int K,
                            int T, int* __restrict__ meta,
                            int* __restrict__ tile_row0,
                            int* __restrict__ rows) {
  __shared__ int warps[kPlanThreads / 32];
  const int tp = meta[3];
  const int p0 = blockIdx.x * kPlanPts + threadIdx.x * kPlanPer;
  int c[kPlanPer];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    c[j] = p0 + j < M ? cnt[p0 + j] : 0;
    mine += c[j];
  }
  int sum = 0;
  int o = bsum[blockIdx.x] + block_excl_scan<kPlanThreads>(mine, warps, &sum);
  const int total = meta[2];
  int opened = 0;  // tiles started here that hold a row
#pragma unroll
  for (int j = 0; j < kPlanPer; ++j) {
    if (c[j] == 0) continue;
    const int m = p0 + j;
    const float* w = wgt + static_cast<size_t>(m) * K;
    int n = 0;
    for (int k = 0; k < K; ++k) {
      if (w[k] == 0.0f) continue;
      const int r = o + n;
      rows[r] = m * K + k;
      if (r % tp == 0) {
        const int t = r / tp;
        const int first = n == 0 ? o : o + c[j];
        tile_row0[t] = first;
        opened += first < total && first - t * tp < tp;
      }
      ++n;
    }
    o += c[j];
  }
  block_excl_scan<kPlanThreads>(opened, warps, &sum);
  if (threadIdx.x == 0 && sum > 0) atomicAdd(meta + 1, sum * T);
}

// The body over the plan's tiles: a persistent grid, each block taking
// tiles blockIdx.x, + gridDim.x, .. up to the device-held count. A tile's
// bounds are read two tiles ahead and its row list (a row a thread) one
// tile ahead, so that no tile waits on them.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_agg_kernel(const float* __restrict__ feat, const float* __restrict__ dist,
                 const float* __restrict__ wgt, const void* __restrict__ Wp,
                 const float* __restrict__ Bias, int n_layers,
                 const float* __restrict__ wa, const float* __restrict__ ba,
                 int K, int F, int nf, int Dd, int df, int C,
                 const int* __restrict__ meta,
                 const int* __restrict__ tile_row0,
                 const int* __restrict__ rows, int map_off,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) ring_init(smem);
  __syncthreads();
  uint32_t ring_it = 0;
  TileRows tile;
  tile.map = reinterpret_cast<int*>(smem + map_off);
  const int nt = meta[0];
  const int G = gridDim.x, tid = threadIdx.x;
  auto bounds = [&](int t, int& j0, int& j1) {
    j0 = j1 = 0;
    if (t < nt) j0 = tile_row0[t], j1 = tile_row0[t + 1];
  };
  int a0, a1, b0, b1;  // this tile's bounds, the next one's
  bounds(blockIdx.x, a0, a1);
  bounds(blockIdx.x + G, b0, b1);
  int row = tid < a1 - a0 ? rows[a0 + tid] : 0;
  for (int t = blockIdx.x; t < nt; t += G) {
    tile.n = a1 - a0;
    tile.row = row;
    row = tid < b1 - b0 ? rows[b0 + tid] : 0;
    a0 = b0, a1 = b1;
    bounds(t + 2 * G, b0, b1);
    if (tile.n == 0) continue;
    block1_alpha_tile<BF16>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba, K,
                            F, nf, Dd, df, C, 0, 0, smem, ring_it, out, C + 1,
                            SaveArgs(), tile);
  }
}

bool args_ok(int M, int K, int F, int nf, int Dd, int df, int C,
             int n_layers) {
  return !(K < 1 || K > 64 || C < 32 || C > kMaxC || C % 32 != 0 ||
           n_layers < 1 || M < 0 || F < 1 || nf < 1 || Dd < 1 || df < 1 ||
           nf > 30 || df > 30 ||
           static_cast<long long>(M) * K > INT_MAX / 2);
}

template <bool BF16>
cudaError_t prepare(size_t* smem, int F, int nf, int Dd, int df, int C) {
  *smem = k2_smem_bytes(F, nf, Dd, df, C, BF16);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fused_agg_kernel<BF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// The persistent grid's blocks on the current device for one mode at
// `smem` bytes a block: the SMs times the blocks an SM holds, asked of the
// runtime once for each device and size.
template <bool BF16>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  struct Seen {
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.smem == smem) return *blocks = s.blocks, e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_agg_kernel<BF16>, kThreads, smem)) != cudaSuccess)
    return e;
  *blocks = sms * std::max(per_sm, 1);
  seen.push_back({dev, smem, *blocks});
  return e;
}

template <bool BF16>
cudaError_t launch_body(const float* feat, const float* dist, const float* wgt,
                        const void* Wp, const float* Bias, int n_layers,
                        const float* wa, const float* ba, int M, int K, int F,
                        int nf, int Dd, int df, int C, int* plan, float* out,
                        cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t e = prepare<BF16>(&smem, F, nf, Dd, df, C);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = resident_blocks<BF16>(smem, &blocks)) != cudaSuccess) return e;
  const PlanLayout P = plan_layout(M, K, BF16);
  const int grid = std::max(1, std::min(P.nt_max, blocks));
  const int map_off = static_cast<int>(smem - kMapInts * sizeof(int));
  fused_agg_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      feat, dist, wgt, Wp, Bias, n_layers, wa, ba, K, F, nf, Dd, df, C, plan,
      plan + P.tiles, plan + P.rows, map_off, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2's plan for w (M, K) f32 in one mode, into `plan` (int32,
// fused_block1_alpha_plan_words words; layout: PlanLayout), and the (C+1)
// zeros of out (M, C+1)'s rows of points with no live row. Three launches
// on `stream`; returns cudaGetLastError().
int fused_block1_alpha_plan(const float* wgt, int M, int K, int C, int bf16,
                            int* plan, float* out, cudaStream_t stream) {
  if (!args_ok(M, K, 1, 1, 1, 1, C, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const PlanLayout P = plan_layout(M, K, bf16 != 0);
  unsigned char* cnt = reinterpret_cast<unsigned char*>(plan + P.cnt);
  const int T = tile_rows(bf16 != 0);
  fused_agg_kernel_plan_count<<<P.nb, kPlanThreads, 0, stream>>>(
      wgt, M, K, C, cnt, plan + P.bsum, plan + P.bstat, out);
  fused_agg_kernel_plan_scan<<<1, kScanThreads, 0, stream>>>(
      plan + P.bsum, plan + P.bstat, P.nb, T, plan, plan + P.tiles);
  fused_agg_kernel_plan_place<<<P.nb, kPlanThreads, 0, stream>>>(
      wgt, cnt, plan + P.bsum, M, K, T, plan, plan + P.tiles,
      plan + P.rows);
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of K2's plan for M points of K slots in one mode, or -1
// for shapes K2 does not take. Host arithmetic only.
int fused_block1_alpha_plan_words(int M, int K, int bf16) {
  if (!args_ok(M, K, 1, 1, 1, 1, 32, 1)) return -1;
  const size_t words = plan_layout(M, K, bf16 != 0).words;
  return words > static_cast<size_t>(INT_MAX) ? -1 : static_cast<int>(words);
}

// feat (M,K,F), dist (M,K,Dd), wgt (M,K) f32; Wp: the block1 weights as
// ops/fused_agg.py `pack_block1` packs them for this mode (bf16 k-slices,
// or tf32 hi/lo k-slices for f32 mode); Bias (n_layers, C); wa (C,),
// ba (1,); plan: fused_block1_alpha_plan_words int32 words of scratch ->
// out (M, C+1) f32, and in plan[1] the rows K2's tiles held. Needs
// 1 <= K <= 64, C % 32 == 0, C <= 256. Four launches on `stream` (the
// plan's three, then the body); returns cudaGetLastError().
int fused_block1_alpha(const float* feat, const float* dist, const float* wgt,
                       const void* Wp, const float* Bias, int n_layers,
                       const float* wa, const float* ba, int M, int K, int F,
                       int nf, int Dd, int df, int C, int bf16, int* plan,
                       float* out, cudaStream_t stream) {
  if (!args_ok(M, K, F, nf, Dd, df, C, n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int e = fused_block1_alpha_plan(wgt, M, K, C, bf16, plan, out, stream);
  if (e != 0) return e;
  return static_cast<int>(
      bf16 ? launch_body<true>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba, M,
                               K, F, nf, Dd, df, C, plan, out, stream)
           : launch_body<false>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba,
                                M, K, F, nf, Dd, df, C, plan, out, stream));
}

// K2's resources for the shapes F, nf, Dd, df, C in one mode: registers
// a thread, dynamic shared memory a block (bytes) and resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int fused_block1_alpha_occupancy(int F, int nf, int Dd, int df, int C,
                                 int bf16, int* regs, int* smem_bytes,
                                 int* blocks_per_sm) {
  size_t smem = 0;
  cudaError_t e = bf16 ? prepare<true>(&smem, F, nf, Dd, df, C)
                       : prepare<false>(&smem, F, nf, Dd, df, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  const void* fn = bf16 ? reinterpret_cast<const void*>(fused_agg_kernel<true>)
                        : reinterpret_cast<const void*>(fused_agg_kernel<false>);
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(smem);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                    kThreads, smem);
  return static_cast<int>(e);
}

// Bytes of dynamic shared memory a K2 block takes at these widths, or 0
// when it exceeds what a block may have (ops/fused_agg.py k2_supports).
// Host arithmetic only.
int fused_block1_alpha_smem(int F, int nf, int Dd, int df, int C, int bf16) {
  const size_t smem = k2_smem_bytes(F, nf, Dd, df, C, bf16 != 0);
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

}  // extern "C"
