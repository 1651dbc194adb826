// The fused aggregator's tile body — PE -> block1 -> per-neighbour alpha ->
// weighted K-reduction over 64 neighbour rows — shared by K2
// (fused_agg.cu) and by K4/K5 (fused_agg_color.cu), which run the colour
// head (and the volume march) on the reduced rows it leaves in memory.
//
// Function, per neighbour row r (K rows per shading point):
//   x_r   = [feat | PE(feat, nf) | PE(d, df)] in the reference's interleaved
//           layout (ops/pe.py: frequency innermost per channel, sin/cos
//           interleaved), against the unpermuted block1 weights;
//   h_r   = LeakyReLU_0.01(... LeakyReLU_0.01(x_r W0 + b0) ... W_{n-1} + b_{n-1});
//   a_r   = softplus(h_r . wa + ba - 1);
//   out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}]            -> (C+1) floats.
// bf16 mode rounds every matmul input (x, hidden activations, weights) to
// bf16 with __float2bfloat16_rn and accumulates in f32, as the reference's
// `_dot_mm`; the alpha head and the K-reduction stay f32. f32 mode is IEEE
// f32 FMA throughout (no TF32, no fast math).
//
// Layout: a block of 256 threads takes 64 neighbour rows (64 / K whole
// shading points), builds their PE rows in shared memory and runs every
// layer as a register-tiled FMA product (each thread 8 rows x 8 columns)
// with 32-row tiles of the weight matrix staged through shared memory.
// Hidden activations ping-pong between two shared buffers.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgnerf_agg {

constexpr int kRows = 64;      // neighbour rows per tile
constexpr int kThreads = 256;  // 8 warps: warp -> rows, lane -> columns
constexpr int kTileK = 32;     // weight rows staged per shared-memory tile
constexpr int kMaxC = 256;     // hidden width limit (8 columns per lane)
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : 0.01f * v;
}

// Width of the first block1 input row.
inline int block1_in(int F, int nf, int Dd, int df) {
  return F + 2 * F * nf + 2 * Dd * df;
}

// Floats of shared memory the tile body uses: PE/hidden buffer A
// (kRows x max(in0, C)), hidden buffer B (kRows x C), the weight tile and
// two per-row vectors. Buffers A and B are adjacent, so a caller may reuse
// the kRows x (max(in0, C) + C) floats from `smem` once the body returns.
inline size_t body_smem_floats(int in0, int C) {
  const int lda = in0 > C ? in0 : C;
  return static_cast<size_t>(kRows) * lda + static_cast<size_t>(kRows) * C +
         static_cast<size_t>(kTileK) * C + 2 * kRows;
}

// Runs the body for the n_pts (<= kRows / K) shading points from m0 and
// writes their reduced rows [feat_agg (C) | alpha_agg] to dst[t * ld_dst + c]
// (global or shared memory). Every thread of the block must call it; it
// returns with the block synchronised, after which buffers A and B are free.
__device__ __forceinline__ void block1_alpha_tile(
    const float* __restrict__ feat, const float* __restrict__ dist,
    const float* __restrict__ wgt, const float* __restrict__ W,
    const float* __restrict__ Bias, int n_layers,
    const float* __restrict__ wa, const float* __restrict__ ba, int K, int F,
    int nf, int Dd, int df, int C, int bf16, int m0, int n_pts, float* smem,
    float* dst, int ld_dst) {
  const int in0 = F + 2 * F * nf + 2 * Dd * df;
  const int lda = in0 > C ? in0 : C;
  float* bufA = smem;                 // kRows x lda : PE rows, then hidden
  float* bufB = bufA + kRows * lda;   // kRows x C   : hidden
  float* wtile = bufB + kRows * C;    // kTileK x C  : staged weights
  float* alpha_w = wtile + kTileK * C;  // kRows      : a_r * w_r
  float* w_row = alpha_w + kRows;       // kRows      : w_r

  const int tm = kRows / K;             // shading points per tile
  const int nrows = tm * K;
  const size_t r0 = static_cast<size_t>(m0) * K;  // first global row
  const int rows_live = n_pts * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- 1. PE rows (zero rows past the end keep every product finite)
  for (int idx = tid; idx < kRows * in0; idx += kThreads) {
    const int r = idx / in0, j = idx - r * in0;
    float v = 0.0f;
    if (r < rows_live) {
      const size_t g = r0 + r;
      if (j < F) {
        v = feat[g * F + j];
      } else if (j < F + 2 * F * nf) {
        const int q = j - F, cf = q >> 1;
        const float a = feat[g * F + cf / nf] * static_cast<float>(1 << (cf % nf));
        v = (q & 1) ? cosf(a) : sinf(a);
      } else {
        const int q = j - F - 2 * F * nf, cf = q >> 1;
        const float a = dist[g * Dd + cf / df] * static_cast<float>(1 << (cf % df));
        v = (q & 1) ? cosf(a) : sinf(a);
      }
      if (bf16) v = round_bf16(v);
    }
    bufA[r * lda + j] = v;
  }
  if (tid < kRows) w_row[tid] = tid < rows_live ? wgt[r0 + tid] : 0.0f;
  __syncthreads();

  // ---- 2. block1: register-tiled products, activations in shared memory
  const int nj = C / 32;  // columns per lane
  const float* in = bufA;
  int ld_in = lda, k_in = in0;
  float* hid = bufB;
  int ld_hid = C;
  const float* Wl = W;
  const float* bl = Bias;
  for (int l = 0; l < n_layers; ++l) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < k_in; k0 += kTileK) {
      const int kt = min(kTileK, k_in - k0);
      for (int idx = tid; idx < kt * C; idx += kThreads) {
        float v = Wl[static_cast<size_t>(k0) * C + idx];
        wtile[idx] = bf16 ? round_bf16(v) : v;
      }
      __syncthreads();
      for (int kk = 0; kk < kt; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = in[(warp + 8 * i) * ld_in + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = j < nj ? wtile[kk * C + lane + 32 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the tile is consumed before it is overwritten
    }
    const bool last = l == n_layers - 1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj) {
          const int c = lane + 32 * j;
          float v = leaky(acc[i][j] + bl[c]);
          if (bf16 && !last) v = round_bf16(v);  // next layer's input
          hid[(warp + 8 * i) * ld_hid + c] = v;
        }
      }
    __syncthreads();
    Wl += static_cast<size_t>(k_in) * C;
    bl += C;
    in = hid;
    ld_in = ld_hid;
    k_in = C;
    hid = (hid == bufB) ? bufA : bufB;
    ld_hid = (hid == bufA) ? lda : C;
  }

  // ---- 3. per-neighbour alpha (f32 head): one warp per row
  for (int r = warp; r < nrows; r += kThreads / 32) {
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s = fmaf(in[r * ld_in + c], wa[c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float x = s + ba[0] - 1.0f;
      const float alpha = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));  // softplus
      alpha_w[r] = alpha * w_row[r];
    }
  }
  __syncthreads();

  // ---- 4. weighted sum over the K neighbour slots -> (n_pts, C+1)
  for (int idx = tid; idx < n_pts * (C + 1); idx += kThreads) {
    const int t = idx / (C + 1), c = idx - t * (C + 1);
    float s = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int r = t * K + k;
      s += c < C ? in[r * ld_in + c] * w_row[r] : alpha_w[r];
    }
    dst[static_cast<size_t>(t) * ld_dst + c] = s;
  }
  __syncthreads();
}

}  // namespace sgnerf_agg
