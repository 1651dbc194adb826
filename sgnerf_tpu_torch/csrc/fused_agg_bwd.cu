// K3: fused aggregator backward — the gradient of K2 (csrc/fused_agg.cu)
// for training.
//
// Replaces the TPU kernel sgnerf_tpu/ops/fused_agg.py `_pallas_backward`
// (`_bwd_kernel`). Given the cotangent g (M, C+1) = [gF | gA] of
// out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}], per neighbour row r:
//   recompute x_r = [feat | PE(feat, nf) | PE(d, df)] (interleaved layout,
//   unpermuted W1), the hidden activations h^0..h^{L-1} and
//   a_r = softplus(h^{L-1} . wa + ba - 1);
//   d_w[r]  = h^{L-1}_r . gF_m + a_r gA_m;
//   draw_r  = gA_m w_r sigmoid(h^{L-1} . wa + ba - 1)    (softplus' = sigmoid);
//   da      = gF_m w_r + draw_r wa;
//   dh^l    = da where h^l >= 0 else 0.01 da   (leaky_relu' by the
//             activation's sign, slope 1 at exactly 0, as jax.nn.leaky_relu);
//   da^{l-1} = dh^l W_l^T;  dW_l += h^{l-1 T} dh^l;  db_l += sum_r dh^l;
//   dx      = dh^0 W_0^T, folded through the PE: d_feat / d_dist.
//   dwa += sum_r h^{L-1}_r draw_r;  dba += sum_r draw_r.
// bf16 mode rounds every product input to bf16 (x, hidden activations,
// dh, weights — including the weight-gradient products) and accumulates in
// f32, where the reference's `_dot_mm`/`dotT` round; bias sums, the alpha
// head and the PE chain rule stay f32 on unrounded values. f32 mode is IEEE
// f32 FMA throughout (no TF32, no fast math).
//
// What bounds it on an H100: arithmetic. At the canonical train step
// (M = 24,576 points, K = 8, block1 284 -> 256 -> 256) a row costs ~138.5k
// FMA of recompute and ~276.5k of backward: ~81.6 G FMA a step against
// ~86 MB of inputs and outputs, ~2.4 ms on the f32 CUDA cores at best.
// Design (simple first): a block of 256 threads walks tiles of 32
// neighbour rows (32/K whole points). The tile's PE rows and every hidden
// activation live in shared memory; each dh^l overwrites h^l in place once
// its sign has been read. Products are register-tiled FMA loops (thread:
// 4 rows x up to 9 columns) over 32-row weight tiles staged in shared
// memory; the backward reads transposed weights the wrapper passes in.
// Weight gradients are deterministic: the grid is fixed (one block per SM
// at most), each block sums its tiles, in tile order, into its own f32
// partial of every dW/db in a scratch buffer (thread c owns column c, no
// atomics), and a second kernel sums the partials in block order.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRI = 4;                // rows per thread: warp + 8 i
constexpr int kRows = 8 * kRI;        // neighbour rows per tile
constexpr int kThreads = 256;         // 8 warps: warp -> rows, lane -> columns
constexpr int kTileK = 32;            // weight rows staged per shared tile
constexpr int kMaxC = 256;            // hidden width limit (one column a thread)
constexpr int kMaxN = 9 * 32;         // widest product output (block1 input)
constexpr size_t kMaxSmem = 232448;   // bytes of shared memory a block may use

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : 0.01f * v;
}

// acc[i][j] = sum_k A[(warp + 8i) * lda + k] * W[k * N + lane + 32j] over
// k < k_in; W is row-major (k_in, N) in global memory, staged through
// `wtile`. bf16 rounds both inputs. Starts and ends with all threads synced.
template <int NJ>
__device__ void rows_times_w(const float* A, int lda, int k_in,
                             const float* __restrict__ W, int N, int bf16,
                             float* wtile, float (&acc)[kRI][NJ]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k_in; k0 += kTileK) {
    const int kt = min(kTileK, k_in - k0);
    for (int idx = tid; idx < kt * N; idx += kThreads) {
      const float v = W[static_cast<size_t>(k0) * N + idx];
      wtile[idx] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      float a[kRI], b[NJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float v = A[(warp + 8 * i) * lda + k0 + kk];
        a[i] = bf16 ? round_bf16(v) : v;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        b[j] = c < N ? wtile[kk * N + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tile is consumed before it is overwritten
  }
}

// Weight-gradient partial of one tile: P[i * C + c] (+)= sum_r X[r, i] *
// D[r, c] for i < nin, thread c < C. X rows have stride ldx (a multiple of
// 4, 16-byte aligned); D is (kRows, C). Reads only shared memory, writes
// only this block's partial. bf16 rounds D (X is stored rounded).
__device__ void accumulate_dw(float* __restrict__ P, const float* X, int ldx,
                              int nin, const float* D, int C, int bf16,
                              bool first) {
  const int c = threadIdx.x;
  if (c >= C) return;
  float d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = D[r * C + c];
    d[r] = bf16 ? round_bf16(v) : v;
  }
  int i = 0;
  for (; i + 4 <= nin; i += 4) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(X + r * ldx + i);
      s0 = fmaf(x.x, d[r], s0);
      s1 = fmaf(x.y, d[r], s1);
      s2 = fmaf(x.z, d[r], s2);
      s3 = fmaf(x.w, d[r], s3);
    }
    float* p = P + static_cast<size_t>(i) * C + c;
    if (first) {
      p[0] = s0; p[C] = s1; p[2 * C] = s2; p[3 * C] = s3;
    } else {
      p[0] += s0; p[C] += s1; p[2 * C] += s2; p[3 * C] += s3;
    }
  }
  for (; i < nin; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s = fmaf(X[r * ldx + i], d[r], s);
    float* p = P + static_cast<size_t>(i) * C + c;
    *p = first ? s : *p + s;
  }
}

// Column sums of D (kRows, C) into P[c] (+)=, thread c < C.
__device__ void accumulate_db(float* __restrict__ P, const float* D, int C,
                              bool first) {
  const int c = threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
  for (int r = 0; r < kRows; ++r) s += D[r * C + c];
  P[c] = first ? s : P[c] + s;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_agg_bwd_kernel(const float* __restrict__ feat,
                     const float* __restrict__ dist,
                     const float* __restrict__ wgt,
                     const float* __restrict__ g,
                     const float* __restrict__ W,
                     const float* __restrict__ WT,
                     const float* __restrict__ Bias, int n_layers,
                     const float* __restrict__ wa,
                     const float* __restrict__ ba, int M, int K, int F,
                     int nf, int Dd, int df, int C, int bf16, int n_tiles,
                     float* __restrict__ dfeat, float* __restrict__ ddist,
                     float* __restrict__ dw, float* __restrict__ partial,
                     size_t S) {
  extern __shared__ __align__(16) float smem[];
  const int in0 = F + 2 * F * nf + 2 * Dd * df;
  const int ldx = (in0 + 3) & ~3;
  const int wide = in0 > C ? in0 : C;
  float* xbuf = smem;                          // kRows x ldx: PE rows, then dx
  float* acts = xbuf + kRows * ldx;            // n_layers x kRows x C: h^l, then dh^l
  float* wtile = acts + n_layers * kRows * C;  // kTileK x wide
  float* w_row = wtile + kTileK * wide;        // kRows: w_r
  float* draw = w_row + kRows;                 // kRows: d raw_r
  float* gA_row = draw + kRows;                // kRows: gA of the row's point

  // partial layout: dW_0 (in0 x C) | dW_1.. (C x C) | db_0.. (C) | dwa (C) | dba
  const size_t off_b = static_cast<size_t>(in0) * C +
                       static_cast<size_t>(n_layers - 1) * C * C;
  float* P = partial + static_cast<size_t>(blockIdx.x) * S;
  const int tm = kRows / K;
  const int nrows = tm * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* a_last = acts + (n_layers - 1) * kRows * C;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int m0 = tile * tm;
    const size_t r0 = static_cast<size_t>(m0) * K;
    const int rows_live = min(nrows, (M - m0) * K);

    // ---- 1. PE rows (zero past the end), w and gA per row
    for (int idx = tid; idx < kRows * ldx; idx += kThreads) {
      const int r = idx / ldx, j = idx - r * ldx;
      float v = 0.0f;
      if (r < rows_live && j < in0) {
        const size_t gr = r0 + r;
        if (j < F) {
          v = feat[gr * F + j];
        } else if (j < F + 2 * F * nf) {
          const int q = j - F, cf = q >> 1;
          const float a = feat[gr * F + cf / nf] * static_cast<float>(1 << (cf % nf));
          v = (q & 1) ? cosf(a) : sinf(a);
        } else {
          const int q = j - F - 2 * F * nf, cf = q >> 1;
          const float a = dist[gr * Dd + cf / df] * static_cast<float>(1 << (cf % df));
          v = (q & 1) ? cosf(a) : sinf(a);
        }
        if (bf16) v = round_bf16(v);
      }
      xbuf[idx] = v;
    }
    if (tid < kRows) {
      const bool live = tid < rows_live;
      w_row[tid] = live ? wgt[r0 + tid] : 0.0f;
      gA_row[tid] = live ? g[static_cast<size_t>(m0 + tid / K) * (C + 1) + C]
                         : 0.0f;
    }
    __syncthreads();

    // ---- 2. forward recompute: h^l into acts[l] (bf16: rounded, but the last)
    {
      const float* in = xbuf;
      int ld_in = ldx, k_in = in0;
      const float* Wl = W;
      const float* bl = Bias;
      for (int l = 0; l < n_layers; ++l) {
        float acc[kRI][8];
        rows_times_w<8>(in, ld_in, k_in, Wl, C, bf16, wtile, acc);
        float* dst = acts + l * kRows * C;
        const bool last = l == n_layers - 1;
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = lane + 32 * j;
            if (c < C) {
              float v = leaky(acc[i][j] + bl[c]);
              if (bf16 && !last) v = round_bf16(v);
              dst[(warp + 8 * i) * C + c] = v;
            }
          }
        __syncthreads();
        Wl += static_cast<size_t>(k_in) * C;
        bl += C;
        in = dst;
        ld_in = C;
        k_in = C;
      }
    }

    // ---- 3. per-row alpha head, d_w and d raw (one warp per row)
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const bool live = r < rows_live;
      const float* gF = g + static_cast<size_t>(m0 + r / K) * (C + 1);
      float s = 0.0f, sg = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float h = a_last[r * C + c];
        s = fmaf(h, wa[c], s);
        if (live) sg = fmaf(h, gF[c], sg);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sg += __shfl_xor_sync(0xffffffffu, sg, off);
      }
      if (lane == 0) {
        const float x = s + ba[0] - 1.0f;
        const float alpha = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
        const float sig = 1.0f / (1.0f + expf(-x));
        if (live) dw[r0 + r] = sg + alpha * gA_row[r];
        draw[r] = gA_row[r] * w_row[r] * sig;
      }
    }
    __syncthreads();

    // ---- 4. alpha-head gradients
    if (tid < C) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s = fmaf(a_last[r * C + tid], draw[r], s);
      float* p = P + off_b + static_cast<size_t>(n_layers) * C + tid;
      *p = first ? s : *p + s;
    }
    if (tid == 0) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += draw[r];
      float* p = P + off_b + static_cast<size_t>(n_layers + 1) * C;
      *p = first ? s : *p + s;
    }
    __syncthreads();

    // ---- 5. dh^{L-1} = leaky'(h^{L-1}) * (gF w + draw wa), in place
    for (int idx = tid; idx < kRows * C; idx += kThreads) {
      const int r = idx / C, c = idx - r * C;
      const float gF = r < rows_live
          ? g[static_cast<size_t>(m0 + r / K) * (C + 1) + c] : 0.0f;
      const float da = gF * w_row[r] + draw[r] * wa[c];
      a_last[idx] = a_last[idx] >= 0.0f ? da : 0.01f * da;
    }
    __syncthreads();

    // ---- 6. hidden layers L-1 .. 1
    for (int l = n_layers - 1; l >= 1; --l) {
      float* dh = acts + l * kRows * C;
      float* prev = acts + (l - 1) * kRows * C;
      accumulate_dw(P + static_cast<size_t>(in0) * C +
                        static_cast<size_t>(l - 1) * C * C,
                    prev, C, C, dh, C, bf16, first);
      accumulate_db(P + off_b + static_cast<size_t>(l) * C, dh, C, first);
      float acc[kRI][8];
      // rows_times_w syncs before its first product: every read of `prev`
      // above is done before the writes below
      rows_times_w<8>(dh, C, C,
                      WT + static_cast<size_t>(C) * in0 +
                          static_cast<size_t>(l - 1) * C * C,
                      C, bf16, wtile, acc);
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = lane + 32 * j;
          if (c < C) {
            float* p = prev + (warp + 8 * i) * C + c;
            *p = *p >= 0.0f ? acc[i][j] : 0.01f * acc[i][j];
          }
        }
      __syncthreads();
    }

    // ---- 7. first layer: dW_0, db_0, then dx = dh^0 W_0^T into xbuf
    accumulate_dw(P, xbuf, ldx, in0, acts, C, bf16, first);
    accumulate_db(P + off_b, acts, C, first);
    {
      float acc[kRI][9];
      rows_times_w<9>(acts, C, C, WT, in0, bf16, wtile, acc);
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int c = lane + 32 * j;
          if (c < in0) xbuf[(warp + 8 * i) * ldx + c] = acc[i][j];
        }
    }
    __syncthreads();

    // ---- 8. PE chain rule: d_feat, d_dist
    const int nch = F + Dd;
    for (int idx = tid; idx < kRows * nch; idx += kThreads) {
      const int r = idx / nch, ch = idx - r * nch;
      if (r >= rows_live) continue;
      const size_t gr = r0 + r;
      const float* dx = xbuf + r * ldx;
      float v, x0;
      int base, nfr;
      if (ch < F) {
        v = dx[ch];
        base = F + 2 * ch * nf;
        x0 = feat[gr * F + ch];
        nfr = nf;
      } else {
        v = 0.0f;
        base = F + 2 * F * nf + 2 * (ch - F) * df;
        x0 = dist[gr * Dd + (ch - F)];
        nfr = df;
      }
      for (int f = 0; f < nfr; ++f) {
        const float scale = static_cast<float>(1 << f);
        const float a = x0 * scale;
        const float dz = dx[base + 2 * f] * cosf(a) - dx[base + 2 * f + 1] * sinf(a);
        v += dz * scale;
      }
      if (ch < F) dfeat[gr * F + ch] = v;
      else ddist[gr * Dd + (ch - F)] = v;
    }
    __syncthreads();  // xbuf is rewritten by the next tile
  }
}

// out[j] = sum over blocks p (in order) of partial[p * S + j].
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       int n_parts, size_t S,
                                       float* __restrict__ out) {
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= S) return;
  float s = 0.0f;
  for (int p = 0; p < n_parts; ++p) s += partial[static_cast<size_t>(p) * S + j];
  out[j] = s;
}

// Floats in one block's weight-gradient partial and in the flat
// weight-gradient output: dW_0 (in0 x C) | dW_1..dW_{L-1} (C x C) |
// db_0..db_{L-1} (C each) | dwa (C) | dba (1).
size_t params_grad_size(int n_layers, int in0, int C) {
  return static_cast<size_t>(in0) * C +
         static_cast<size_t>(n_layers - 1) * C * C +
         static_cast<size_t>(n_layers) * C + C + 1;
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat (M,K,F), dist (M,K,Dd), wgt (M,K), g (M,C+1) f32; W: the block1
// weights (in, C) row-major, concatenated; WT: their transposes (C, in),
// concatenated; Bias (n_layers, C); wa (C,), ba (1,). n_blocks >= 1 blocks
// (at most one per tile), partial (n_blocks * size) scratch. Outputs
// dfeat (M,K,F), ddist (M,K,Dd), dw (M,K) and dparams (size,) in the
// layout of params_grad_size. Needs 1 <= K <= 32, C % 32 == 0, C <= 256, in0 <= 288.
// Launches on `stream`; returns cudaGetLastError().
int fused_block1_alpha_bwd(const float* feat, const float* dist,
                           const float* wgt, const float* g, const float* W,
                           const float* WT, const float* Bias, int n_layers,
                           const float* wa, const float* ba, int M, int K,
                           int F, int nf, int Dd, int df, int C, int bf16,
                           int n_blocks, float* partial, float* dfeat,
                           float* ddist, float* dw, float* dparams,
                           cudaStream_t stream) {
  if (K < 1 || K > kRows || C < 32 || C > kMaxC || C % 32 != 0 ||
      n_layers < 1 || M < 0 || F < 1 || nf < 1 || Dd < 1 || df < 1 ||
      nf > 30 || df > 30 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int in0 = F + 2 * F * nf + 2 * Dd * df;
  if (in0 > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t S = params_grad_size(n_layers, in0, C);
  const int tm = kRows / K;
  const int n_tiles = (M + tm - 1) / tm;
  if (M > 0) {
    if (n_blocks < 1 || n_blocks > n_tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    const int ldx = (in0 + 3) & ~3;
    const int wide = in0 > C ? in0 : C;
    const size_t smem = sizeof(float) *
        (static_cast<size_t>(kRows) * ldx +
         static_cast<size_t>(n_layers) * kRows * C +
         static_cast<size_t>(kTileK) * wide + 3 * kRows);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        fused_agg_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_agg_bwd_kernel<<<n_blocks, kThreads, smem, stream>>>(
        feat, dist, wgt, g, W, WT, Bias, n_layers, wa, ba, M, K, F, nf, Dd,
        df, C, bf16, n_tiles, dfeat, ddist, dw, partial, S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    n_blocks = 0;
  }
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((S + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(partial, n_blocks, S,
                                                         dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
