// K4 and K5: the fused aggregator with its colour head (K4), and with the
// colour head and the volume march (K5), for the opt-in render paths
// `--fused_color on` and `--fused_march on`.
//
// K4 replaces sgnerf_tpu/ops/fused_agg.py `fused_block1_alpha_color`
// (`_pallas_forward_color` -> `_kernel_color`); K5 replaces
// `fused_block1_alpha_color_march` (`_kernel_color_march`). Function, per
// shading point m (K neighbour rows each):
//   [fa_m | alpha_m] = K2's reduced row (fused_agg_body.cuh);
//   x_m  = [fa_m | sin(vd_m PE) | cos(vd_m PE)], the view-direction PE
//          channel-major (row C + c*vf + f for sin, C + 3*vf + c*vf + f for
//          cos: ops/pe.py with ori=True, raw directions split off), against
//          the unpermuted colour_branch[0] weights;
//   hc_m = the colour MLP on x_m: LeakyReLU_0.01 between layers, raw logits
//          out (3 of them);
//   K4 writes (M, 4) [alpha_m | hc_m].
// K5 goes on along each ray of SR consecutive points (a ray is rows
// r*SR .. r*SR+SR-1):
//   rgb = sigmoid(hc) * 1.002 - 0.001;  sigma = alpha * ray_valid;
//   op = 1 - exp(-sigma * ray_dist);    a = 1 - op + 1e-10;
//   T_0 = 1, T_s = T_{s-1} a_{s-1} (exclusive, sequential);
//   writes (M/SR, 4) [sum_s op_s T_s rgb_s | T_{SR-1} a_{SR-1}].
// bf16 mode rounds every colour-matmul input (the reduced features, the
// PE values, the hidden activations, the weights) to bf16 and accumulates
// in f32, as the reference's `_dot_mm`; in f32 mode the colour head is
// IEEE f32 FMA (no fast math) and block1 is K2's 3xTF32.
//
// What bounds them on an H100: block1's products, as K2. The colour MLP
// adds (C + 6 vf) x 128 + 2 x 128 x 128 + 128 x 3 = 68,992 FMA a point at
// the canonical config to K2's ~1.1M (8 neighbour rows), ~6%; the fusion
// keeps the (M, C+1) reduced rows (and, for K5, every per-sample tensor of
// the march) out of device memory. Design: K4 is K2's block (K2's tile
// body on the tensor cores, the same packed weights: 128 neighbour rows in
// bf16, 128/K points; f32 runs its 64-row body twice for as many points
// where shared memory allows) followed, on the reduced rows kept in shared
// memory, by the colour layers as small dense f32 products on the CUDA
// cores: the thread c + N g (N = the layer's width) owns column c for rows
// g, g + 256/N, ..., with the weights staged through a 32-row tile in the
// body's dead region, once a colour head. K5 gives each block whole rays
// (max(1, points a colour head / SR) of them): it walks the rays' points
// in K4-sized groups, keeps [alpha | rgb] of every point in shared memory
// past the body's region, then one thread marches each ray. The colour
// heads are the simple, right first version; their tensor cores are later
// work.
#include "fused_agg_body.cuh"

using namespace sgnerf_agg;

namespace {

constexpr int kTileK = 32;  // colour weight rows staged per shared tile

// y[t * ldy + n] = act(sum_k x[t * ldx + k] W[k * N + n] + b[n]) for
// t < rows, n < N <= kThreads; W is row-major (k_in, N) in global memory,
// staged through `wtile` (kTileK x N floats). bf16 rounds the weights (the
// caller rounds x) and, with round_out, the outputs. Every thread of the
// block calls it; it returns with the block synchronised.
__device__ void dense_rows(const float* x, int ldx, int rows, int k_in,
                           const float* __restrict__ W,
                           const float* __restrict__ b, int N, bool act,
                           bool round_out, int bf16, float* wtile, float* y,
                           int ldy) {
  constexpr int R = 8;  // rows per thread and pass
  const int tid = threadIdx.x;
  const int G = kThreads / N;  // threads per column
  const int n = tid % N, g = tid / N;
  const bool on = g < G;
  for (int t0 = 0; t0 < rows; t0 += R * G) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    for (int k0 = 0; k0 < k_in; k0 += kTileK) {
      const int kt = min(kTileK, k_in - k0);
      for (int idx = tid; idx < kt * N; idx += kThreads) {
        const float v = W[static_cast<size_t>(k0) * N + idx];
        wtile[idx] = bf16 ? round_bf16(v) : v;
      }
      __syncthreads();
      if (on) {
        for (int kk = 0; kk < kt; ++kk) {
          const float wv = wtile[kk * N + n];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int t = t0 + g + i * G;
            if (t < rows) acc[i] = fmaf(x[t * ldx + k0 + kk], wv, acc[i]);
          }
        }
      }
      __syncthreads();  // the tile is consumed before it is overwritten
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = t0 + g + i * G;
        if (t < rows) {
          float v = acc[i] + b[n];
          if (act) v = leaky(v);
          if (round_out) v = round_bf16(v);
          y[t * ldy + n] = v;
        }
      }
    }
  }
  __syncthreads();
}

// The colour head on n reduced rows `red` (row stride C + 1) of the points
// m0 .. m0+n-1: builds x = [fa | PE(vd)] in `scratch`, runs the n_clayers
// layers (hidden width Nh, 3 logits out) and writes the logits to
// logits[t * 3 + j]. scratch holds n * (C + 6 vf + 2 Nh) floats.
__device__ void color_head(const float* red, int n, const float* __restrict__ vd,
                           int m0, int C, int vf,
                           const float* __restrict__ CW,
                           const float* __restrict__ CB, int n_clayers, int Nh,
                           int bf16, float* scratch, float* wtile,
                           float* logits) {
  const int in0c = C + 6 * vf;
  float* cx = scratch;                    // n x in0c
  float* hbuf[2] = {cx + n * in0c, cx + n * in0c + n * Nh};  // n x Nh each
  for (int idx = threadIdx.x; idx < n * in0c; idx += kThreads) {
    const int t = idx / in0c, j = idx - t * in0c;
    float v;
    if (j < C) {
      v = red[t * (C + 1) + j];
    } else {
      const int q = j - C, cf = q % (3 * vf);
      const float a = vd[static_cast<size_t>(m0 + t) * 3 + cf / vf] *
                      static_cast<float>(1 << (cf % vf));
      v = q < 3 * vf ? sinf(a) : cosf(a);
    }
    cx[idx] = bf16 ? round_bf16(v) : v;
  }
  __syncthreads();
  const float* in = cx;
  int k_in = in0c;
  const float* Wl = CW;
  const float* bl = CB;
  for (int l = 0; l < n_clayers; ++l) {
    const bool last = l == n_clayers - 1;
    const int N = last ? 3 : Nh;
    float* y = last ? logits : hbuf[l & 1];
    dense_rows(in, k_in, n, k_in, Wl, bl, N, !last, bf16 && !last, bf16,
               wtile, y, N);
    Wl += static_cast<size_t>(k_in) * N;
    bl += N;
    in = y;
    k_in = N;
  }
}

// Byte offsets in a K4/K5 block's shared memory past the body's head:
// the colour scratch and its weight tile over the body's dead region, the
// reduced rows and logits past the body's staging (the K-sum writes them
// while it reads the staging; with nsub > 1 bodies a colour head, past
// the body's whole region, which the next body takes), K5's per-point
// [alpha | rgb] past all of it.
struct ColorLayout {
  size_t wtile, red, logits, pts, total;
};

// Bodies a colour head: f32's 64-row tiles hold half bf16's points, so f32
// runs two bodies into the reduced rows before one colour head (which
// streams the colour weights once a head) where shared memory allows.
constexpr int kMaxSub = kRows / 64;

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline ColorLayout color_layout(int F, int nf, int Dd,
                                                    int df, int C, int K,
                                                    int vf, int Nh, bool bf16,
                                                    int march_pts, int nsub) {
  const BodyLayout B = body_layout(block1_in(F, nf, Dd, df), F + Dd + 2, C, bf16);
  const size_t tm = static_cast<size_t>(tile_rows(bf16) / K) * nsub;
  const size_t scratch = align16(tm * (C + 6 * vf + 2 * Nh) * sizeof(float));
  const size_t wtile = static_cast<size_t>(kTileK) * C * sizeof(float);
  const size_t kept = nsub > 1 ? B.region_bytes : B.staging_bytes;
  ColorLayout L;
  L.wtile = kHeadBytes + scratch;
  L.red = kHeadBytes + align16(kept > scratch + wtile ? kept : scratch + wtile);
  L.logits = L.red + align16(tm * (C + 1) * sizeof(float));
  const size_t end = L.logits + align16(tm * 3 * sizeof(float));
  const size_t body_end = kHeadBytes + B.region_bytes;
  L.pts = end > body_end ? end : body_end;
  L.total = L.pts + static_cast<size_t>(march_pts) * 4 * sizeof(float);
  return L;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_agg_color_kernel(const float* __restrict__ feat,
                       const float* __restrict__ dist,
                       const float* __restrict__ wgt,
                       const float* __restrict__ vd,
                       const void* __restrict__ Wp,
                       const float* __restrict__ Bias, int n_layers,
                       const float* __restrict__ wa,
                       const float* __restrict__ ba,
                       const float* __restrict__ CW,
                       const float* __restrict__ CB, int n_clayers, int Nh,
                       int M, int K, int F, int nf, int Dd, int df, int C,
                       int vf, int nsub, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorLayout CL =
      color_layout(F, nf, Dd, df, C, K, vf, Nh, BF16, 0, nsub);
  if (threadIdx.x == 0) ring_init(smem);
  __syncthreads();
  uint32_t ring_it = 0;
  const int tm = tile_rows(BF16) / K;  // points a body
  const int m0 = blockIdx.x * tm * nsub;
  const int n = min(tm * nsub, M - m0);
  float* red = reinterpret_cast<float*>(smem + CL.red);  // n x (C+1)
  float* logits = reinterpret_cast<float*>(smem + CL.logits);  // n x 3
  for (int sb = 0; sb * tm < n; ++sb)  // uniform across the block
    block1_alpha_tile<BF16>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba, K,
                            F, nf, Dd, df, C, m0 + sb * tm,
                            min(tm, n - sb * tm), smem, ring_it,
                            red + static_cast<size_t>(sb) * tm * (C + 1),
                            C + 1);
  color_head(red, n, vd, m0, C, vf, CW, CB, n_clayers, Nh, BF16,
             reinterpret_cast<float*>(smem + kHeadBytes),
             reinterpret_cast<float*>(smem + CL.wtile), logits);
  for (int idx = threadIdx.x; idx < n * 4; idx += kThreads) {
    const int t = idx >> 2, c = idx & 3;
    out[static_cast<size_t>(m0 + t) * 4 + c] =
        c == 0 ? red[t * (C + 1) + C] : logits[t * 3 + c - 1];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_agg_march_kernel(const float* __restrict__ feat,
                       const float* __restrict__ dist,
                       const float* __restrict__ wgt,
                       const float* __restrict__ vd,
                       const float* __restrict__ ray_dist,
                       const float* __restrict__ ray_valid,
                       const void* __restrict__ Wp,
                       const float* __restrict__ Bias, int n_layers,
                       const float* __restrict__ wa,
                       const float* __restrict__ ba,
                       const float* __restrict__ CW,
                       const float* __restrict__ CB, int n_clayers, int Nh,
                       int M, int K, int F, int nf, int Dd, int df, int C,
                       int vf, int SR, int rays_per_block, int nsub,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColorLayout CL =
      color_layout(F, nf, Dd, df, C, K, vf, Nh, BF16, 0, nsub);
  if (threadIdx.x == 0) ring_init(smem);
  __syncthreads();
  uint32_t ring_it = 0;
  const int tm = tile_rows(BF16) / K;
  const int ray0 = blockIdx.x * rays_per_block;
  const int rays = min(rays_per_block, M / SR - ray0);
  const int p0 = ray0 * SR, n_pts = rays * SR;
  float* red = reinterpret_cast<float*>(smem + CL.red);        // tm x (C+1)
  float* logits = reinterpret_cast<float*>(smem + CL.logits);  // tm x 3
  float* pts = reinterpret_cast<float*>(smem + CL.pts);  // n_pts x 4: [alpha | rgb]
  float* scratch = reinterpret_cast<float*>(smem + kHeadBytes);
  float* wtile = reinterpret_cast<float*>(smem + CL.wtile);
  for (int s0 = 0; s0 < n_pts; s0 += tm * nsub) {
    const int n = min(tm * nsub, n_pts - s0);
    for (int sb = 0; sb * tm < n; ++sb)  // uniform across the block
      block1_alpha_tile<BF16>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba, K,
                              F, nf, Dd, df, C, p0 + s0 + sb * tm,
                              min(tm, n - sb * tm), smem, ring_it,
                              red + static_cast<size_t>(sb) * tm * (C + 1),
                              C + 1);
    color_head(red, n, vd, p0 + s0, C, vf, CW, CB, n_clayers, Nh, BF16,
               scratch, wtile, logits);
    for (int idx = threadIdx.x; idx < n * 4; idx += kThreads) {
      const int t = idx >> 2, c = idx & 3;
      float v;
      if (c == 0) {
        v = red[t * (C + 1) + C];
      } else {  // raw2out_color with act_super
        const float h = logits[t * 3 + c - 1];
        v = 1.0f / (1.0f + expf(-h)) * 1.002f - 0.001f;
      }
      pts[(s0 + t) * 4 + c] = v;
    }
    __syncthreads();
  }
  // the march: one thread a ray, its SR points in order
  for (int r = threadIdx.x; r < rays; r += kThreads) {
    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int s = 0; s < SR; ++s) {
      const int i = r * SR + s;
      const size_t gi = static_cast<size_t>(p0) + i;
      const float sigma = pts[i * 4] * ray_valid[gi];
      const float op = 1.0f - expf(-sigma * ray_dist[gi]);
      const float ws = op * T;
      c0 += ws * pts[i * 4 + 1];
      c1 += ws * pts[i * 4 + 2];
      c2 += ws * pts[i * 4 + 3];
      T = T * (1.0f - op + 1e-10f);
    }
    float* o = out + static_cast<size_t>(ray0 + r) * 4;
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
    o[3] = T;
  }
}

// Bytes of shared memory of a K4/K5 block (march_pts: K5's points a
// block; nsub bodies a colour head); 0 when the shape does not fit one
// block.
size_t color_smem_bytes(int K, int F, int nf, int Dd, int df, int C, int vf,
                        int n_clayers, int Nh, bool bf16, int march_pts,
                        int nsub) {
  if (n_clayers < 1 || vf < 1 || vf > 30 || Nh < 3 || Nh > C) return 0;
  const size_t total =
      color_layout(F, nf, Dd, df, C, K, vf, Nh, bf16, march_pts, nsub).total;
  return total > kMaxSmem ? 0 : total;
}

// K5's rays a block for nsub bodies a colour head.
int march_rays(int K, int SR, bool bf16, int nsub) {
  const int pts = tile_rows(bf16) / K * nsub;
  return pts / SR > 1 ? pts / SR : 1;
}

// A K4 (SR = 0) or K5 block's shared memory and its bodies a colour head:
// the most bodies (f32: up to kMaxSub) whose block fits. *smem = 0 when
// none does.
void pick_layout(int K, int F, int nf, int Dd, int df, int C, int vf,
                 int n_clayers, int Nh, int SR, bool bf16, size_t* smem,
                 int* nsub) {
  *smem = 0;
  for (*nsub = bf16 ? 1 : kMaxSub; *nsub >= 1; --*nsub) {
    const int pts = SR > 0 ? march_rays(K, SR, bf16, *nsub) * SR : 0;
    *smem = color_smem_bytes(K, F, nf, Dd, df, C, vf, n_clayers, Nh, bf16,
                             pts, *nsub);
    if (*smem > 0) return;
  }
}

bool agg_args_ok(int M, int K, int F, int nf, int Dd, int df, int C,
                 int n_layers) {
  return !(K < 1 || K > 32 || C < 32 || C > kMaxC || C % 32 != 0 ||
           n_layers < 1 || M < 0 || F < 1 || nf < 1 || Dd < 1 || df < 1 ||
           nf > 30 || df > 30);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4. feat (M,K,F), dist (M,K,Dd), wgt (M,K), vd (M,3) f32; Wp/Bias/wa/ba
// as K2 (fused_agg.cu: Wp packed by `pack_block1` for this mode); CW: the
// n_clayers colour weights, (C + 6 vf, Nh), (Nh, Nh)..., (Nh, 3) row-major
// and concatenated (a single layer is (C + 6 vf, 3)); CB their biases,
// concatenated -> out (M, 4) f32 [alpha | raw rgb]. Needs 1 <= K <= 32,
// C % 32 == 0, C <= 256, 3 <= Nh <= C and a block within 227 KB of shared
// memory (K >= 3 at the canonical widths). Launches on `stream`; returns
// cudaGetLastError().
int fused_block1_alpha_color(const float* feat, const float* dist,
                             const float* wgt, const float* vd,
                             const void* Wp, const float* Bias, int n_layers,
                             const float* wa, const float* ba,
                             const float* CW, const float* CB, int n_clayers,
                             int Nh, int M, int K, int F, int nf, int Dd,
                             int df, int C, int vf, int bf16, float* out,
                             cudaStream_t stream) {
  if (!agg_args_ok(M, K, F, nf, Dd, df, C, n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  int nsub = 0;
  pick_layout(K, F, nf, Dd, df, C, vf, n_clayers, Nh, 0, bf16 != 0, &smem,
              &nsub);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaError_t e = bf16 ? allow_smem(fused_agg_color_kernel<true>, smem)
                       : allow_smem(fused_agg_color_kernel<false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pts = tile_rows(bf16 != 0) / K * nsub;
  const int blocks = (M + pts - 1) / pts;
  auto kernel = bf16 ? fused_agg_color_kernel<true>
                     : fused_agg_color_kernel<false>;
  kernel<<<blocks, kThreads, smem, stream>>>(
      feat, dist, wgt, vd, Wp, Bias, n_layers, wa, ba, CW, CB, n_clayers, Nh,
      M, K, F, nf, Dd, df, C, vf, nsub, out);
  return static_cast<int>(cudaGetLastError());
}

// K5. As K4, plus ray_dist (M,) and ray_valid (M,) f32, with M = n_rays * SR
// and each ray's SR points consecutive -> out (M/SR, 4) f32
// [ray colour | background transmission]. Launches on `stream`; returns
// cudaGetLastError().
int fused_block1_alpha_color_march(
    const float* feat, const float* dist, const float* wgt, const float* vd,
    const float* ray_dist, const float* ray_valid, const void* Wp,
    const float* Bias, int n_layers, const float* wa, const float* ba,
    const float* CW, const float* CB, int n_clayers, int Nh, int M, int K,
    int F, int nf, int Dd, int df, int C, int vf, int SR, int bf16,
    float* out, cudaStream_t stream) {
  if (!agg_args_ok(M, K, F, nf, Dd, df, C, n_layers) || SR < 1 ||
      M % SR != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  int nsub = 0;
  pick_layout(K, F, nf, Dd, df, C, vf, n_clayers, Nh, SR, bf16 != 0, &smem,
              &nsub);
  const int rays_per_block = march_rays(K, SR, bf16 != 0, nsub);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaError_t e = bf16 ? allow_smem(fused_agg_march_kernel<true>, smem)
                       : allow_smem(fused_agg_march_kernel<false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_rays = M / SR;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  auto kernel = bf16 ? fused_agg_march_kernel<true>
                     : fused_agg_march_kernel<false>;
  kernel<<<blocks, kThreads, smem, stream>>>(
      feat, dist, wgt, vd, ray_dist, ray_valid, Wp, Bias, n_layers, wa, ba,
      CW, CB, n_clayers, Nh, M, K, F, nf, Dd, df, C, vf, SR, rays_per_block,
      nsub, out);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a K4 (SR = 0) or K5 block takes at these
// widths, or 0 when no layout fits a block (ops/fused_agg.py
// k4_supports). Host arithmetic only.
int fused_block1_alpha_color_smem(int K, int F, int nf, int Dd, int df,
                                  int C, int vf, int n_clayers, int Nh,
                                  int SR, int bf16) {
  if (!agg_args_ok(0, K, F, nf, Dd, df, C, 1) || SR < 0) return 0;
  size_t smem = 0;
  int nsub = 0;
  pick_layout(K, F, nf, Dd, df, C, vf, n_clayers, Nh, SR, bf16 != 0, &smem,
              &nsub);
  return static_cast<int>(smem);
}

}  // extern "C"
