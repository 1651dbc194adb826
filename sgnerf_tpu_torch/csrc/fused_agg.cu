// K2: fused aggregator forward — PE -> block1 -> per-neighbour alpha ->
// weighted K-reduction, for the eval render.
//
// Replaces the TPU kernel sgnerf_tpu/ops/fused_agg.py `fused_block1_alpha`
// forward (`_pallas_forward` -> `_kernel` -> `_block1_alpha_body`).
// Function, per neighbour row r (M*K rows, K rows per shading point):
//   x_r   = [feat | PE(feat, nf) | PE(d, df)] in the reference's interleaved
//           layout (ops/pe.py: frequency innermost per channel, sin/cos
//           interleaved), against the unpermuted block1 weights;
//   h_r   = LeakyReLU_0.01(... LeakyReLU_0.01(x_r W0 + b0) ... W_{n-1} + b_{n-1});
//   a_r   = softplus(h_r . wa + ba - 1);
//   out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}]            -> (M, C+1).
// bf16 mode rounds every matmul input (x, hidden activations, weights) to
// bf16 with __float2bfloat16_rn and accumulates in f32, as the reference's
// `_dot_mm`; the alpha head and the K-reduction stay f32. f32 mode is IEEE
// f32 FMA throughout (no TF32).
//
// What bounds it on an H100: arithmetic. A row costs (284 + 256) x 256 MACs
// for the canonical config against ~200 bytes of input, ~700 MACs per byte,
// far above the card's ridge point. What fusion removes is memory traffic:
// the un-fused path writes and reads back the (1.77M, 284) PE input and two
// (1.77M, 256) activations per 9216-ray chunk, 5.6 GB of float32 each way.
// Design: a block takes 64 neighbour rows (64 / K whole shading points),
// builds their PE rows in shared memory, and runs every layer as a
// register-tiled FMA product: 256 threads, each 8 rows x 8 columns, with
// 32-row tiles of the weight matrix staged through shared memory. Hidden
// activations ping-pong between two shared buffers; only (M, C+1) is
// written. The tile body is fused_agg_body.cuh, which K4 and K5
// (fused_agg_color.cu) share. This is the simple, right first version on CUDA cores; tensor
// cores (wgmma) and TMA staging are later work.
#include "fused_agg_body.cuh"

using namespace sgnerf_agg;

namespace {

__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const float* __restrict__ feat, const float* __restrict__ dist,
                 const float* __restrict__ wgt, const float* __restrict__ W,
                 const float* __restrict__ Bias, int n_layers,
                 const float* __restrict__ wa, const float* __restrict__ ba,
                 int M, int K, int F, int nf, int Dd, int df, int C, int bf16,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tm = kRows / K;             // shading points per block
  const int m0 = blockIdx.x * tm;
  block1_alpha_tile(feat, dist, wgt, W, Bias, n_layers, wa, ba, K, F, nf, Dd,
                    df, C, bf16, m0, min(tm, M - m0), smem,
                    out + static_cast<size_t>(m0) * (C + 1), C + 1);
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat (M,K,F), dist (M,K,Dd), wgt (M,K) f32; W: the n_layers block1 weight
// matrices, each (in, C) row-major, concatenated; Bias (n_layers, C);
// wa (C,), ba (1,) -> out (M, C+1) f32. Needs 1 <= K <= 64,
// C % 32 == 0, C <= 256. Launches on `stream`; returns cudaGetLastError().
int fused_block1_alpha(const float* feat, const float* dist, const float* wgt,
                       const float* W, const float* Bias, int n_layers,
                       const float* wa, const float* ba, int M, int K, int F,
                       int nf, int Dd, int df, int C, int bf16, float* out,
                       cudaStream_t stream) {
  if (K < 1 || K > kRows || C < 32 || C > kMaxC || C % 32 != 0 ||
      n_layers < 1 || M < 0 || F < 1 || nf < 1 || Dd < 1 || df < 1 ||
      nf > 30 || df > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const size_t smem =
      sizeof(float) * body_smem_floats(block1_in(F, nf, Dd, df), C);
  cudaError_t e = cudaFuncSetAttribute(
      fused_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tm = kRows / K;
  const int blocks = (M + tm - 1) / tm;
  fused_agg_kernel<<<blocks, kThreads, smem, stream>>>(
      feat, dist, wgt, W, Bias, n_layers, wa, ba, M, K, F, nf, Dd, df, C,
      bf16, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
