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
// What bounds it on an H100: the tensor cores. A canonical 9216-ray chunk
// is 4.9e11 FLOP of products: 0.50 ms at the bf16 peak (989 TFLOP/s) and,
// in f32 mode, three tf32 passes at 495 TFLOP/s (3.0 ms), against 0.14 ms
// of HBM traffic; next come the L2 traffic of the weights every tile
// streams and the CUDA-core work around the products. Design: one block
// of two warpgroups per tile of 128 rows (bf16) or 64 (f32), 128 / K or
// 64 / K whole shading points; the
// tile body, fused_agg_body.cuh (shared with K4 and K5), runs every block1
// product as Hopper wgmma (bf16, or 3xTF32 in f32 mode) from A in shared
// memory and a TMA-fed ring of pre-packed weight k-slices, and writes only
// the (M, C+1) rows.
#include "fused_agg_body.cuh"

using namespace sgnerf_agg;

namespace {

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_agg_kernel(const float* __restrict__ feat, const float* __restrict__ dist,
                 const float* __restrict__ wgt, const void* __restrict__ Wp,
                 const float* __restrict__ Bias, int n_layers,
                 const float* __restrict__ wa, const float* __restrict__ ba,
                 int M, int K, int F, int nf, int Dd, int df, int C,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) ring_init(smem);
  __syncthreads();
  uint32_t ring_it = 0;
  const int tm = tile_rows(BF16) / K;   // shading points per block
  const int m0 = blockIdx.x * tm;
  block1_alpha_tile<BF16>(feat, dist, wgt, Wp, Bias, n_layers, wa, ba, K, F,
                          nf, Dd, df, C, m0, min(tm, M - m0), smem, ring_it,
                          out + static_cast<size_t>(m0) * (C + 1), C + 1);
}

bool args_ok(int M, int K, int F, int nf, int Dd, int df, int C,
             int n_layers) {
  return !(K < 1 || K > 64 || C < 32 || C > kMaxC || C % 32 != 0 ||
           n_layers < 1 || M < 0 || F < 1 || nf < 1 || Dd < 1 || df < 1 ||
           nf > 30 || df > 30);
}

template <bool BF16>
cudaError_t prepare(size_t* smem, int F, int nf, int Dd, int df, int C) {
  *smem = body_smem_bytes(F, nf, Dd, df, C, BF16);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fused_agg_kernel<BF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// feat (M,K,F), dist (M,K,Dd), wgt (M,K) f32; Wp: the block1 weights as
// ops/fused_agg.py `pack_block1` packs them for this mode (bf16 k-slices,
// or tf32 hi/lo k-slices for f32 mode); Bias (n_layers, C); wa (C,),
// ba (1,) -> out (M, C+1) f32. Needs 1 <= K <= 64, C % 32 == 0, C <= 256.
// Launches on `stream`; returns cudaGetLastError().
int fused_block1_alpha(const float* feat, const float* dist, const float* wgt,
                       const void* Wp, const float* Bias, int n_layers,
                       const float* wa, const float* ba, int M, int K, int F,
                       int nf, int Dd, int df, int C, int bf16, float* out,
                       cudaStream_t stream) {
  if (!args_ok(M, K, F, nf, Dd, df, C, n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  size_t smem = 0;
  cudaError_t e = bf16 ? prepare<true>(&smem, F, nf, Dd, df, C)
                       : prepare<false>(&smem, F, nf, Dd, df, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tm = tile_rows(bf16 != 0) / K;
  const int blocks = (M + tm - 1) / tm;
  if (bf16)
    fused_agg_kernel<true><<<blocks, kThreads, smem, stream>>>(
        feat, dist, wgt, Wp, Bias, n_layers, wa, ba, M, K, F, nf, Dd, df, C,
        out);
  else
    fused_agg_kernel<false><<<blocks, kThreads, smem, stream>>>(
        feat, dist, wgt, Wp, Bias, n_layers, wa, ba, M, K, F, nf, Dd, df, C,
        out);
  return static_cast<int>(cudaGetLastError());
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
  const size_t smem = body_smem_bytes(F, nf, Dd, df, C, bf16 != 0);
  return smem > kMaxSmem ? 0 : static_cast<int>(smem);
}

}  // extern "C"
