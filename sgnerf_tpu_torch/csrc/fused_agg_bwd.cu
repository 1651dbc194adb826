// K3: fused aggregator backward — the gradient of K2 (csrc/fused_agg.cu)
// for training, as three launches over the N = M*K neighbour rows.
//
// Replaces the TPU kernel sgnerf_tpu/ops/fused_agg.py `_pallas_backward`
// (`_bwd_kernel`). Given the cotangent g (M, C+1) = [gF | gA] of
// out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}], per neighbour row r:
//   x_r, h^0..h^{L-1}, raw_r = h^{L-1}_r . wa + ba    (the forward again);
//   d_w[r]   = h^{L-1}_r . gF_m + softplus(raw_r - 1) gA_m;
//   draw_r   = gA_m w_r sigmoid(raw_r - 1)             (softplus' = sigmoid);
//   da       = gF_m w_r + draw_r wa;
//   dh^l     = da where h^l >= 0 else 0.01 da  (leaky_relu' by the
//              activation's sign, slope 1 at exactly 0, as jax.nn.leaky_relu),
//   da      <- dh^l W_l^T, down to dx = dh^0 W_0^T, folded through the PE
//              into d_feat and d_dist (sum_f 2^f (d sin . cos - d cos . sin));
//   dW_0 = sum_r x_r^T dh^0_r,  dW_l = sum_r h^{l-1}_r^T dh^l_r,
//   db_l = sum_r dh^l_r,  dwa = sum_r h^{L-1}_r draw_r,  dba = sum_r draw_r.
// bf16 mode rounds every product input (x, the activations, dh, the
// weights, the weight-gradient operands) to bf16 and sums in f32, where
// the reference's `_dot_mm`/`dotT` round; the bias sums, the alpha head
// and the PE chain rule stay f32 on unrounded values.
//
// What bounds it on an H100: operations. At the canonical train step (N =
// 196,608 rows, block1 284 -> 256 -> 256) the recompute and the data
// gradient are 27.2 G FMA each, on the tensor cores (3xTF32 at 495 TFLOP/s:
// 0.66 ms together), the weight gradient 27.2 G FMA on the FP32 cores (67
// TFLOP/s: 0.81 ms). The saved activations add ~0.6 GB written and read.
//
// Design, three launches (plus K3c's reduction), each with a plain
// PyTorch statement in ops/fused_agg.py (`k3a_recompute_plain`, ...):
// - K3a `k3a_recompute_kernel`: K2's tile body (fused_agg_body.cuh) with
//   its save epilogue, rows taken as points of one neighbour (no K-sum):
//   K2's PE, products and epilogue in K2's order, so every activation, and
//   the LeakyReLU branch the backward reads from it, is the forward's bit
//   for bit (as the JAX kernel's recompute is its forward's). Writes x
//   (N, ldx), h (L, N, C) and raw (N,) in f32, the values before bf16
//   mode rounds them.
// - K3b `k3b_dgrad_kernel`: the data-gradient chain on K2's machinery, a
//   tile of rows a block (128 in bf16, 64 in f32, as the body). The tile's
//   dh^{L-1} is formed from h^{L-1}, g, w and raw straight into the A
//   operand in shared memory; then each product dh^l W_l^T is wgmma with
//   A from shared memory (bf16) or registers (f32: 3xTF32 with the big and
//   small products in separate accumulators), against W^T packed by
//   `pack_block1_bwd` into the body's k-slices and streamed through the
//   same TMA ring. Its epilogue takes leaky' from the saved h^{l-1} and
//   writes the next A in place. dx's 284 columns take two products: 256
//   columns, then 32 (bf16 m64n32, f32 m64n16 a warpgroup) into a small
//   buffer, taken first so that the 256 land over the dead A and ring; a
//   thread per (row, channel) then folds the PE. Writes every dh^l and
//   the tile's partial of [dwa | dba] (a thread a column, rows in order).
// - K3c `k3c_wgrad_kernel`: the weight gradients as a register-blocked
//   split-K GEMM on the FP32 cores in IEEE f32 (fmaf): a block computes a
//   128 x 128 tile of one dW over one fixed slab of kSlab rows (8 x 8
//   sums a thread, 16-row stages of both operands double-buffered by
//   cp.async), and the blocks of the first row tile also sum D's columns
//   (db). Each slab writes its own partial; `k3c_reduce_kernel` adds them
//   in slab order and K3b's tile partials in tile order. No atomics, so
//   reruns give the same bits.
#include "fused_agg_body.cuh"

using namespace sgnerf_agg;

namespace {

constexpr int kPass2 = 32;               // dx columns past 256
constexpr int kMaxIn = kWgN + kPass2;    // widest block1 input K3 takes
constexpr int kLdd = kWgN + 4;           // dx staging's row stride (floats)
constexpr int kSlab = 2048;              // rows a K3c partial sums
constexpr int kTI = 128, kTC = 128;      // a K3c block's output tile
constexpr int kKC = 16;                  // rows a K3c stage holds

// As wgmma_m64n256k16 for 64 x 32: d[OFF ..] holds this thread's 16 sums.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[N], uint64_t da,
    uint64_t db, int accumulate) {
  static_assert(OFF + 16 <= N, "accumulators");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// As wgmma_m64n128k8_tf32 for 64 x 16: d[OFF ..] holds this thread's 8 sums.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_m64n16k8_tf32(float (&d)[N],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 8 <= N, "accumulators");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- K3a: K2's tile body, saving what the backward reads
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k3a_recompute_kernel(const float* __restrict__ feat,
                     const float* __restrict__ dist,
                     const void* __restrict__ Wp,
                     const float* __restrict__ Bias, int n_layers,
                     const float* __restrict__ wa,
                     const float* __restrict__ ba, int N, int F, int nf,
                     int Dd, int df, int C, SaveArgs save) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) ring_init(smem);
  __syncthreads();
  uint32_t ring_it = 0;
  constexpr int kR = tile_rows(BF16);
  const int r0 = blockIdx.x * kR;
  block1_alpha_tile<BF16, true>(feat, dist, nullptr, Wp, Bias, n_layers, wa,
                                ba, 1, F, nf, Dd, df, C, r0,
                                min(kR, N - r0), smem, ring_it, nullptr, 0,
                                save);
}

// ---- K3b: the data-gradient chain
// Shared memory past the body's head: A (the tile's dh, as the body lays
// out A: bf16 chunks, or f32 rows of lda floats), the ring, and past both
// (or past dx's 256-column staging, which overlays them once they are
// dead) the 32 dx columns beyond 256.
struct DgradLayout {
  int lda;
  size_t ring_off, dx2_off, bytes;
};

__host__ __device__ inline DgradLayout dgrad_layout(int C, bool bf16) {
  DgradLayout L;
  const int rows = tile_rows(bf16);
  L.lda = C + 4;  // 4 (mod 32) words: fragment loads of 8 rows hit 32 banks
  const size_t a_bytes =
      static_cast<size_t>(rows) * (bf16 ? 2 * C : 4 * L.lda);
  L.ring_off = (a_bytes + 127) / 128 * 128;
  const size_t ring_end =
      L.ring_off + static_cast<size_t>(ring_stages(bf16)) * kSliceBytes;
  const size_t staging = static_cast<size_t>(rows) * kLdd * sizeof(float);
  L.dx2_off = ((ring_end > staging ? ring_end : staging) + 127) / 128 * 128;
  L.bytes = L.dx2_off + static_cast<size_t>(rows) * kPass2 * sizeof(float);
  return L;
}

// The weight ring of a K3b block: the k-slices of the packed W^T in order.
// `next` is the slice a wait returns (every thread keeps it); `issued`
// counts the slices thread 0 has given to the TMA.
struct Ring {
  uint64_t* bars;
  unsigned char* stages;
  const unsigned char* src;
  int n_slices, n_stages, issued, next;

  __device__ void refill(int done) {  // slices < done are consumed
    if (threadIdx.x == 0)
      for (; issued < n_slices && issued < done + n_stages; ++issued) {
        const int st = issued % n_stages;
        bulk_load(smem_addr(stages + st * kSliceBytes),
                  src + static_cast<size_t>(issued) * kSliceBytes,
                  kSliceBytes, smem_addr(bars + st));
      }
  }
  __device__ uint32_t wait() {
    const int st = next % n_stages;
    bar_wait(smem_addr(bars + st), (next / n_stages) & 1);
    return smem_addr(stages + st * kSliceBytes);
  }
};

// acc = A (the tile's dh in shared memory, `depth` columns) . B over the
// ring's next depth / slice_depth k-slices. NA = kAccs: 256 columns (bf16:
// a warpgroup's 64 rows x 256; f32: all 64 rows x the warpgroup's 128,
// big products in acc[0..63], small ones in acc[64..]). NA = 16: the 32
// columns past 256 (bf16: 64 x 32; f32: 64 x the warpgroup's 16, big in
// acc[0..7], small in acc[8..]). As the body: a slice's products are
// issued before the previous slice's are waited for. Returns with the
// block synchronised and every product done.
template <bool BF16, int NA>
__device__ __forceinline__ void ring_product(float (&acc)[NA], Ring& ring,
                                             int depth,
                                             const unsigned char* A, int lda,
                                             int rw, int wg_row, int wg) {
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  const int t = threadIdx.x & 3;
  const int ns = depth / slice_depth(BF16);
  // the warpgroup's columns of each plane, 16 bytes a column
  const uint32_t bcol = BF16 ? 0u : (NA == kAccs ? wg * 128 * 16 : wg * 16 * 16);
  uint32_t ah[2][4], al[2][4];
  auto step = [&](int s, auto set) {
    constexpr int B = decltype(set)::value;
    const uint32_t slice = ring.wait();
    if constexpr (BF16) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t da = wgmma_desc(
            smem_addr(A) + ((s * 32 + 16 * kk) >> 3) * (kRows * 16) +
                wg_row * 16,
            kRows * 16, 128);
        const uint64_t db =
            wgmma_desc(slice + 2 * kk * (kWgN * 16), kWgN * 16, 128);
        if constexpr (NA == kAccs)
          wgmma_m64n256k16(acc, da, db, 1);
        else
          wgmma_m64n32k16<0>(acc, da, db, 1);
      }
    } else {
      const float* p =
          reinterpret_cast<const float*>(A) + rw * lda + s * 8 + t;
      const float v[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[B][i] = tf32_rna(v[i]);
        al[B][i] = tf32_rna(v[i] - __uint_as_float(ah[B][i]));
      }
      const uint64_t bh = wgmma_desc(slice + bcol, kWgN * 16, 128);
      const uint64_t blo =
          wgmma_desc(slice + bcol + 2 * kWgN * 16, kWgN * 16, 128);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if constexpr (NA == kAccs) {
        wgmma_m64n128k8_tf32<NA / 2>(acc, al[B], bh);  // small products
        wgmma_m64n128k8_tf32<NA / 2>(acc, ah[B], blo);
        wgmma_m64n128k8_tf32<0>(acc, ah[B], bh);       // big products
      } else {
        wgmma_m64n16k8_tf32<NA / 2>(acc, al[B], bh);
        wgmma_m64n16k8_tf32<NA / 2>(acc, ah[B], blo);
        wgmma_m64n16k8_tf32<0>(acc, ah[B], bh);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();  // every warpgroup is done with the previous slice
    ring.refill(ring.next);
    ++ring.next;
  };
  for (int s = 0; s < ns; s += 2) {
    step(s, std::integral_constant<int, 0>());
    if (s + 1 < ns) step(s + 1, std::integral_constant<int, 1>());
  }
  wgmma_wait_all(acc);
  __syncthreads();  // both warpgroups' products read A and the ring
  ring.refill(ring.next);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k3b_dgrad_kernel(const float* __restrict__ X, int ldx,
                 const float* __restrict__ H, const float* __restrict__ Raw,
                 const float* __restrict__ wgt, const float* __restrict__ g,
                 const void* __restrict__ WTp, const float* __restrict__ wa,
                 int n_layers, int N, int K, int F, int nf, int Dd, int df,
                 int C, float* __restrict__ dfeat, float* __restrict__ ddist,
                 float* __restrict__ dw, float* __restrict__ DH,
                 float* __restrict__ alpha_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kR = tile_rows(BF16);
  const int in0 = block1_in(F, nf, Dd, df);
  const DgradLayout L = dgrad_layout(C, BF16);
  float* w_s = reinterpret_cast<float*>(smem + 64);  // kRows: w_r
  float* draw_s = w_s + kRows;                       // kRows: draw_r
  float* wa_s = draw_s + kRows + kMaxC;              // C: wa (the head's slot)
  unsigned char* region = smem + kHeadBytes;
  float* Af = reinterpret_cast<float*>(region);
  float* stg = reinterpret_cast<float*>(region);  // dx columns < 256
  float* dx2 = reinterpret_cast<float*>(region + L.dx2_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3, wg = warp >> 2;
  const int wg_row = BF16 ? wg * 64 : 0;
  const int wg_col = BF16 ? 0 : wg * 128;
  const int rw = wg_row + 16 * (warp & 3) + (lane >> 2);
  const size_t NC = static_cast<size_t>(N) * C;
  const int r0 = blockIdx.x * kR;
  const int rows_live = min(kR, N - r0);
  const bool two = in0 > kWgN;
  Ring ring{reinterpret_cast<uint64_t*>(smem), region + L.ring_off,
            static_cast<const unsigned char*>(WTp),
            (n_layers + (two ? 1 : 0)) * (C / slice_depth(BF16)),
            ring_stages(BF16), 0, 0};
  if (tid == 0) ring_init(smem);
  __syncthreads();
  ring.refill(0);  // the first slices load while dh^{L-1} is formed

  auto putA2 = [&](int r, int c, float v0, float v1) {  // c even
    if constexpr (BF16)
      *reinterpret_cast<__nv_bfloat162*>(region + (c >> 3) * (kRows * 16) +
                                         r * 16 + (c & 7) * 2) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(Af + r * L.lda + c) = make_float2(v0, v1);
  };

  // ---- 1. a warp a row: d_w and draw
  const float* HL = H + static_cast<size_t>(n_layers - 1) * NC;
  for (int r = warp; r < kR; r += kThreads / 32) {
    float wr = 0.0f, dr = 0.0f;
    if (r < rows_live) {
      const size_t gr = static_cast<size_t>(r0) + r;
      const float* gF = g + (gr / K) * (C + 1);
      const float* hrow = HL + gr * C;
      float sg = 0.0f;
      for (int c = lane; c < C; c += 32) sg = fmaf(hrow[c], gF[c], sg);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sg += __shfl_xor_sync(0xffffffffu, sg, off);
      const float xa = Raw[gr] - 1.0f, gA = gF[C];
      wr = wgt[gr];
      dr = (gA * wr) / (1.0f + expf(-xa));
      if (lane == 0)
        dw[gr] = sg + (fmaxf(xa, 0.0f) + log1pf(expf(-fabsf(xa)))) * gA;
    }
    if (lane == 0) {
      w_s[r] = wr;
      draw_s[r] = dr;
    }
  }
  for (int c = tid; c < C; c += kThreads) wa_s[c] = wa[c];
  __syncthreads();

  // ---- 2. a thread a column: dh^{L-1} into A and DH, the tile's dwa
  for (int c = tid; c < C; c += kThreads) {
    const float wac = wa_s[c];
    float s = 0.0f;
    for (int r = 0; r < kR; r += 2) {
      float dh[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (r + e < rows_live) {
          const size_t gr = static_cast<size_t>(r0) + r + e;
          const float h = HL[gr * C + c];
          const float da =
              g[(gr / K) * (C + 1) + c] * w_s[r + e] + draw_s[r + e] * wac;
          dh[e] = h >= 0.0f ? da : 0.01f * da;
          DH[static_cast<size_t>(n_layers - 1) * NC + gr * C + c] = dh[e];
          s = fmaf(h, draw_s[r + e], s);
        }
      }
      if constexpr (BF16) {  // two rows of one column
        unsigned char* a = region + (c >> 3) * (kRows * 16) + (c & 7) * 2;
        *reinterpret_cast<__nv_bfloat16*>(a + r * 16) = __float2bfloat16_rn(dh[0]);
        *reinterpret_cast<__nv_bfloat16*>(a + (r + 1) * 16) = __float2bfloat16_rn(dh[1]);
      } else {
        Af[r * L.lda + c] = dh[0];
        Af[(r + 1) * L.lda + c] = dh[1];
      }
    }
    alpha_part[static_cast<size_t>(blockIdx.x) * (C + 1) + c] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int r = 0; r < kR; ++r) s += draw_s[r];
    alpha_part[static_cast<size_t>(blockIdx.x) * (C + 1) + C] = s;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the thread's sums: rows rw + 8 h, columns wg_col + 8 q + 2 t + e
  constexpr int kQ = BF16 ? kWgN / 8 : kWgN / 16;

  // ---- 3. hidden layers L-1 .. 1: da = dh^l W_l^T, dh^{l-1} in place
  for (int l = n_layers - 1; l >= 1; --l) {
    float acc[kAccs];
    ring_product<BF16>(acc, ring, C, region, L.lda, rw, wg_row, wg);
    const float* Hp = H + static_cast<size_t>(l - 1) * NC;
    float* Dp = DH + static_cast<size_t>(l - 1) * NC;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = wg_col + 8 * q + 2 * t;
      if (wg_col + 8 * q < C) {  // uniform across the warp (C % 32 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, i = 4 * q + 2 * h;
          const float d0 = BF16 ? acc[i] : acc[i] + acc[kAccs / 2 + i];
          const float d1 = BF16 ? acc[i + 1] : acc[i + 1] + acc[kAccs / 2 + i + 1];
          float e0 = 0.0f, e1 = 0.0f;
          if (r < rows_live) {
            const size_t o = static_cast<size_t>(r0 + r) * C + c;
            const float2 hp = *reinterpret_cast<const float2*>(Hp + o);
            e0 = hp.x >= 0.0f ? d0 : 0.01f * d0;
            e1 = hp.y >= 0.0f ? d1 : 0.01f * d1;
            *reinterpret_cast<float2*>(Dp + o) = make_float2(e0, e1);
          }
          putA2(r, c, e0, e1);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // ---- 4. dx = dh^0 W_0^T: the columns past 256 first, to their buffer,
  // then the first 256 to the staging over the dead A and ring
  if (two) {
    float acc2[16];
    ring_product<BF16>(acc2, ring, C, region, L.lda, rw, wg_row, wg);
    constexpr int kQ2 = BF16 ? 4 : 2;
    const int cb = BF16 ? 0 : wg * 16;
#pragma unroll
    for (int q = 0; q < kQ2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 8 * h, i = 4 * q + 2 * h;
        const float d0 = BF16 ? acc2[i] : acc2[i] + acc2[8 + i];
        const float d1 = BF16 ? acc2[i + 1] : acc2[i + 1] + acc2[8 + i + 1];
        *reinterpret_cast<float2*>(dx2 + r * kPass2 + cb + 8 * q + 2 * t) =
            make_float2(d0, d1);
      }
    }
  }
  {
    float acc[kAccs];
    ring_product<BF16>(acc, ring, C, region, L.lda, rw, wg_row, wg);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (wg_col + 8 * q < in0) {
        const int c = wg_col + 8 * q + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h, i = 4 * q + 2 * h;
          const float d0 = BF16 ? acc[i] : acc[i] + acc[kAccs / 2 + i];
          const float d1 = BF16 ? acc[i + 1] : acc[i + 1] + acc[kAccs / 2 + i + 1];
          *reinterpret_cast<float2*>(stg + r * kLdd + c) = make_float2(d0, d1);
        }
      }
    }
  }
  __syncthreads();

  // ---- 5. the PE chain rule: a thread a (row, channel)
  auto dxv = [&](int r, int j) {
    return j < kWgN ? stg[r * kLdd + j] : dx2[r * kPass2 + j - kWgN];
  };
  const int nch = F + Dd;
  for (int idx = tid; idx < rows_live * nch; idx += kThreads) {
    const int r = idx / nch, ch = idx - r * nch;
    const size_t gr = static_cast<size_t>(r0) + r;
    const float* xr = X + gr * ldx;
    const bool is_f = ch < F;
    const int nfr = is_f ? nf : df;
    const int j0 = is_f ? F + 2 * nf * ch : F + 2 * F * nf + 2 * df * (ch - F);
    float v = 0.0f;
    for (int f = 0; f < nfr; ++f) {
      const int j = j0 + 2 * f;
      const float dz = dxv(r, j) * xr[j + 1] - dxv(r, j + 1) * xr[j];
      v += dz * static_cast<float>(1 << f);
    }
    if (is_f)
      dfeat[gr * F + ch] = dxv(r, ch) + v;
    else
      ddist[gr * Dd + ch - F] = v;
  }
}

// ---- K3c: weight gradients, split-K on the FP32 cores
// 16 bytes global -> shared, zero-filled past `bytes` (0..16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Output tiles of product p (dW_p, nin_p x C) and of all L products.
__host__ __device__ inline int wgrad_tiles(int nin, int C) {
  return ((nin + kTI - 1) / kTI) * ((C + kTC - 1) / kTC);
}

// Floats of the slab partials: dW_0 (in0 x C) | dW_1.. (C x C) | db_0..
// (C each); [dwa | dba] come from K3b's tile partials.
__host__ __device__ inline size_t wgrad_floats(int n_layers, int in0, int C) {
  return static_cast<size_t>(in0) * C +
         static_cast<size_t>(n_layers - 1) * C * C +
         static_cast<size_t>(n_layers) * C;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
k3c_wgrad_kernel(const float* __restrict__ X, int ldx,
                 const float* __restrict__ H, const float* __restrict__ DH,
                 int n_layers, int N, int in0, int C,
                 float* __restrict__ partial) {
  __shared__ __align__(16) float xs[2][kKC][kTI];
  __shared__ __align__(16) float ds[2][kKC][kTC];
  // the block's product p and output tile (i0, c0)
  int tile = blockIdx.x, p = 0, nin = in0;
  while (tile >= wgrad_tiles(nin, C)) {
    tile -= wgrad_tiles(nin, C);
    ++p;
    nin = C;
  }
  const int nct = (C + kTC - 1) / kTC;
  const int i0 = (tile / nct) * kTI, c0 = (tile % nct) * kTC;
  const size_t NC = static_cast<size_t>(N) * C;
  const float* Xp = p == 0 ? X : H + static_cast<size_t>(p - 1) * NC;
  const int ldp = p == 0 ? ldx : C;
  const float* Dp = DH + static_cast<size_t>(p) * NC;
  const int rlo = blockIdx.y * kSlab, rhi = min(N, rlo + kSlab);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool sums = i0 == 0 && tid < kTC;  // db: column c0 + tid

  auto load = [&](int st, int rb) {  // rows rb .. rb + kKC - 1 into stage st
    for (int e = tid; e < kKC * (kTI / 4); e += kThreads) {
      const int kr = e / (kTI / 4), col = (e % (kTI / 4)) * 4;
      const int r = rb + kr;
      const bool live = r < rhi;
      const size_t row = static_cast<size_t>(live ? r : rlo);
      const int ic = i0 + col, cc = c0 + col;
      cp_async16(&xs[st][kr][col], Xp + row * ldp + (ic < nin ? ic : 0),
                 live && ic < nin ? 4 * min(4, nin - ic) : 0);
      cp_async16(&ds[st][kr][col], Dp + row * C + (cc < C ? cc : 0),
                 live && cc < C ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float colsum = 0.0f;
  const int nchunks = (rhi - rlo + kKC - 1) / kKC;
  load(0, rlo);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      load((k + 1) & 1, rlo + (k + 1) * kKC);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int st = k & 1;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      // the thread's rows ty*4.. and 64+ty*4.., columns tx*4.. and 64+tx*4..
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ds[st][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ds[st][kk][64 + tx * 4]);
      float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if (BF16) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] = round_bf16(a[i]);
          b[i] = round_bf16(b[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (sums)
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) colsum += ds[st][kk][tid];
    __syncthreads();  // the stage is read before the next load overwrites it
  }

  float* P = partial + static_cast<size_t>(blockIdx.y) * wgrad_floats(n_layers, in0, C);
  const size_t offW = p == 0 ? 0
                             : static_cast<size_t>(in0) * C +
                                   static_cast<size_t>(p - 1) * C * C;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int i = i0 + (ii < 4 ? ty * 4 + ii : 64 + ty * 4 + ii - 4);
    if (i < nin) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + half * 64 + tx * 4;
        if (c < C)  // C % 32 == 0: the 4 columns are all in
          *reinterpret_cast<float4*>(P + offW + static_cast<size_t>(i) * C + c) =
              make_float4(acc[ii][4 * half], acc[ii][4 * half + 1],
                          acc[ii][4 * half + 2], acc[ii][4 * half + 3]);
      }
    }
  }
  if (sums && c0 + tid < C)
    P[static_cast<size_t>(in0) * C + static_cast<size_t>(n_layers - 1) * C * C +
      static_cast<size_t>(p) * C + c0 + tid] = colsum;
}

// out[j] = the slab partials of j summed in slab order (j < Sw), then
// [dwa | dba] = K3b's tile partials summed in tile order.
__global__ void k3c_reduce_kernel(const float* __restrict__ partial,
                                  int n_slabs, size_t Sw,
                                  const float* __restrict__ alpha_part,
                                  int n_tiles, int C, float* __restrict__ out) {
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float s = 0.0f;
  if (j < Sw) {
    for (int p = 0; p < n_slabs; ++p) s += partial[static_cast<size_t>(p) * Sw + j];
  } else if (j < Sw + C + 1) {
    const size_t c = j - Sw;
    for (int p = 0; p < n_tiles; ++p)
      s += alpha_part[static_cast<size_t>(p) * (C + 1) + c];
  } else {
    return;
  }
  out[j] = s;
}

bool k3_args_ok(int N, int F, int nf, int Dd, int df, int C, int n_layers) {
  return !(N < 0 || C < 32 || C > kMaxC || C % 32 != 0 || n_layers < 1 ||
           F < 1 || nf < 1 || Dd < 1 || df < 1 || nf > 30 || df > 30 ||
           block1_in(F, nf, Dd, df) > kMaxIn);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t dgrad_smem_bytes(int C, bool bf16) {
  return kHeadBytes + dgrad_layout(C, bf16).bytes;
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3a. feat (N,F), dist (N,Dd) f32 (N = M*K rows); Wp, Bias, wa, ba as K2
// (`pack_block1` for this mode) -> x (N, ldx; ldx >= in0, % 4 == 0), h
// (n_layers, N, C), raw (N,) f32. Needs C % 32 == 0, 32 <= C <= 256,
// in0 <= 288. Launches on `stream`; returns cudaGetLastError().
int fused_agg_bwd_recompute(const float* feat, const float* dist,
                            const void* Wp, const float* Bias, int n_layers,
                            const float* wa, const float* ba, int N, int F,
                            int nf, int Dd, int df, int C, int bf16,
                            float* x, int ldx, float* h,
                            float* raw, cudaStream_t stream) {
  const int in0 = block1_in(F, nf, Dd, df);
  if (!k3_args_ok(N, F, nf, Dd, df, C, n_layers) || ldx < in0 || ldx % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = body_smem_bytes(F, nf, Dd, df, C, bf16 != 0);
  cudaError_t e = bf16 ? allow_smem(k3a_recompute_kernel<true>, smem)
                       : allow_smem(k3a_recompute_kernel<false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  SaveArgs save;
  save.x = x;
  save.ldx = ldx;
  save.h = h;
  save.h_layer = static_cast<size_t>(N) * C;
  save.raw = raw;
  const int rows = tile_rows(bf16 != 0);
  const int blocks = (N + rows - 1) / rows;
  auto kernel = bf16 ? k3a_recompute_kernel<true> : k3a_recompute_kernel<false>;
  kernel<<<blocks, kThreads, smem, stream>>>(feat, dist, Wp, Bias, n_layers,
                                             wa, ba, N, F, nf, Dd, df, C,
                                             save);
  return static_cast<int>(cudaGetLastError());
}

// K3b. x, h, raw from K3a; wgt (M,K) = (N,), g (M, C+1) f32 with K rows a
// point; WTp: W^T packed by `pack_block1_bwd` for this mode; wa (C,) ->
// dfeat (N,F), ddist (N,Dd), dw (N,), dh (n_layers, N, C) and alpha_part
// (ceil(N / tile rows), C+1). Launches on `stream`; returns
// cudaGetLastError().
int fused_agg_bwd_dgrad(const float* x, int ldx, const float* h,
                        const float* raw, const float* wgt, const float* g,
                        const void* WTp, const float* wa, int n_layers, int N,
                        int K, int F, int nf, int Dd, int df, int C, int bf16,
                        float* dfeat, float* ddist, float* dw, float* dh,
                        float* alpha_part, cudaStream_t stream) {
  if (!k3_args_ok(N, F, nf, Dd, df, C, n_layers) || K < 1 || ldx % 4 ||
      ldx < block1_in(F, nf, Dd, df))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t smem = dgrad_smem_bytes(C, bf16 != 0);
  cudaError_t e = bf16 ? allow_smem(k3b_dgrad_kernel<true>, smem)
                       : allow_smem(k3b_dgrad_kernel<false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = tile_rows(bf16 != 0);
  const int blocks = (N + rows - 1) / rows;
  auto kernel = bf16 ? k3b_dgrad_kernel<true> : k3b_dgrad_kernel<false>;
  kernel<<<blocks, kThreads, smem, stream>>>(
      x, ldx, h, raw, wgt, g, WTp, wa, n_layers, N, K, F, nf, Dd, df, C,
      dfeat, ddist, dw, dh, alpha_part);
  return static_cast<int>(cudaGetLastError());
}

// K3c. x, h (K3a), dh, alpha_part (K3b, n_tiles rows) -> out, the flat
// weight gradient: dW_0 (in0 x C) | dW_1.. (C x C) | db_0.. (C) | dwa (C)
// | dba. partial: scratch of ceil(N / 2048) x (out's floats - C - 1).
// Launches on `stream`; returns cudaGetLastError().
int fused_agg_bwd_wgrad(const float* x, int ldx, const float* h,
                        const float* dh, const float* alpha_part, int n_tiles,
                        int n_layers, int N, int in0, int C, int bf16,
                        float* partial, float* out, cudaStream_t stream) {
  if (N < 0 || C < 32 || C > kMaxC || C % 32 != 0 || n_layers < 1 ||
      in0 < 1 || in0 > kMaxIn || ldx < in0 || ldx % 4 || n_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slabs = (N + kSlab - 1) / kSlab;
  const size_t Sw = wgrad_floats(n_layers, in0, C);
  if (n_slabs > 0) {
    int tiles = wgrad_tiles(in0, C) + (n_layers - 1) * wgrad_tiles(C, C);
    const dim3 grid(tiles, n_slabs);
    if (bf16)
      k3c_wgrad_kernel<true><<<grid, kThreads, 0, stream>>>(
          x, ldx, h, dh, n_layers, N, in0, C, partial);
    else
      k3c_wgrad_kernel<false><<<grid, kThreads, 0, stream>>>(
          x, ldx, h, dh, n_layers, N, in0, C, partial);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t total = Sw + C + 1;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  k3c_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, n_slabs, Sw,
                                                alpha_part, n_tiles, C, out);
  return static_cast<int>(cudaGetLastError());
}

// K3's resources for the shapes F, nf, Dd, df, C in one mode, for K3a,
// K3b and K3c in turn: registers a thread, shared memory a block (bytes,
// dynamic + static) and resident blocks an SM.
int fused_agg_bwd_occupancy(int F, int nf, int Dd, int df, int C, int bf16,
                            int* regs, int* smem_bytes, int* blocks_per_sm) {
  const bool b = bf16 != 0;
  const void* fns[3] = {
      b ? reinterpret_cast<const void*>(k3a_recompute_kernel<true>)
        : reinterpret_cast<const void*>(k3a_recompute_kernel<false>),
      b ? reinterpret_cast<const void*>(k3b_dgrad_kernel<true>)
        : reinterpret_cast<const void*>(k3b_dgrad_kernel<false>),
      b ? reinterpret_cast<const void*>(k3c_wgrad_kernel<true>)
        : reinterpret_cast<const void*>(k3c_wgrad_kernel<false>)};
  const size_t dyn[3] = {body_smem_bytes(F, nf, Dd, df, C, b),
                         dgrad_smem_bytes(C, b), 0};
  for (int i = 0; i < 3; ++i) {
    if (dyn[i] > 0) {
      const cudaError_t e = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dyn[i]));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fns[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
    regs[i] = attr.numRegs;
    smem_bytes[i] = static_cast<int>(dyn[i] + attr.sharedSizeBytes);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm + i, fns[i],
                                                      kThreads, dyn[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
