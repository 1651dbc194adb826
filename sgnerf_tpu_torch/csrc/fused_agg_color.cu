// The colour head of K4 and K5: the colour MLP (K4), and the colour MLP
// with the volume march (K5), on the reduced rows K2 writes, for the opt-in
// render paths `--fused_color on` and `--fused_march on`.
//
// K4 replaces sgnerf_tpu/ops/fused_agg.py `fused_block1_alpha_color`
// (`_pallas_forward_color` -> `_kernel_color`); K5 replaces
// `fused_block1_alpha_color_march` (`_kernel_color_march`). Each is two
// launches (ops/fused_agg.py `_launch_color`): K2's kernel, unchanged,
// writes the (M, C+1) reduced rows [fa_m | alpha_m]; this kernel reads them.
// Function, per shading point m:
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
// bf16 mode rounds every colour-product input (the reduced features, the
// PE values, the hidden activations, the weights) to bf16 and accumulates
// in f32, as the reference's `_dot_mm`; f32 mode computes each product as
// 3xTF32 (hi.hi' in one accumulator, lo.hi' + hi.lo' in another, added in
// f32 at the end, as K2's body does).
//
// What bounds it on an H100: the colour products, 68,992 FMA a point at
// the canonical head ((C + 6 vf) x 128 + 2 x 128 x 128 + 128 x 3; 30.5
// GFLOP an eval chunk of 221,184 points): 0.031 ms on the bf16 tensor
// cores, 0.185 ms as three tf32 passes; then the (M, C+1) rows read back
// (227 MB, 0.07 ms at 3.35 TB/s) and the weights every tile streams from
// L2 (141 KB in bf16, 552 KB as tf32 hi/lo a tile of 128 points: 0.24 and
// 0.95 GB a chunk). The first port's head ran the layers as f32 FMA
// loops on the CUDA cores, 16 points at a time inside K2's block.
//
// Design:
// - A persistent grid walking tiles of 128 points (K4), or of whole rays
//   (K5: floor(128 / SR) rays; a ray longer than a tile is walked tile by
//   tile, in order, carrying T and its colour). Two warpgroups a block,
//   each on its own 64 rows; f32 heads wider than 128 (256 columns: two
//   sets of sums would not fit the registers) take 64-point tiles, the
//   warpgroups each on half the columns. bf16 heads to 128 wide keep two
//   blocks on an SM (128 registers a thread, half the shared memory each),
//   so that one block's fill runs under the other's products.
// - A, the tile's layer input, lives in shared memory: in bf16 as 8-column
//   chunks of 128 16-byte rows (wgmma's no-swizzle K-major core matrices),
//   read by descriptor; in f32 row-major, read as register fragments that
//   are split into tf32 hi/lo as they load. The fill writes x_m into A:
//   f32 copies K2's rows by cp.async, bf16 loads a batch of items a
//   thread before converting them; the PE is formed in the kernel; thread
//   0 has asked L2 for the next tile's rows while this one ran. Each layer
//   then runs wgmma m64n64 (hidden layers: the hidden width padded to 64
//   columns, chunks of 64; f32's three products a k-step interleaved over
//   the chunks) or m64n8 (the 3-logit layer, zero columns past 3); the
//   epilogue adds the bias, applies LeakyReLU (and bf16's rounding) from
//   the registers and writes the next layer's A in place.
// - The weights arrive packed by the wrapper (ops/fused_agg.py
//   `pack_color`): per layer, k-slices of 32 (bf16) or 8 (tf32 hi | lo)
//   input rows as 16-byte planes as wide as the layer's padded output.
//   Thread 0 streams the slices of every tile in turn through a ring of
//   shared-memory stages (as many as the block's memory holds) by 1-D TMA
//   bulk copies; the warpgroups hand stages back every second slice, and
//   the next tile's first slices load while this tile finishes.
// - K5's march is the epilogue: each point's opacity and colour in
//   parallel, then one thread a ray over its points in order (the
//   arithmetic of march_tail_plain's sequential product).
// - A check may ask for the hidden activations (`hid`): the plain head
//   holds the bf16 mode to them where the two f32 sums round a hidden
//   value apart (ops/fused_agg.py `color_tail_on_roundings`).
#include "fused_agg_body.cuh"

using namespace sgnerf_agg;

namespace {

// dev/probe_color_phases.py builds this source with -DSGNERF_COLOR_PHASES:
// thread 0 of each block then adds the clock64() cycles of each marked
// span to g_phase[k] (k: 0 a weight slice's wait, 1 the barrier that hands
// stages back, 2 a layer's epilogue, 3 a tile's fill, 4 its layers, 5 the
// fill's copy of K2's rows); otherwise the marks compile to nothing.
#ifdef SGNERF_COLOR_PHASES
__device__ unsigned long long g_phase[8];
#define PHASE_START(t) const long long t = clock64();
#define PHASE_ADD(k, t)   \
  if (threadIdx.x == 0) \
    atomicAdd(&g_phase[k], static_cast<unsigned long long>(clock64() - (t)));
#else
#define PHASE_START(t)
#define PHASE_ADD(k, t)
#endif

constexpr int kTile = 128;      // points a tile (64 when split)
constexpr int kMaxRing = 16;    // weight-slice stages, at most (a 128-B
                                // head of mbarriers)
constexpr size_t kSmemPerSm = 233472;  // shared memory an SM holds
constexpr int kLastN = 8;       // the 3-logit layer's padded width
constexpr int kMaxNh = 256;     // hidden width limit (wgmma's n)

// The head's shapes and shared-memory layout (ops/fused_agg.py
// `head_plan` states the same).
struct HeadPlan {
  int kp0;      // layer 0's depth (C + 6 vf) padded to the slice depth
  int Np;       // hidden width padded: a multiple of 64 (f32 split: 256)
  bool split;   // f32, Np > 128: 64-row tiles, a warpgroup per half
  int rows;     // points a tile
  int lda;      // f32 A's row stride, in floats
  int n_layers;
  int stages;   // the ring's: as many as shared memory holds, <= kMaxRing
  int blocks;   // resident blocks an SM: 2 for bf16 heads to 128 wide
  size_t a_off, ring_off, slice_max, total;
};

__host__ __device__ inline HeadPlan head_plan(int C, int vf, int Nh,
                                              int n_layers, bool bf16) {
  HeadPlan P;
  P.n_layers = n_layers;
  P.kp0 = round_up(C + 6 * vf, slice_depth(bf16));
  P.Np = n_layers > 1 ? round_up(Nh, 64) : 0;
  P.split = !bf16 && P.Np > 128;
  if (P.split) P.Np = kMaxNh;
  P.rows = P.split ? kTile / 2 : kTile;
  const int wa = P.kp0 > P.Np ? P.kp0 : P.Np;
  // a row stride of 4 (mod 32) words spreads 8 rows over 32 banks
  P.lda = round_up(wa, 32) + 4;
  const size_t a_bytes = bf16 ? static_cast<size_t>(wa / 8) * kTile * 16
                              : static_cast<size_t>(P.rows) * P.lda * 4;
  // [the ring's mbarriers | pts: kTile x 4 floats | A | ring]
  P.a_off = 128 + kTile * 4 * sizeof(float);
  P.ring_off = P.a_off + (a_bytes + 127) / 128 * 128;
  P.slice_max = 64 * static_cast<size_t>(P.Np > kLastN ? P.Np : kLastN);
  // bf16 heads to 128 columns take two blocks an SM (their sums fit 128
  // registers a thread): one block's fill runs under the other's products
  P.blocks = bf16 && P.Np <= 128 ? 2 : 1;
  const size_t budget = P.blocks == 2 ? kSmemPerSm / 2 - 1024 : kMaxSmem;
  const size_t room = P.ring_off < budget ? budget - P.ring_off : 0;
  const size_t fit = room / P.slice_max;
  P.stages = static_cast<int>(fit < kMaxRing ? fit : kMaxRing);
  // fewer than 2 stages: no block fits (head_smem reports 0)
  P.total = P.ring_off + (P.stages < 2 ? 2 : P.stages) * P.slice_max;
  return P;
}

// d (64 x 64, f32, this thread's 32 values) += A (64 x 16) . B (16 x 64),
// bf16, both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 8) += A (64 x 16) . B (16 x 8), bf16 from shared memory.
__device__ __forceinline__ void wgmma_bf16_n8(float (&d)[4], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 8) . B (8 x 64), tf32, A from registers (this
// warp's fragment of rows 16 w ..), B from shared memory.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 8) += A (64 x 8) . B (8 x 8), tf32, A from registers.
__device__ __forceinline__ void wgmma_tf32_n8(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int R, int N>
__device__ __forceinline__ void wait_all(float (&acc)[R][N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i)  // no read of a sum before the wait
      asm volatile("" : "+f"(acc[j][i])::"memory");
}

// The weight stream: every tile's slices in turn, layer by layer, through
// the ring's shared-memory stages. Thread 0 issues; every thread waits.
struct Ring {
  uint64_t* bars;
  int stages;
  unsigned char* ring;
  size_t slice_max;
  const unsigned char* W;
  int total;   // slices this block consumes in all
  int issued;  // slices given to the ring (thread 0)
  int pl, ps;  // the next slice to issue: layer, slice in the layer
  size_t poff; // and its byte offset in W
  int L, kp0, Np, ks;

  __device__ int depth(int l) const { return l == 0 ? kp0 : Np; }
  __device__ int width(int l) const { return l == L - 1 ? kLastN : Np; }

  // slices < done are consumed: their stages take the next ones
  __device__ void refill(int done) {
    if (threadIdx.x != 0) return;
    for (; issued < total && issued < done + stages; ++issued) {
      const int stage = issued % stages;
      const uint32_t bytes = 64u * width(pl);
      bulk_load(smem_addr(ring + stage * slice_max), W + poff, bytes,
                smem_addr(bars + stage));
      poff += bytes;
      if (++ps == depth(pl) / ks) {
        ps = 0;
        if (++pl == L) pl = 0, poff = 0;
      }
    }
  }

  __device__ uint32_t wait(int it) const {
    const int stage = it % stages;
    bar_wait(smem_addr(bars + stage), (it / stages) & 1);
    return smem_addr(ring + stage * slice_max);
  }
};

// Where a check asks for the hidden activations (ops/fused_agg.py
// `color_head_hidden`): layer l's value of point q, column c at
// hid[(l * M + q) * Np + c], as the next layer multiplies it (bf16 mode:
// rounded); the points q0 .. q0+n-1 of this tile. hid null: none.
struct Save {
  float* hid;
  size_t q0;
  int n, M;
};

// Where this thread's sums sit: thread (warp, g, t) of warpgroup wg holds
// sum 4 q + 2 h + e of a 64-column chunk = row rw + 8 h, column
// col0 + 8 q + 2 t + e of that chunk.
struct Lanes {
  int wg, t, rw, wg_row, wg_col;
};

// f32: A's fragment of k-step s (rows rw, rw + 8; columns 8 s + t, + 4) as
// tf32 hi and lo.
__device__ __forceinline__ void load_frag(const float* Af, int lda, int rw,
                                          int s, int t, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float* p = Af + rw * lda + s * 8 + t;
  const float v[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// One layer on the tile in A: NC chunks of 64 output columns a warpgroup
// (NC = 0: the 3-logit layer on 8 columns, into pts[r * 4 + 1 + c]).
// Hidden layers write LeakyReLU(x W + b) (bf16: rounded) back into A.
// Every thread calls it; it returns with the block synchronised.
template <bool BF16, int NC>
__device__ __forceinline__ void layer(Ring& R, int& it, int l,
                                      unsigned char* A, const HeadPlan& P,
                                      const float* __restrict__ bias,
                                      const Lanes& ln, float* pts,
                                      const Save& sv) {
  constexpr bool kLast = NC == 0;
  constexpr int kN = kLast ? 4 : 32;      // sums a chunk
  constexpr int kC = kLast ? 1 : NC;      // chunks
  constexpr int kSets = BF16 ? kC : 2 * kC;  // f32: big sums, then small
  const int ns = R.depth(l) / R.ks;
  const int W = R.width(l);                // the slice's columns
  // split: warpgroup 1 has no columns of the 3-logit layer; it multiplies
  // warpgroup 0's (no branch around the wgmmas, which would serialise
  // them) and writes nothing
  const bool on = !kLast || !P.split || ln.wg == 0;
  const int col0 = kLast ? 0 : ln.wg_col;
  const float* Af = reinterpret_cast<const float*>(A);
  float acc[kSets][kN];
#pragma unroll
  for (int j = 0; j < kSets; ++j)
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[j][i] = 0.0f;
  uint32_t ah[2][4], al[2][4];
  if constexpr (!BF16) load_frag(Af, P.lda, ln.rw, 0, ln.t, ah[0], al[0]);
  auto step = [&](int s, auto set) {
    constexpr int B = decltype(set)::value;
    static_cast<void>(B);  // read by f32's fragments only
    PHASE_START(t_wait)
    const uint32_t slice = R.wait(it);
    PHASE_ADD(0, t_wait)
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int kc = (s * 32 + 16 * kk) >> 3;  // A's 8-column chunk
        const uint64_t da = wgmma_desc(
            smem_addr(A) + kc * (kTile * 16) + ln.wg_row * 16, kTile * 16,
            128);
        const uint32_t b = slice + 2 * kk * (W * 16);
        if constexpr (kLast) {
          wgmma_bf16_n8(acc[0], da, wgmma_desc(b, W * 16, 128));
        } else {
#pragma unroll
          for (int j = 0; j < kC; ++j)
            wgmma_bf16_n64(acc[j], da,
                           wgmma_desc(b + (col0 + 64 * j) * 16, W * 16,
                                      128));
        }
      }
    } else if constexpr (kLast) {
      const uint64_t bh = wgmma_desc(slice, W * 16, 128);
      const uint64_t blo = wgmma_desc(slice + 2 * W * 16, W * 16, 128);
      wgmma_tf32_n8(acc[1], al[B], bh);  // small products
      wgmma_tf32_n8(acc[1], ah[B], blo);
      wgmma_tf32_n8(acc[0], ah[B], bh);  // big products
    } else {
      // a chunk's sums as lo.hi' + hi.lo' (small) and hi.hi' (big), the
      // chunks interleaved: no two products in a row on one sum
      uint64_t bh[kC], blo[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const uint32_t b = slice + (col0 + 64 * j) * 16;
        bh[j] = wgmma_desc(b, W * 16, 128);
        blo[j] = wgmma_desc(b + 2 * W * 16, W * 16, 128);
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) wgmma_tf32_n64(acc[kC + j], al[B], bh[j]);
#pragma unroll
      for (int j = 0; j < kC; ++j) wgmma_tf32_n64(acc[j], ah[B], bh[j]);
#pragma unroll
      for (int j = 0; j < kC; ++j) wgmma_tf32_n64(acc[kC + j], ah[B], blo[j]);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the previous k-step's products are done: its register set takes the
    // next k-step's fragment (after the last, the last again: no branch
    // near the wgmmas)
    if constexpr (!BF16)
      load_frag(Af, P.lda, ln.rw, min(s + 1, ns - 1), ln.t, ah[1 - B],
                al[1 - B]);
    // every second slice, both warpgroups are done with the slices before
    // this one: their stages refill
    if (B == 1) {
      PHASE_START(t_sync)
      __syncthreads();
      R.refill(it);
      PHASE_ADD(1, t_sync)
    }
    ++it;
  };
  for (int s = 0; s < ns; s += 2) {
    step(s, std::integral_constant<int, 0>());
    if (s + 1 < ns) step(s + 1, std::integral_constant<int, 1>());
  }
  PHASE_START(t_epilogue)
  wait_all(acc);
  __syncthreads();  // every product has read A: the epilogue overwrites it
  R.refill(it);
  if (on) {
#pragma unroll
    for (int j = 0; j < kC; ++j) {
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const int c = col0 + 64 * j + 8 * q + 2 * ln.t;
        const float2 bb = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ln.rw + 8 * h;
          const int i = 4 * q + 2 * h;
          float v0 = acc[j][i], v1 = acc[j][i + 1];
          if constexpr (!BF16) {
            v0 += acc[kC + j][i];
            v1 += acc[kC + j][i + 1];
          }
          v0 += bb.x;
          v1 += bb.y;
          if constexpr (kLast) {
            if (c < 3) pts[r * 4 + 1 + c] = v0;
            if (c + 1 < 3) pts[r * 4 + 2 + c] = v1;
          } else {
            float2 h = make_float2(leaky(v0), leaky(v1));
            if constexpr (BF16) {
              const __nv_bfloat162 hb = __floats2bfloat162_rn(h.x, h.y);
              *reinterpret_cast<__nv_bfloat162*>(
                  A + (c >> 3) * (kTile * 16) + r * 16 + (c & 7) * 2) = hb;
              h = __bfloat1622float2(hb);
            } else {
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(A) +
                                         r * P.lda + c) = h;
            }
            if (sv.hid != nullptr && r < sv.n)
              *reinterpret_cast<float2*>(
                  sv.hid + (static_cast<size_t>(l) * sv.M + sv.q0 + r) *
                               P.Np + c) = h;
          }
        }
      }
    }
  }
  // A's generic writes before the tensor cores read it (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  PHASE_ADD(2, t_epilogue)
}

// Asks L2 for the bytes [p, p + bytes) of an array of `total` bytes from
// `base` (one TMA bulk prefetch; the range widened to 16-byte bounds
// within the array). Thread 0 calls it.
__device__ __forceinline__ void prefetch_l2(const void* base, size_t total,
                                            const void* p, size_t bytes) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  const uintptr_t end = (b + total) & ~static_cast<uintptr_t>(15);
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  uintptr_t hi = (a + bytes + 15) & ~static_cast<uintptr_t>(15);
  if (hi > end) hi = end;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo),
                 "r"(static_cast<uint32_t>(hi - lo))
                 : "memory");
}

// x = [fa | PE(vd) | 0] of the n points from q0 into A, and their alpha
// into pts[r * 4].
template <bool BF16>
__device__ __forceinline__ void fill_tile(const float* __restrict__ red,
                                          const float* __restrict__ vd,
                                          size_t q0, int n, int C, int vf,
                                          const HeadPlan& P, unsigned char* A,
                                          float* pts) {
  PHASE_START(t_rows)
  const int ldr = C + 1;
  if constexpr (!BF16) {
    // f32: K2's rows straight into A, 4 bytes a copy (the rows of C + 1
    // floats are 4-byte aligned), a warp a row, all in flight while the
    // PE is formed
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < n; r += kThreads / 32) {
      const float* src = red + (q0 + r) * ldr;
      float* dst = reinterpret_cast<float*>(A) + r * P.lda;
      for (int j = lane; j < C; j += 32) cp_async4(dst + j, src + j);
    }
  } else {
    // bf16: 8 columns an item, rows fastest (16-byte shared stores in
    // turn); a thread's loads of kBatch items issued before their stores
    constexpr int kBatch = 4;
    const int nch = C / 8, items = P.rows * nch;
    for (int i0 = threadIdx.x; i0 < items; i0 += kBatch * kThreads) {
      float v[kBatch][8];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = i0 + b * kThreads;
        const int r = idx % P.rows, ch = idx / P.rows;
        const float* src = red + (q0 + r) * ldr + 8 * ch;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[b][i] = idx < items && r < n ? src[i] : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = i0 + b * kThreads;
        const int r = idx % P.rows, ch = idx / P.rows;
        if (idx >= items || r >= n) continue;
        __nv_bfloat162 h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = __floats2bfloat162_rn(v[b][2 * i], v[b][2 * i + 1]);
        *reinterpret_cast<uint4*>(A + ch * (kTile * 16) + r * 16) =
            *reinterpret_cast<const uint4*>(h);
      }
    }
  }
  PHASE_ADD(5, t_rows)
  // the view directions' PE, then zero columns to the slice depth: a
  // thread keeps one row's direction and walks its columns (P.rows, a
  // power of 2, divides kThreads); sinf and cosf as the plain PE's
  {
    const int r = threadIdx.x & (P.rows - 1);
    const int npe = P.kp0 - C, step = kThreads / P.rows;
    if (r < n) {
      const float d[3] = {vd[(q0 + r) * 3], vd[(q0 + r) * 3 + 1],
                          vd[(q0 + r) * 3 + 2]};
      for (int q = threadIdx.x / P.rows; q < npe; q += step) {
        float v = 0.0f;
        if (q < 6 * vf) {
          const int cf = q < 3 * vf ? q : q - 3 * vf;
          const int c = cf / vf;
          const float a = d[c] * static_cast<float>(1 << (cf - c * vf));
          v = q < 3 * vf ? sinf(a) : cosf(a);
        }
        const int j = C + q;
        if (BF16)
          *reinterpret_cast<__nv_bfloat16*>(A + (j >> 3) * (kTile * 16) +
                                            r * 16 + (j & 7) * 2) =
              __float2bfloat16_rn(v);
        else
          reinterpret_cast<float*>(A)[r * P.lda + j] = v;
      }
    }
  }
  for (int r = threadIdx.x; r < n; r += kThreads)
    pts[r * 4] = red[(q0 + r) * ldr + C];
  if constexpr (!BF16) asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// K4 (SR = 0) or K5 on the reduced rows red (M, C+1). Work items: a tile
// of P.rows points (K4), or rays_per_item whole rays walked in sub-tiles
// of at most P.rows points (K5).
template <bool BF16, int NC>
__global__ void __launch_bounds__(kThreads, BF16 && NC <= 2 ? 2 : 1)
color_head_kernel(const float* __restrict__ red, const float* __restrict__ vd,
                  const void* __restrict__ Wp, const float* __restrict__ Bp,
                  int n_layers, int Nh, int M, int C, int vf,
                  const float* __restrict__ ray_dist,
                  const float* __restrict__ ray_valid, int SR,
                  float* __restrict__ out, float* __restrict__ hid) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadPlan P = head_plan(C, vf, Nh, n_layers, BF16);
  float* pts = reinterpret_cast<float*>(smem + 128);  // rows x [alpha | 3]
  unsigned char* A = smem + P.a_off;
  const int tid = threadIdx.x, warp = tid >> 5;
  Lanes ln;
  ln.wg = warp >> 2;
  ln.t = tid & 3;
  ln.wg_row = P.split ? 0 : 64 * ln.wg;
  ln.wg_col = P.split ? ln.wg * (P.Np / 2) : 0;
  ln.rw = ln.wg_row + 16 * (warp & 3) + ((tid & 31) >> 2);

  // the block's items
  const int n_rays = SR > 0 ? M / SR : 0;
  int n_items, rays_per_item = 0, subs = 1;
  if (SR == 0) {
    n_items = (M + P.rows - 1) / P.rows;
  } else if (SR <= P.rows) {
    rays_per_item = P.rows / SR;
    n_items = (n_rays + rays_per_item - 1) / rays_per_item;
  } else {
    rays_per_item = 1;
    n_items = n_rays;
    subs = (SR + P.rows - 1) / P.rows;
  }
  const int my_items =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  int per_tile = P.kp0;  // the slices of one tile
  for (int l = 1; l < n_layers; ++l) per_tile += P.Np;
  per_tile /= slice_depth(BF16);

  Ring R;
  R.bars = reinterpret_cast<uint64_t*>(smem);
  R.stages = P.stages;
  R.ring = smem + P.ring_off;
  R.slice_max = P.slice_max;
  R.W = static_cast<const unsigned char*>(Wp);
  R.total = my_items * subs * per_tile;
  R.issued = R.pl = R.ps = 0;
  R.poff = 0;
  R.L = n_layers;
  R.kp0 = P.kp0;
  R.Np = P.Np;
  R.ks = slice_depth(BF16);
  if (tid == 0) {
    for (int s = 0; s < P.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(R.bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  R.refill(0);

  // item -> its first point, points and rays
  auto points = [&](int item, size_t& p0, int& npts, int& nrays) {
    if (SR == 0) {
      p0 = static_cast<size_t>(item) * P.rows;
      npts = min(P.rows, M - static_cast<int>(p0));
      nrays = 0;
    } else {
      const int r0 = item * rays_per_item;
      nrays = min(rays_per_item, n_rays - r0);
      p0 = static_cast<size_t>(r0) * SR;
      npts = nrays * SR;
    }
  };
  // thread 0: the next tile's rows (and view directions, distances) into
  // L2 while this tile runs, so that its fill reads from L2
  auto prefetch = [&](size_t q0, int n) {
    const size_t ldr = static_cast<size_t>(C) + 1;
    prefetch_l2(red, M * ldr * 4, red + q0 * ldr, n * ldr * 4);
    prefetch_l2(vd, static_cast<size_t>(M) * 12, vd + q0 * 3, n * 12);
    if (SR > 0) {
      prefetch_l2(ray_dist, static_cast<size_t>(M) * 4, ray_dist + q0, n * 4);
      prefetch_l2(ray_valid, static_cast<size_t>(M) * 4, ray_valid + q0,
                  n * 4);
    }
  };
  if (tid == 0 && my_items > 0) {
    size_t p0;
    int npts, nrays;
    points(blockIdx.x, p0, npts, nrays);
    prefetch(p0, min(P.rows, npts));
  }

  int it = 0;  // slices consumed
  for (int k = 0; k < my_items; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    size_t p0;
    int npts, nrays;
    points(item, p0, npts, nrays);
    // K5: thread i carries ray i's transmission and colour
    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int st = 0; st < npts; st += P.rows) {
      const int n = min(P.rows, npts - st);
      const size_t q0 = p0 + st;
      if (tid == 0) {  // the tile after this one
        if (st + P.rows < npts) {
          prefetch(q0 + P.rows, min(P.rows, npts - st - P.rows));
        } else if (k + 1 < my_items) {
          size_t p1;
          int n1, r1;
          points(item + gridDim.x, p1, n1, r1);
          prefetch(p1, min(P.rows, n1));
        }
      }
      PHASE_START(t_fill)
      fill_tile<BF16>(red, vd, q0, n, C, vf, P, A, pts);
      PHASE_ADD(3, t_fill)
      PHASE_START(t_layers)
      const Save sv = {hid, q0, n, M};
      const float* bias = Bp;
      for (int l = 0; l < n_layers; ++l) {
        if (l == n_layers - 1) {
          layer<BF16, 0>(R, it, l, A, P, bias, ln, pts, sv);
        } else {
          layer<BF16, NC>(R, it, l, A, P, bias, ln, pts, sv);
          bias += P.Np;
        }
      }
      PHASE_ADD(4, t_layers)
      if (SR == 0) {
        for (int idx = tid; idx < n * 4; idx += kThreads)
          out[q0 * 4 + idx] = pts[idx];
        __syncthreads();  // pts is read before the next tile writes it
        continue;
      }
      // each point's opacity and raw2out_color with act_super in parallel,
      // then the march of each ray's points in this sub-tile, in order
      for (int idx = tid; idx < n * 4; idx += kThreads) {
        const int r = idx >> 2, c = idx & 3;
        const float v = pts[idx];
        if (c == 0) {
          const float sigma = v * ray_valid[q0 + r];
          pts[idx] = 1.0f - expf(-sigma * ray_dist[q0 + r]);
        } else {
          pts[idx] = 1.0f / (1.0f + expf(-v)) * 1.002f - 0.001f;
        }
      }
      __syncthreads();
      if (tid < nrays) {
        const int a = max(tid * SR, st), b = min((tid + 1) * SR, st + n);
        for (int s = a; s < b; ++s) {
          const float* pt = pts + (s - st) * 4;
          const float op = pt[0];
          const float ws = op * T;
          c0 += ws * pt[1];
          c1 += ws * pt[2];
          c2 += ws * pt[3];
          T = T * (1.0f - op + 1e-10f);
        }
      }
      __syncthreads();
    }
    if (SR > 0 && tid < nrays) {
      float* o = out + (p0 / SR + tid) * 4;
      o[0] = c0;
      o[1] = c1;
      o[2] = c2;
      o[3] = T;
    }
  }
}

bool head_args_ok(int C, int vf, int n_layers, int Nh) {
  return !(C < 32 || C > kMaxC || C % 32 != 0 || vf < 1 || vf > 30 ||
           n_layers < 1 || (n_layers > 1 && (Nh < 3 || Nh > kMaxNh)));
}

// Bytes of shared memory of a block, or 0 when the head does not fit one.
size_t head_smem(int C, int vf, int n_layers, int Nh, bool bf16) {
  if (!head_args_ok(C, vf, n_layers, Nh)) return 0;
  const HeadPlan P = head_plan(C, vf, Nh, n_layers, bf16);
  return P.stages < 2 || P.total > kMaxSmem ? 0 : P.total;
}

// The kernel for this mode and hidden width (chunks of 64 columns a
// warpgroup), its shared memory allowed.
template <bool BF16>
const void* pick_kernel(const HeadPlan& P) {
  const int nc = P.n_layers > 1 ? (P.split ? P.Np / 2 : P.Np) / 64 : 1;
  const void* fn = nullptr;
  if (BF16) {
    switch (nc) {
      case 1: fn = reinterpret_cast<const void*>(color_head_kernel<true, 1>); break;
      case 2: fn = reinterpret_cast<const void*>(color_head_kernel<true, 2>); break;
      case 3: fn = reinterpret_cast<const void*>(color_head_kernel<true, 3>); break;
      case 4: fn = reinterpret_cast<const void*>(color_head_kernel<true, 4>); break;
    }
  } else {
    switch (nc) {
      case 1: fn = reinterpret_cast<const void*>(color_head_kernel<false, 1>); break;
      case 2: fn = reinterpret_cast<const void*>(color_head_kernel<false, 2>); break;
    }
  }
  if (fn != nullptr &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(P.total)) != cudaSuccess)
    return nullptr;
  return fn;
}

}  // namespace

extern "C" {

const char* sgnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef SGNERF_COLOR_PHASES
// The phase clocks' sums since the last call into out[8], then zeroed.
int color_phases_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

// The colour head of K4 (SR = 0) or K5 (SR >= 1) on red (M, C+1) f32, K2's
// reduced rows [fa | alpha]; vd (M, 3) f32; Wp, Bp: the colour weights and
// biases as ops/fused_agg.py `pack_color` packs them for this mode
// (n_layers layers, hidden width Nh); K5 also ray_dist (M,), ray_valid
// (M,) f32 with M = n_rays * SR, each ray's SR points consecutive.
// -> out (M, 4) [alpha | raw rgb] (K4) or (M/SR, 4) [ray colour |
// background transmission] (K5), f32; hid, where not null, (n_layers - 1,
// M, Np) f32 takes the hidden activations (Np: `head_plan`'s padded
// width; for checks). Launches on `stream`; returns cudaGetLastError().
int fused_color_head(const float* red, const float* vd, const void* Wp,
                     const float* Bp, int n_layers, int Nh, int M, int C,
                     int vf, const float* ray_dist, const float* ray_valid,
                     int SR, int bf16, float* out, float* hid,
                     cudaStream_t stream) {
  if (head_smem(C, vf, n_layers, Nh, bf16 != 0) == 0 || M < 0 || SR < 0 ||
      (SR > 0 && M % SR != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const HeadPlan P = head_plan(C, vf, Nh, n_layers, bf16 != 0);
  const void* fn = bf16 ? pick_kernel<true>(P) : pick_kernel<false>(P);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int items;
  if (SR == 0)
    items = (M + P.rows - 1) / P.rows;
  else if (SR <= P.rows)
    items = (M / SR + P.rows / SR - 1) / (P.rows / SR);
  else
    items = M / SR;
  const int grid = items < sms * P.blocks ? items : sms * P.blocks;
  void* args[] = {&red, &vd, &Wp, &Bp, &n_layers, &Nh, &M, &C, &vf,
                  &ray_dist, &ray_valid, &SR, &out, &hid};
  e = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, P.total, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a K4 (SR = 0) or K5 colour-head block
// takes, or 0 when K2's block or the head's does not fit (ops/fused_agg.py
// k4_supports). Host arithmetic only.
int fused_block1_alpha_color_smem(int K, int F, int nf, int Dd, int df,
                                  int C, int vf, int n_clayers, int Nh,
                                  int SR, int bf16) {
  if (K < 1 || K > 64 || F < 1 || Dd < 1 || nf < 1 || nf > 30 || df < 1 ||
      df > 30 || SR < 0 ||
      k2_smem_bytes(F, nf, Dd, df, C, bf16 != 0) > kMaxSmem)
    return 0;
  return static_cast<int>(head_smem(C, vf, n_clayers, Nh, bf16 != 0));
}

// Bytes of dynamic shared memory of a colour-head block, or 0 when the
// head does not fit one (ops/fused_agg.py fused_color_head). Host
// arithmetic only.
int fused_color_head_smem(int C, int vf, int n_layers, int Nh, int bf16) {
  return static_cast<int>(head_smem(C, vf, n_layers, Nh, bf16 != 0));
}

// The colour head's registers a thread, dynamic shared memory a block
// (bytes) and resident blocks an SM.
int fused_color_head_occupancy(int C, int vf, int n_layers, int Nh, int bf16,
                               int* regs, int* smem_bytes,
                               int* blocks_per_sm) {
  if (head_smem(C, vf, n_layers, Nh, bf16 != 0) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const HeadPlan P = head_plan(C, vf, Nh, n_layers, bf16 != 0);
  const void* fn = bf16 ? pick_kernel<true>(P) : pick_kernel<false>(P);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *smem_bytes = static_cast<int>(P.total);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                    kThreads, P.total);
  return static_cast<int>(e);
}

}  // extern "C"
