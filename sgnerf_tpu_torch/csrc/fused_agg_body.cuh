// The fused aggregator's tile body — PE -> block1 -> per-neighbour alpha ->
// weighted K-reduction over a tile of neighbour rows — shared by K2
// (fused_agg.cu; K4/K5 run the colour head, and the volume march, on the
// reduced rows it leaves behind) and by K3's recompute. K2's tile is a
// tile of its plan: the live rows (w != 0) of whole shading points, read
// through the plan's row list, each point's rows summed in k order; K3a's
// is consecutive rows.
//
// Function, per neighbour row r (K rows per shading point):
//   x_r   = [feat | PE(feat, nf) | PE(d, df)] in the reference's interleaved
//           layout (ops/pe.py: frequency innermost per channel, sin/cos
//           interleaved), against the unpermuted block1 weights;
//   h_r   = LeakyReLU_0.01(... LeakyReLU_0.01(x_r W0 + b0) ... W_{n-1} + b_{n-1});
//   a_r   = softplus(h_r . wa + ba - 1);
//   out_m = sum_k w_{mK+k} [h_{mK+k} | a_{mK+k}]            -> (C+1) floats.
// bf16 mode rounds every product input (the PE values, the hidden
// activations that feed a further layer, the weights) to bf16 with
// round-to-nearest-even and sums in f32, as the reference's `_dot_mm`; the
// last layer's h, the alpha head and the K-reduction stay f32. f32 mode
// computes every product as 3xTF32: a = hi + lo with hi = tf32_rna(a),
// lo = tf32_rna(a - hi), and a.b ~ hi.hi' + (lo.hi' + hi.lo'), the big
// products and the two small ones summed in separate accumulators and
// added in f32 at the end. The tensor cores round each accumulation
// toward zero: three accumulations a k-step into one sum put K2's f32 mode
// 4.6e-5 from IEEE f32 on features of magnitude 13 (alpha 3.2e-6), past
// tests/test_fused_agg.py's 3e-5 (3e-6); one a k-step in the big sum reads
// 1.6e-5 (9.5e-7) there (NVIDIA H100 80GB HBM3, 700 W). The PE was not
// the cause there (one sincosf a frequency read the same as the
// double-angle recurrence).
// K3's recompute (SAVE) is this body, the same products, PE and epilogue
// in the same order, so the activations it saves, and the LeakyReLU
// branches the backward reads from them, are the forward's bit for bit.
//
// What bounds it on an H100: the products. A canonical row costs
// (284 + 256) x 256 MACs against ~200 bytes of input; a 9216-ray eval
// chunk shaded in full is 4.9e11 FLOP, 0.50 ms on the bf16 tensor cores
// (989 TFLOP/s; f32 mode: three tf32 passes at 495 TFLOP/s, 3.0 ms) and
// 0.14 ms of HBM traffic; K2 shades only its live rows (18-28% of an eval
// chunk's slots, in tiles 89% full in f32, 94.5% in bf16). Why the bits
// do not move when a row changes tile or place: each wgmma output row is
// a function of its own A row (PE, products, bias, LeakyReLU, the alpha
// dot's fixed shuffle tree are all per row), and the K-sum adds a point's
// rows in k order from +0, where a dead slot would have added +-0.
// Second, L2: every tile streams all the packed weights (278 KB in bf16,
// twice that as tf32 hi/lo), so bf16's 128-row tiles read 3.8 GB per fully
// live eval chunk from L2, half what 64-row tiles would (f32 mode takes
// 64-row tiles for its accuracy: 15 GB). Third, the CUDA-core work around
// the products (PE, epilogues, K-sum), which does not overlap them within
// a block.
//
// Design:
// - 256 threads = two warpgroups by Hopper's wgmma (C < 256 multiplies
//   zero weight columns), the sums in registers (128 a thread). bf16:
//   128-row tiles, each warpgroup 64 rows x 256 columns, wgmma m64n256k16
//   with A and B read from shared memory through no-swizzle K-major
//   descriptors. f32: 64-row tiles, each warpgroup all 64 rows x 128 of
//   the columns, wgmma m64n128k8 tf32 three times a k-step into the two
//   accumulators (64 sums each), A from registers (split into tf32 hi/lo
//   as it loads), B's hi and lo planes from shared memory.
// - A, the PE rows and then each hidden layer, lives in shared memory: in
//   bf16 as 8-column chunks of 128 16-byte rows (wgmma's core matrices);
//   in f32 row-major, rows padded so that fragment loads hit 32 banks.
// - The weights arrive packed by the wrapper (ops/fused_agg.py
//   `pack_block1`): per layer, k-slices of 32 (bf16) or 8 (tf32 hi | lo)
//   input rows as 16-byte planes of 256 columns, so a slice is one
//   contiguous 16 KB copy. Slices stream through a ring of shared-memory
//   stages by 1-D TMA bulk copies (cp.async.bulk + mbarrier); thread 0
//   refills a stage once both warpgroups are done with it. The first
//   slices load while the block stages its raw rows (cp.async) and
//   computes their PE rows. A slice's wgmmas are issued before the
//   previous slice's are waited for (f32 alternates two register sets for
//   A's fragments, each loaded once the products that read it before are
//   done, a slice ahead; f32 hands a stage back every second slice).
// - The epilogue adds the bias (staged in shared memory with wa) and
//   applies LeakyReLU from the registers, rounds to bf16 where a further
//   layer follows, and writes the next A in place. The last layer forms
//   the alpha head's dot from the registers (a fixed shuffle tree) and
//   writes f32 h_r w_r to a staging area over the dead A and ring; the
//   K-sum (each point's rows in k order, a point's row of dst written when
//   its last row is added) reads the staging, so reruns give the same bits.
// - K2's rows arrive through its plan (TileRows): the tile's global rows
//   are staged in a map of kRows + 1 ints past the body's shared memory
//   (each thread reads its own row's w), read by the raw rows' copies
//   (issued four at a time, their rows read first), then turned into each
//   row's point for the K-sum, which walks the rows 8 at a time, their
//   values loaded ahead of the adds, and writes a point's row at its last
//   row, read from a bit a row that warp ballots set as the rows arrive:
//   a point's id is read once, not a row's. (Reading each row's point
//   doubled the tail at full fill; listing the tile's points by ballots
//   and walking them cut that tail but cost 3-4% of K2 at an eval chunk's
//   27%: more points, fewer rows.)
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace sgnerf_agg {

constexpr int kRows = 128;     // neighbour rows per tile, at most
constexpr int kThreads = 256;  // two warpgroups
constexpr int kMinBlocks = 1;  // resident blocks an SM (__launch_bounds__)
constexpr int kWgN = 256;      // the packed weights' columns (C < 256: zero
                               // weight columns past C)
constexpr int kAccs = kWgN / 2;  // f32 sums a thread keeps
static_assert(kRows == 64 * (kThreads / 128), "a warpgroup per 64 rows");

// Rows of a tile: bf16 a warpgroup per 64 rows, f32 both on the same 64
// rows, each on half the columns.
__host__ __device__ constexpr int tile_rows(bool bf16) {
  return bf16 ? kRows : 64;
}
constexpr int kMaxStages = 6;  // weight k-slices in the shared-memory ring
constexpr int kMaxC = 256;     // hidden width limit
constexpr int kSliceBytes = 64 * kWgN;  // one k-slice of packed weights
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
// [the ring's mbarriers, padded to 64 B | w_row (kRows f32) | alpha_w
// (kRows f32) | a layer's bias (kMaxC f32) | wa (kMaxC f32) | pad] before
// the region that holds A, the ring, the raw inputs and the staging
constexpr size_t kHeadBytes =
    (64 + 4 * (2 * kRows + 2 * kMaxC) + 127) / 128 * 128;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Input rows of a weight k-slice: 32 bf16 values or 8 tf32 hi/lo pairs
// fill 64 bytes a column.
__host__ __device__ inline int slice_depth(bool bf16) { return bf16 ? 32 : 8; }

// Stages of the ring: as many as shared memory leaves room for beside A.
__host__ __device__ inline int ring_stages(bool) { return 6; }

// Width of the first block1 input row.
__host__ __device__ inline int block1_in(int F, int nf, int Dd, int df) {
  return F + 2 * F * nf + 2 * Dd * df;
}

// Shared-memory layout of the body, in bytes from the region's start.
// A in bf16 mode: 8-column chunks, each kRows rows of 16 bytes (wgmma's
// no-swizzle K-major core matrices: 8 rows x 16 bytes, 128 contiguous
// bytes). A in f32 mode: row-major, lda floats a row, 64 rows.
struct BodyLayout {
  int kp0;               // first layer's depth padded to the slice depth
  int lda;               // f32 A's row stride, in floats
  int lds;               // the staging's row stride, in floats (C + 8)
  int rows;              // tile_rows(bf16)
  int stages;            // ring stages
  size_t ring_off;       // the ring follows A
  size_t raw_off;        // the tile's feat and dist rows follow the ring
  size_t staging_bytes;  // kRows x lds floats, over A and the ring
  size_t region_bytes;   // max(A + ring + raw, staging)
};

// n_raw = F + Dd + 2: the floats of a row's raw inputs, each part padded
// by one float.
__host__ __device__ inline BodyLayout body_layout(int in0, int n_raw, int C,
                                                  bool bf16) {
  BodyLayout L;
  L.kp0 = round_up(in0, slice_depth(bf16));
  const int kmax = L.kp0 > C ? L.kp0 : C;
  // a row stride of 4 (mod 32) words spreads 8 rows over 32 banks
  L.lda = round_up(kmax, 32) + 4;
  L.lds = C + 8;  // 8 (mod 32) words: 8-byte stores of 4 rows hit 32 banks
  L.rows = tile_rows(bf16);
  const size_t a_bytes =
      static_cast<size_t>(L.rows) * (bf16 ? 2 * kmax : 4 * L.lda);
  L.ring_off = (a_bytes + 127) / 128 * 128;
  L.stages = ring_stages(bf16);
  L.raw_off = L.ring_off + static_cast<size_t>(L.stages) * kSliceBytes;
  L.staging_bytes = static_cast<size_t>(L.rows) * L.lds * sizeof(float);
  const size_t raw = static_cast<size_t>(L.rows) * n_raw * sizeof(float);
  const size_t end = L.raw_off + raw;
  L.region_bytes = end > L.staging_bytes ? end : L.staging_bytes;
  return L;
}

// Bytes of dynamic shared memory the body needs.
inline size_t body_smem_bytes(int F, int nf, int Dd, int df, int C,
                              bool bf16) {
  return kHeadBytes +
         body_layout(block1_in(F, nf, Dd, df), F + Dd + 2, C, bf16)
             .region_bytes;
}

// Ints of a K2 tile's map (TileRows::map): each row's global row, then
// its point, and -1 past the live rows through row kRows; then a bit a
// row, set on each point's last row.
constexpr int kMapInts = kRows + 1 + kRows / 32;

// Bytes of dynamic shared memory of a K2 block (fused_agg.cu): the body's,
// then its tile's map.
inline size_t k2_smem_bytes(int F, int nf, int Dd, int df, int C, bool bf16) {
  return body_smem_bytes(F, nf, Dd, df, C, bf16) + kMapInts * sizeof(int);
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : 0.01f * v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 4 bytes global -> shared without passing through registers
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The ring's mbarriers; thread 0 calls it once a block, before a
// __syncthreads and the first body.
__device__ __forceinline__ void ring_init(unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  for (int s = 0; s < kMaxStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// byte offset between the two K-adjacent core matrices (lbo) and between
// 8-row groups (sbo), each in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 256, f32, this thread's 128 values) += A (64 x 16) . B (16 x 256),
// bf16, A and B read from shared memory through their descriptors; with
// accumulate 0 the old d is ignored. Asynchronous: d is read after a
// wgmma.wait_group that covers it.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, f32, this thread's 128 values) += A (64 x 8) . B (8 x 256),
// tf32, A from registers (this warp's m16n8k8 A fragment of rows 16 w ..),
// B from shared memory through its descriptor. Asynchronous: the A
// registers and d stay untouched until a wgmma.wait_group covers it.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As wgmma_m64n256k8_tf32 for 64 x 128: d[OFF ..] holds this thread's 64
// sums (column 8 q + 2 t + e of rows r, r + 8 at d[OFF + 4 q + 2 h + e]).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[N],
    const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulators");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait_all(float (&acc)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i)  // no read of a sum before the wait
    asm volatile("" : "+f"(acc[i])::"memory");
}

// Where K3's recompute (fused_agg_bwd.cu) writes what the backward reads,
// indexed by global neighbour row: x, the PE rows (ldx floats a row, zero
// past in0), h, every layer's post-activation (layer l at h + l * h_layer,
// C floats a row), and raw = h^{L-1} . wa + ba. The values are f32, before
// bf16 mode rounds them for a product.
struct SaveArgs {
  float* x = nullptr;
  int ldx = 0;
  float* h = nullptr;
  size_t h_layer = 0;
  float* raw = nullptr;
};

// A tile of K2's plan (fused_agg.cu): n <= tile_rows live rows (w != 0)
// of whole shading points, in point order and each point's k in order;
// `row` is the calling thread's tile row's global neighbour row m K + k
// (thread i holds row i, i < n). map is kMapInts ints of shared memory
// past the body's, where the body keeps each tile row's global row while
// it loads, then its point m (-1 past the live rows), and each point's
// last row as a bit.
struct TileRows {
  int n = 0;
  int row = 0;
  int* map = nullptr;
};

// Runs the body for one tile of K2's plan, `tile`, and writes each of its
// points' reduced rows [feat_agg (C) | alpha_agg], the sum over the
// point's live rows in k order, to dst[m * ld_dst + c]. Wp is the packed
// block1 weights (`pack_block1`), Bias the layers' biases concatenated.
// `ring_it` counts the slices the block's ring has carried (0 before the
// first body, after ring_init). Every thread of the block calls it; it
// returns with the block synchronised, after which the region is free.
// With SAVE (K3's recompute) the tile is instead the n_pts (<= tile_rows)
// consecutive rows from m0 (K = 1); it writes x, h and raw through `save`
// and stops after the last layer: no alpha, no K-sum, dst, wgt and tile
// unused.
template <bool BF16, bool SAVE = false>
__device__ __forceinline__ void block1_alpha_tile(
    const float* __restrict__ feat, const float* __restrict__ dist,
    const float* __restrict__ wgt, const void* __restrict__ Wp,
    const float* __restrict__ Bias, int n_layers,
    const float* __restrict__ wa, const float* __restrict__ ba, int K, int F,
    int nf, int Dd, int df, int C, int m0, int n_pts, unsigned char* smem,
    uint32_t& ring_it, float* dst, int ld_dst, SaveArgs save = SaveArgs(),
    TileRows tile = TileRows()) {
  constexpr int kR = tile_rows(BF16);
  const int in0 = block1_in(F, nf, Dd, df);
  const BodyLayout L = body_layout(in0, F + Dd + 2, C, BF16);
  const int kStages = L.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* w_row = reinterpret_cast<float*>(smem + 64);  // kRows: w_r
  float* alpha_w = w_row + kRows;                      // kRows: dot, a_r w_r
  float* bias_s = alpha_w + kRows;                     // C: the layer's bias
  float* wa_s = bias_s + kMaxC;                        // C: wa
  unsigned char* region = smem + kHeadBytes;
  unsigned char* ring = region + L.ring_off;
  float* staging = reinterpret_cast<float*>(region);

  const int KS = slice_depth(BF16);
  const int s_first = L.kp0 / KS, s_rest = C / KS;
  const int n_slices = s_first + (n_layers - 1) * s_rest;
  const unsigned char* Wb = static_cast<const unsigned char*>(Wp);
  const uint32_t it0 = ring_it;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int wg_row = BF16 ? wg * 64 : 0;    // the warpgroup's first row
  const int wg_col = BF16 ? 0 : wg * 128;   // and first column
  const int rw = wg_row + 16 * (warp & 3) + g;  // the thread's rows rw, rw + 8

  // ---- 0. the first slices load while the raw rows arrive and the PE
  // rows are computed. The region's earlier generic writes (a previous
  // body's staging, a colour head's scratch) are ordered before the bulk
  // copies that overwrite it.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  int issued = 0;  // slices of this body given to the ring (thread 0)
  auto refill = [&](int done) {  // slices < done are consumed
    if (tid == 0)
      for (; issued < n_slices && issued < done + kStages; ++issued) {
        const int stage = static_cast<int>((it0 + issued) % kStages);
        bulk_load(smem_addr(ring + stage * kSliceBytes),
                  Wb + static_cast<size_t>(issued) * kSliceBytes, kSliceBytes,
                  smem_addr(bars + stage));
      }
  };
  refill(0);

  // ---- 1. the tile's raw rows into shared memory (rows padded by a float
  // against bank conflicts), then their PE rows into A: zero rows past the
  // end, zero padding columns. K2 reads its rows through the plan's list;
  // K3a's are consecutive from r0.
  const size_t r0 = static_cast<size_t>(m0) * K;  // K3a's first global row
  const int rows_live = SAVE ? n_pts * K : tile.n;
  float w_mine = 0.0f;  // K2: the thread's row's w, read ahead of the rows
  if (!SAVE) {
    if (tid < rows_live) {
      tile.map[tid] = tile.row;
      w_mine = wgt[tile.row];
    }
    __syncthreads();
    // each point's last row, a bit a row (a word a warp), for the K-sum
    const bool end = tid < rows_live && (tid + 1 == rows_live ||
                                         tile.map[tid + 1] / K != tile.row / K);
    const uint32_t bits = __ballot_sync(0xffffffffu, end);
    if ((tid & 31) == 0 && tid < kRows) tile.map[kRows + 1 + (tid >> 5)] = bits;
  }
  auto grow = [&](int r) {  // tile row r's global row
    return SAVE ? r0 + r : static_cast<size_t>(tile.map[r]);
  };
  float* raw_f = reinterpret_cast<float*>(region + L.raw_off);  // rows x F+1
  float* raw_d = raw_f + kR * (F + 1);                          // rows x Dd+1
  // a row's n floats from src into dst (rows padded by a float), four
  // copies a thread at a time: their rows are read before they are issued
  auto stage = [&](float* dst, const float* src, int n) {
    for (int i0 = tid; i0 < rows_live * n; i0 += 4 * kThreads) {
      size_t g[4];
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        r[u] = i / n;
        g[u] = i < rows_live * n ? grow(r[u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < rows_live * n)
          cp_async4(dst + i + r[u], src + g[u] * n + (i - r[u] * n));
      }
    }
  };
  stage(raw_f, feat, F);
  stage(raw_d, dist, Dd);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!SAVE && tid < kR) w_row[tid] = w_mine;
  for (int c = tid; c < C; c += kThreads) wa_s[c] = wa[c];
  __syncthreads();
  // the map's global rows are read: it keeps each row's point for the
  // K-sum, -1 past the live rows (through row kR)
  if (!SAVE && tid <= kR)
    tile.map[tid] = tid < rows_live ? tile.map[tid] / K : -1;
  auto put = [&](int r, int j, float v) {
    if (BF16)  // 8-column chunks of kRows 16-byte rows
      *reinterpret_cast<__nv_bfloat16*>(region + (j >> 3) * (kRows * 16) +
                                        r * 16 + (j & 7) * 2) =
          __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(region)[r * L.lda + j] = v;
  };
  auto put2 = [&](int r, int j, float v0, float v1) {  // j even
    if (BF16)
      *reinterpret_cast<__nv_bfloat162*>(region + (j >> 3) * (kRows * 16) +
                                         r * 16 + (j & 7) * 2) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(region) +
                                 r * L.lda + j) = make_float2(v0, v1);
  };
  // bf16 mode saves x as it goes (A holds it rounded); f32 copies A below
  auto save_x = [&](int r, int j, float v) {
    if (SAVE && BF16 && r < rows_live)
      save.x[(r0 + r) * static_cast<size_t>(save.ldx) + j] = v;
  };
  const int nch = F + Dd;  // an item: a row's channel and its frequencies
  for (int idx = tid; idx < kR * nch; idx += kThreads) {
    const int ch = idx / kR, r = idx % kR;  // rows fastest
    const bool live = r < rows_live;
    const bool is_f = ch < F;
    const float x = live ? (is_f ? raw_f[r * (F + 1) + ch]
                                 : raw_d[r * (Dd + 1) + ch - F])
                         : 0.0f;
    const int nfreq = is_f ? nf : df;
    const int j0 = is_f ? F + 2 * nf * ch : F + 2 * F * nf + 2 * df * (ch - F);
    if (is_f) {
      put(r, ch, x);
      save_x(r, ch, x);
    }
    // sin/cos of x 2^f by the double-angle recurrence from sincosf(x)
    // (within ~2^f ulp)
    float sn = 0.0f, cs = 0.0f;
    if (live) sincosf(x, &sn, &cs);
    for (int f = 0; f < nfreq; ++f) {
      if (F & 1) {  // odd F: the pairs start at odd columns
        put(r, j0 + 2 * f, sn);
        put(r, j0 + 2 * f + 1, cs);
      } else {
        put2(r, j0 + 2 * f, sn, cs);
      }
      save_x(r, j0 + 2 * f, sn);
      save_x(r, j0 + 2 * f + 1, cs);
      const float s2 = 2.0f * sn * cs;
      cs = (cs - sn) * (cs + sn);
      sn = s2;
    }
  }
  const int npad = L.kp0 - in0;
  for (int idx = tid; idx < kR * npad; idx += kThreads) {
    const int r = idx % kR, j = in0 + idx / kR;
    put(r, j, 0.0f);
    if (j < save.ldx) save_x(r, j, 0.0f);
  }
  // A's generic writes before the tensor cores read it (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (SAVE && !BF16) {  // f32 A holds x as it is: copy its live rows
    const float* A = reinterpret_cast<const float*>(region);
    for (int idx = tid; idx < rows_live * save.ldx; idx += kThreads) {
      const int r = idx / save.ldx, j = idx - r * save.ldx;
      save.x[(r0 + r) * static_cast<size_t>(save.ldx) + j] = A[r * L.lda + j];
    }
  }

  // ---- 2. block1 on the tensor cores, the sums in registers: thread
  // (warp, g, t) holds acc[4 q + 2 h + e] = row rw + 8 h, column
  // wg_col + 8 q + 2 t + e; in f32 mode acc[64 + ..] holds the same
  // entries' small products
  int it = 0;  // slices consumed by this body
  for (int l = 0; l < n_layers; ++l) {
    float acc[kAccs];
#pragma unroll
    for (int i = 0; i < kAccs; ++i) acc[i] = 0.0f;
    const int ns = l == 0 ? s_first : s_rest;
    // the epilogue's bias, read after the slices' barriers
    for (int c = tid; c < C; c += kThreads)
      bias_s[c] = Bias[static_cast<size_t>(l) * C + c];
    // one k-slice: wait for its stage, issue its products, then wait for
    // the previous slice's (the next slice's products queue behind these)
    // and hand its stage back to the ring. f32 alternates two register
    // sets for A's fragments (set B), each kept until its products are done.
    uint32_t ah[2][4], al[2][4];
    // f32: A's fragment of slice s (rows rw, rw + 8; columns k0 + t, + 4)
    // as tf32 hi/lo into set B, loaded one slice ahead of its products
    auto load_a = [&](int s, auto set) {
      constexpr int B = decltype(set)::value;
      const float* p = reinterpret_cast<const float*>(region) +
                       rw * L.lda + s * KS + t;
      const float v[4] = {p[0], p[8 * L.lda], p[4], p[8 * L.lda + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[B][i] = tf32_rna(v[i]);
        al[B][i] = tf32_rna(v[i] - __uint_as_float(ah[B][i]));
      }
    };
    if (!BF16) load_a(0, std::integral_constant<int, 0>());
    auto step = [&](int s, auto set) {
      constexpr int B = decltype(set)::value;
      const uint32_t gi = it0 + it;
      const int stage = static_cast<int>(gi % kStages);
      bar_wait(smem_addr(bars + stage), (gi / kStages) & 1);
      const uint32_t slice = smem_addr(ring + stage * kSliceBytes);
      if (BF16) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int kc = (s * KS + 16 * kk) >> 3;  // A's 8-column chunk
          wgmma_m64n256k16(
              acc,
              wgmma_desc(smem_addr(region) + kc * (kRows * 16) + wg_row * 16,
                         kRows * 16, 128),
              wgmma_desc(slice + 2 * kk * (kWgN * 16), kWgN * 16, 128), 1);
        }
      } else {
        // the warpgroup's 128 columns of the hi and lo planes
        const uint32_t bcol = slice + wg_col * 16;
        const uint64_t bh = wgmma_desc(bcol, kWgN * 16, 128);
        const uint64_t blo = wgmma_desc(bcol + 2 * kWgN * 16, kWgN * 16, 128);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n128k8_tf32<kAccs / 2>(acc, al[B], bh);  // small products
        wgmma_m64n128k8_tf32<kAccs / 2>(acc, ah[B], blo);
        wgmma_m64n128k8_tf32<0>(acc, ah[B], bh);          // big products
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      // the previous slice's products are done: its register set takes
      // the next slice's fragment
      if (!BF16 && s + 1 < ns) load_a(s + 1, std::integral_constant<int, 1 - B>());
      // every warpgroup is done with the previous slice: its stage goes
      // back to the ring (f32's half-width slices, every second slice)
      if (BF16 || B == 1) {
        __syncthreads();
        refill(it);
      }
      ++it;
    };
    for (int s = 0; s < ns; s += 2) {
      step(s, std::integral_constant<int, 0>());
      if (s + 1 < ns) step(s + 1, std::integral_constant<int, 1>());
    }
    wgmma_wait_all(acc);
    __syncthreads();  // both warpgroups' products read A and the ring
    refill(it);
    if (!BF16) {  // f32: the pre-activations into acc[i]
#pragma unroll
      for (int q = 0; q < kWgN / 16; ++q) {
        if (wg_col + 8 * q < C) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // j = 2 h + e
            const int i = 4 * q + j;
            acc[i] = acc[i] + acc[kAccs / 2 + i] +
                     bias_s[wg_col + 8 * q + 2 * t + (j & 1)];
          }
        }
      }
    }
    // epilogue: bias, LeakyReLU; the next A in place (the thread's own
    // rows), or f32 h to the staging and the alpha head's dot h . wa
    const bool last = l == n_layers - 1;
    float dot[2] = {0.0f, 0.0f};
    float wr[2] = {0.0f, 0.0f};
    if (!SAVE) wr[0] = w_row[rw], wr[1] = w_row[rw + 8];
    float* hsave = save.h + l * save.h_layer + r0 * static_cast<size_t>(C);
    constexpr int kQ = BF16 ? kWgN / 8 : kWgN / 16;  // the thread's 8-column groups
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c = wg_col + 8 * q + 2 * t;
      if (wg_col + 8 * q < C) {  // c < C, uniform across the warp (C % 32 == 0)
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + c);
        const float2 ww = *reinterpret_cast<const float2*>(wa_s + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h;
          const int i = 4 * q + 2 * h;
          // bf16: the sums; f32: the pre-activations
          const float v0 = leaky(BF16 ? acc[i] + bb.x : acc[i]);
          const float v1 = leaky(BF16 ? acc[i + 1] + bb.y : acc[i + 1]);
          if (SAVE && r < rows_live)
            *reinterpret_cast<float2*>(hsave + r * C + c) = make_float2(v0, v1);
          if (last) {
            if (!SAVE)
              *reinterpret_cast<float2*>(staging + r * L.lds + c) =
                  make_float2(v0 * wr[h], v1 * wr[h]);
            dot[h] = fmaf(v1, ww.y, fmaf(v0, ww.x, dot[h]));
          } else {
            put2(r, c, v0, v1);
          }
        }
      }
    }
    if (last) {  // the row's dot: the four threads of its columns, a fixed
                 // tree; f32 keeps each warpgroup's half apart
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dot[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) alpha_w[(BF16 ? 0 : wg * 64) + rw + 8 * h] = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  ring_it = it0 + n_slices;
  // the row's dot h . wa (f32: the two halves, in order)
  auto row_dot = [&](int r) {
    return BF16 ? alpha_w[r] : alpha_w[r] + alpha_w[64 + r];
  };
  if (SAVE) {
    if (tid < rows_live) save.raw[r0 + tid] = row_dot(tid) + ba[0];
    __syncthreads();
    return;
  }

  // ---- 3. per-neighbour alpha (f32 head): softplus of the dot
  if (tid < rows_live) {
    const float x = row_dot(tid) + ba[0] - 1.0f;
    const float alpha = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));  // softplus
    alpha_w[tid] = alpha * w_row[tid];
  }
  __syncthreads();

  // ---- 4. weighted sum over each point's live rows -> its (C+1) row of
  // dst: a thread a column, the rows in turn, each point's k in order from
  // +0 (the staging holds h_r w_r), 8 rows' values loaded ahead of their
  // adds and a point's row of dst written at its last row (the tile's
  // last-row bits); the alpha column a thread a point, the thread of its
  // first row. A slot with w = 0 would add +-0, which leaves every partial
  // sum of a sum that starts at +0 as it is: the sums are those over all K
  // slots, bit for bit.
  const int* pt = tile.map;
  const uint32_t* ends = reinterpret_cast<const uint32_t*>(pt + kRows + 1);
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.0f;
    for (int r0 = 0; r0 < rows_live; r0 += 8) {  // kR % 8 == 0: in the tile
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = staging[(r0 + j) * L.lds + c];
      const uint32_t e = ends[r0 >> 5] >> (r0 & 31);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += v[j];  // past the live rows: never written
        if (e >> j & 1u) {  // the point's last row
          dst[static_cast<size_t>(pt[r0 + j]) * ld_dst + c] = s;
          s = 0.0f;
        }
      }
    }
  }
  if (tid < rows_live && (tid == 0 || pt[tid - 1] != pt[tid])) {
    const int p = pt[tid];
    float s = 0.0f;
    for (int r = tid; r < rows_live && pt[r] == p; ++r) s += alpha_w[r];
    dst[static_cast<size_t>(p) * ld_dst + C] = s;
  }
  __syncthreads();
}

}  // namespace sgnerf_agg
