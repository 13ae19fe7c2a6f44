// Flash attention on Hopper's tensor cores: bfloat16, head_dim 16, 32, 64,
// 80 or 128, causal or bidirectional, GQA.
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:69, its body _kernel at :27) for the
// bfloat16 inputs; float32 inputs go to the CUDA-core kernel,
// flash_attention.cu.  For each batch
// row b, query head h and query position i it computes
//   softmax_j(q_i . k_j / sqrt(hd), j <= i when causal) . v_j
// with k and v read from KV head h // (H / KV): f32 scores, masked scores
// set to -1e30, a running max and sum rescaled by the change of the max, p
// rounded to bf16 before the P.V product, the P.V sum in f32, the output
// acc / max(l, 1e-30) rounded once to bf16, kv tiles past the diagonal
// skipped.  That is ``_sdpa_chunked(..., f32_scores=True)``, the plain
// version it is held against.  Two places differ from the Pallas body by
// rounding only:
//   * the scale multiplies the f32 product q.k instead of q before it.
//     At hd 16 and 64 the scale (1/4, 1/8) is exact, so the scores equal
//     the Pallas body's up to the order of the sum; at hd 32, 80 and 128
//     they differ by at most an f32 ulp of each score;
//   * the exp2 form: p = 2^(s * c - m * c) with c = scale * log2(e) folded
//     into one f32 constant, the max m taken over the unscaled scores (c
//     > 0, so the same key), and ex2.approx (relative error below 2^-22).
//     Each p moves by a few f32 ulps, far under the 2^-8 at which it is
//     rounded to bf16.
//
// What bounds it on the H100: operations.  The causal triangle needs
// 2 * S(S+1)/2 * hd multiply-adds per head for Q.K^T and as many for P.V,
// against q, k, v and o read or written once: about 4,000 flops per byte
// at S=32768, hd=64, far past the card's ~295 bf16 flops per byte.  The
// bound is the products at the tensor cores' 989 TFLOP/s; the S(S+1)/2
// exponentials per head on the special-function units (16 a clock per SM)
// come close to it at hd=64, pass it at hd 32 and 16 (1.85x and 3.7x the
// products' time: there they set the pace), and are not counted in it.
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling and
// intra-warpgroup overlap of softmax and products):
//   * one block of three warpgroups per (b, h, 128-row query tile): a
//     producer (one thread issues every TMA load; setmaxnreg gives its
//     warpgroup 40 registers) and two consumers of 64 query rows each (232
//     registers).  Blocks start in flash_common.cuh's order: every
//     head's longest causal tiles first where the K and V of all heads
//     fit in L2, else head by head;
//   * TMA loads, 64-column boxes (128 bytes, two boxes at hd=80 and 128)
//     with 128-byte swizzle at every head dim, over the (B, S, heads, hd)
//     layout with its strides (64-bit, so a 2^31-element batch stride
//     works); KV head h // rep is read in place, L2 serving its reuse
//     across the rep query heads.  Q is loaded once; K and V tiles of 128
//     keys stream through a ring (two stages, six at hd <= 32) with
//     separate buffers and full/empty mbarriers, so V_j lands while S_j =
//     Q.K_j^T runs and the next tiles while tile j is used.
//     TMA zero-fills rows past S and the columns of a box past hd: at
//     hd=80 columns 80-127 of the second box, at hd 16 and 32 columns
//     16-63 or 32-63 of the only one.  The map's dim 0 is hd, so only the
//     real columns are read from device memory, and each box still
//     completes its whole 16 KB of transaction bytes.  (Narrower boxes
//     with the 32- or 64-byte swizzle would save shared-memory writes
//     but need other descriptors; at hd <= 32 the exponentials, not the
//     loads, set the pace);
//   * S_j on wgmma m64n128k16 (bf16 x bf16 -> f32) with Q and K_j K-major
//     in shared memory, hd / 16 k-steps of 32 bytes (five at hd=80, the
//     fifth the first 32 bytes of box 1; one and two at hd 16 and 32: no
//     product on the zero fill);
//   * the online softmax on the accumulator fragment in registers: each
//     thread holds two rows, a quad of threads a row; the row max is
//     reduced over the quad with shuffles, the row sum kept per thread
//     and reduced once at the end.  Masking (key >= S, or key > query when
//     causal) runs only on the diagonal tile and the ragged last tile.
//     Every row sees key 0 in its first tile (and key k0 < S in every
//     tile it visits), so the running max is finite after the first tile
//     and exp2 never meets -1e30 - -1e30;
//   * P.V on wgmma with A = P from registers: the f32 accumulator of
//     S_j, converted pairwise to bf16, is the A fragment of P.V (the same
//     row and column in the same thread): no shared-memory round trip.
//     B = V_j in shared memory, MN-major through the transpose bit, N =
//     hd (m64n80k16 at hd=80: box 0's 64 columns and box 1's first 16;
//     m64n16k16 and m64n32k16 the first 16 or 32 columns of box 0);
//   * the epilogue divides by max(l, 1e-30), rounds once to bf16 and
//     stores the rows below S.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 128;          // query rows per block: two warpgroups of 64
constexpr int BK = 128;          // keys per K or V tile
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int CONSUMERS = 256;   // threads that release a ring slot
constexpr int BOX = 64;          // columns per TMA box: one 128-byte row
constexpr int ROW_BYTES = 128;   // a box row, the swizzle width
constexpr float NEG = -1e30f;

// Shared memory, every tile 1024-byte aligned (the swizzle atom: 8 rows
// of 128 bytes): Q (BQ rows), then STAGES K tiles, STAGES V tiles (BK
// rows each), each as ceil(HD / 64) boxes of 64 columns; then the
// barriers.
template <int HD>
struct Layout {
  // depth of the K and V rings: at hd <= 32 a tile's products and softmax
  // are too short to cover the loads' latency two tiles ahead (six
  // stages: 6-11% faster than two, tools/flash_variants.py on the H100)
  static constexpr int STAGES = HD <= 32 ? 6 : 2;
  static constexpr int NBOX = (HD + BOX - 1) / BOX;
  static constexpr int Q_BOX = BQ * ROW_BYTES;
  static constexpr int KV_BOX = BK * ROW_BYTES;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then k_full, k_empty, v_full, v_empty of each stage
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t bar_q(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t bar_k_full(uint32_t bar, int s) {
  return bar + 8 * (1 + 4 * s);
}
__device__ __forceinline__ uint32_t bar_k_empty(uint32_t bar, int s) {
  return bar + 8 * (2 + 4 * s);
}
__device__ __forceinline__ uint32_t bar_v_full(uint32_t bar, int s) {
  return bar + 8 * (3 + 4 * s);
}
__device__ __forceinline__ uint32_t bar_v_empty(uint32_t bar, int s) {
  return bar + 8 * (4 + 4 * s);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D map (column, head, position, batch) into shared memory,
// completing ``bar``'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(pos), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) {=, +=} A (64 x 16) . B (16 x 128); A and B bf16 in shared
// memory, both K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, f32) += A (64 x 16) . B (16 x 16); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle: the first 16 columns of a box.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16) . B (16 x 32); as wgmma_rs_n16, the
// first 32 columns of a box.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16) . B (16 x 80); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle: columns 64-79 are the first 16
// of the next 64-column box, the leading byte offset further on.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128); A bf16 in registers (the
// accumulator layout, two values a register), B bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S += or = the consumer's 64 query rows . K tile^T, over HD in steps of
// 16: A (Q) and B (K) K-major, each step 32 bytes into a 128-byte row of a
// box, the next box after four steps (at HD=80 one step into box 1; at HD
// 16 and 32 one and two steps, all in box 0).
template <int HD>
__device__ __forceinline__ void scores(float (&s)[64], uint32_t q,
                                       uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = kk / 4, in = (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q + off * Layout<HD>::Q_BOX + in, 16, 1024),
                  sw128_desc(k + off * Layout<HD>::KV_BOX + in, 16, 1024),
                  kk > 0);
  }
}

// acc += P . V tile: A = P from registers (four registers per 16 keys),
// B = V MN-major: 16 keys are two 8-row groups 1024 bytes apart, the
// 64-column boxes KV_BOX apart.
template <int HD>
__device__ __forceinline__ void pv(float (&acc)[HD / 2], const uint32_t* p,
                                   uint32_t v) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    const uint64_t d = sw128_desc(v + kt * 16 * ROW_BYTES,
                                  Layout<HD>::KV_BOX, 1024);
    if constexpr (HD == 16)
      wgmma_rs_n16(acc, p + 4 * kt, d);
    else if constexpr (HD == 32)
      wgmma_rs_n32(acc, p + 4 * kt, d);
    else if constexpr (HD == 64)
      wgmma_rs_n64(acc, p + 4 * kt, d);
    else if constexpr (HD == 80)
      wgmma_rs_n80(acc, p + 4 * kt, d);
    else
      wgmma_rs_n128(acc, p + 4 * kt, d);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int S, int H, int rep,
                   int group, int causal, float c, int64_t osb, int64_t oss,
                   int64_t osh) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t sq = base, bar = base + L::BAR_OFF;

  int b, h, iq;
  flash_tile(blockIdx.x, (S + BQ - 1) / BQ, group, H, causal, b, h, iq);
  const int q0 = iq * BQ;
  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min((q0 + BQ + BK - 1) / BK, nk_all) : nk_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q(bar), 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_k_full(bar, s), 1);
      mbar_init(bar_k_empty(bar, s), CONSUMERS);
      mbar_init(bar_v_full(bar, s), 1);
      mbar_init(bar_v_empty(bar, s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int g = h / rep;
      mbar_expect_tx(bar_q(bar), L::Q_BYTES);
      for (int c0 = 0; c0 < L::NBOX; ++c0)
        tma_load(sq + c0 * L::Q_BOX, &qmap, bar_q(bar), c0 * BOX, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        // round j / STAGES of slot s waits for the consumers' release of
        // the round before; in round 0 that parity (1) is already done
        const int s = j % L::STAGES;
        const uint32_t ph = (j / L::STAGES) & 1;
        const uint32_t sk = base + L::K_OFF + s * L::KV_BYTES;
        const uint32_t sv = base + L::V_OFF + s * L::KV_BYTES;
        mbar_wait(bar_k_empty(bar, s), ph ^ 1);
        mbar_expect_tx(bar_k_full(bar, s), L::KV_BYTES);
        for (int c0 = 0; c0 < L::NBOX; ++c0)
          tma_load(sk + c0 * L::KV_BOX, &kmap, bar_k_full(bar, s), c0 * BOX,
                   g, j * BK, b);
        mbar_wait(bar_v_empty(bar, s), ph ^ 1);
        mbar_expect_tx(bar_v_full(bar, s), L::KV_BYTES);
        for (int c0 = 0; c0 < L::NBOX; ++c0)
          tma_load(sv + c0 * L::KV_BOX, &vmap, bar_v_full(bar, s), c0 * BOX,
                   g, j * BK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = wg - 1;                       // consumer 0 or 1
    const int t = threadIdx.x % 128, lane = t % 32;
    // this thread's rows: r0 and r0 + 8; its columns in each 8-column
    // group: 2 * (lane % 4) and the next
    const int r0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t sqw = sq + 64 * w * ROW_BYTES;  // its 64 rows of Q

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q(bar), 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % L::STAGES;
      const uint32_t ph = (j / L::STAGES) & 1;
      const int k0 = j * BK;
      float sc[64];
      mbar_wait(bar_k_full(bar, s), ph);
      wgmma_fence();
      scores<HD>(sc, sqw, base + L::K_OFF + s * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      mbar_arrive(bar_k_empty(bar, s));

      // element i of sc: row r0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4)
      // + cq + i % 2
      if (k0 + BK > S || (causal && k0 + BK - 1 > q0 + 64 * w)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + i % 2;
          const int row = r0 + 8 * ((i / 2) % 2);
          if (key >= S || (causal && key > row)) sc[i] = NEG;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float corr[2], neg_mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * c);
        neg_mc[r] = -mx[r] * c;
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = ex2(fmaf(sc[i], c, neg_mc[r]));
        const float p1 = ex2(fmaf(sc[i + 1], c, neg_mc[r]));
        l[r] += p0 + p1;
        p[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];

      mbar_wait(bar_v_full(bar, s), ph);
      pin(acc);
      wgmma_fence();
      pv<HD>(acc, p, base + L::V_OFF + s * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      mbar_arrive(bar_v_empty(bar, s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* oh = o + int64_t(b) * osb + int64_t(h) * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* orow = oh + int64_t(row) * oss + cq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] / l[r],
                                  acc[4 * i + 2 * r + 1] / l[r]);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 tensor with element strides (sb, ss, sh, 1) as
// a 4-D map of 64-column, ``rows``-position boxes, 128-byte swizzle, zero
// fill past S.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S,
            int heads, int hd, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {BOX, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* o, int B, int S, int H,
                   int KV, int causal, float c, int64_t osb, int64_t oss,
                   int64_t osh, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<HD><<<(S + BQ - 1) / BQ * H * B, THREADS, smem,
                           stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, H, H / KV,
      flash_group(B, H, KV, S, HD, 2), causal, c, osb, oss, osh);
  return cudaGetLastError();
}

bool tma_ok(const void* p, int64_t s0, int64_t s1, int64_t s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * 2) % 16 == 0 &&
         (s1 * 2) % 16 == 0 && (s2 * 2) % 16 == 0;
}

}  // namespace

// bfloat16 only; hd 16, 32, 64, 80 or 128.  Strides are in elements: (batch, seq,
// head) of q, of k and v (equal), and of o; head_dim is contiguous.  q, k
// and v must be 16-byte aligned with strides of a multiple of 16 bytes
// (the TMA's rules): the wrapper checks, and so does this entry.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int hd, int causal, float scale, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t osb, int64_t oss, int64_t osh, void* stream) {
  if (KV <= 0 || H % KV ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128))
    return cudaErrorInvalidValue;
  if (!tma_ok(q, qsb, qss, qsh) || !tma_ok(k, ksb, kss, ksh) ||
      !tma_ok(v, ksb, kss, ksh))
    return cudaErrorMisalignedAddress;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!encode(fn, &qm, q, B, S, H, hd, qsb, qss, qsh, BQ) ||
      !encode(fn, &km, k, B, S, KV, hd, ksb, kss, ksh, BK) ||
      !encode(fn, &vm, v, B, S, KV, hd, ksb, kss, ksh, BK))
    return cudaErrorInvalidValue;
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 16)
    return launch<16>(qm, km, vm, o, B, S, H, KV, causal, c, osb, oss, osh, s);
  if (hd == 32)
    return launch<32>(qm, km, vm, o, B, S, H, KV, causal, c, osb, oss, osh, s);
  if (hd == 64)
    return launch<64>(qm, km, vm, o, B, S, H, KV, causal, c, osb, oss, osh, s);
  if (hd == 80)
    return launch<80>(qm, km, vm, o, B, S, H, KV, causal, c, osb, oss, osh, s);
  return launch<128>(qm, km, vm, o, B, S, H, KV, causal, c, osb, oss, osh, s);
}
