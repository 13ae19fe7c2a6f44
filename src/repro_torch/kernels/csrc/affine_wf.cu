// Banded affine (Gotoh) Wagner-Fischer for Hopper: distances only, or
// distances plus the packed direction planes.
//
// Replaces two Pallas kernels of src/repro/kernels/affine_wf.py that share
// _row_step and _init_bands:
//   affine_wf_dist_pallas (_kernel_dist): D[n][n] and the min of the last
//     band row, three bands D/M1/M2, no direction planes
//     (affine_dist_kernel);
//   affine_wf_pallas (_kernel): the same distances, and one packed
//     direction byte dD | dM1<<2 | dM2<<3 per band cell written out as an
//     (n * (2*ETH+1), R) uint8 plane; cells left of column 0 hold 0
//     (affine_wf_kernel).
//
// affine_dist_kernel.  What bounds it on the H100: integer instructions,
// not bytes (n=150, ETH=6: 1,950 band cells against 320 bytes an
// instance).  It runs the linear kernel's body (wf::pair_distances: two
// instances a thread in the 16-bit halves of its registers, the rows
// staged 32 columns at a time, unrolled by 4) with the affine recurrence
// on Hopper's DPX instructions.  Per pair of cells inside the band: the
// mismatch xor, the diagonal as one add-min (min(xor + D, D + 1)), M1
// and M2 one add-min each (min(D + 2, M + 1)), and one three-input min
// (VIMNMX3) of the three: five integer-pipe instructions, and three adds
// (D + 1, M1 + 1, M2 + 1), which the card issues off that pipe (VIADD).
// At the band's edges d = 0 and d = BAND-1 take a two-input min and d =
// 1 and d = BAND-2 a plain add for M2 and M1, so a row of a pair takes
// 5 * BAND - 4 integer-pipe instructions: 61 at ETH=6, 2.35 a cell
// (chip_smoke.py's bound, aff_pipe_per_cell).  The reference's
// recurrence counted in int32 operations, 14 a cell, is no bound on this
// card.
//
// Its values are the reference's without the clamps, the column masks
// and the match select, which AffineBand's comment shows give the same
// bits; tests/test_torch_affine_dist.py holds a model of this arithmetic
// to the plain version.
//
// Design, step by step, each step's tree timed by chip_smoke.py phase 3
// at 131,072 instances of n=150, ETH=6 (the main path's batch) and at
// 1,048,576 (the mate rescue's sweep), in order and then in reverse in
// one call, on an H100 80GB HBM3 at 700 W (PERF.md).  The first port (one
// instance a thread, whole rows staged in 39,936 B of shared memory a
// block, every row masked and clamped) took 0.388-0.390 ms and
// 2.138-2.147 ms:
//   1. rows staged 32 columns at a time into a [column][instance] layout
//      (wf::stage_cols), 8,448 B a block, the row body still masked and
//      clamped (wf::affine_row): 177 SASS instructions a row, 0.185-0.186
//      and 1.318-1.328 ms;
//   2. two instances a thread on 16x2 DPX lanes, still masked and
//      clamped, the match select by a lane mask: 279 instructions a row
//      of both, 0.168-0.172 and 1.082-1.087 ms;
//   3. the values unclamped, no column masks, the min in place of the
//      match select (AffineBand): 124 a row, 0.099-0.102 and 0.542-0.544
//      ms;
//   4. rows unrolled by 4, so that the window's slide is register
//      renaming (wf::pair_distances, the linear kernel's body): 452 for 4
//      rows, 4.35 a cell, 0.074-0.075 and 0.479-0.482 ms;
//   5. the block: 64 threads read the same at 131,072 (0.074 ms) and 1%
//      faster at 1,048,576, 256 threads 3-5% slower; at 16,384 128 is
//      the quickest (0.031-0.036 ms against 0.038-0.041 and 0.044-0.045),
//      so blocks of 128 stay.  Two pairs a thread (one 32-bit load a
//      column for four instances, the pairs' rows interleaved; its trees
//      and this one's timed likewise, in a run of their own) is slower at
//      both sizes: 0.0847-0.0874 ms against 0.0744-0.0749 at 131,072 and
//      0.5233-0.5271 against 0.4826 at 1,048,576, in blocks of 64 or
//      128; it takes 60, 128 and 204 registers at ETH=0, 6 and 12, so
//      half the warps fit, and a scheduler holds no more independent
//      chains than with one pair.  One pair a thread stays.
// 64 registers at ETH=6, 32 at ETH=0, 127 at ETH=12, no spills; 16,640 B
// of shared memory a block.  Its steady loop at ETH=6 runs 2.36
// integer-pipe instructions a cell (VIADDMNMX 141, LOP3 52, VIMNMX3 44,
// VIMNMX 8 over 4 rows of a pair: the bound's 244 and one more), 2.43
// with the loads' PRMTs; at 1,048,576 that is 62% of the pipe's 64 a
// clock an SM at 1.98 GHz, which they share (chip_smoke.py
// phase_dpx_rates), and 60% of the bound; the 1.9 others a cell (VIADD,
// IMAD, LDS) go elsewhere.
//
// affine_wf_kernel, the padded engine's: the same distances and one
// direction byte a band cell, bit for bit the reference's.  What bounds
// it on the H100: its bytes.  At n=150, ETH=6 it writes 1,950 bytes of
// direction planes an instance against 320 read: 1.19 GB at 524,288
// instances, 0.355 ms at 3.35 TB/s, against 0.266 ms for its integer
// instructions (the recurrence and the direction nibble, chip_smoke.py's
// aff_pipe_per_cell and dir_pipe_per_cell).  It runs the distance
// kernels' body (wf::pair_distances: two instances a thread in the
// 16-bit halves of its registers, 32-column tiles, rows unrolled by 4)
// with DirBand's recurrence, which keeps the reference's clamps (its
// direction bits compare values that the clamps make equal) and its
// column masks in rows 1..ETH only, and hands each cell's two direction
// bytes to the sink, which stores them in one 16-bit store: a warp
// writes 64 neighbouring bytes of a cell.  The plane keeps the Pallas
// kernel's (cell, instance) layout, byte (cell, r) at cell * Rp + r,
// where the wrapper pads R to a multiple of a block's instances (Rp) so
// that no store needs a branch; it hands the plane out as an (R, n,
// band) view, with no transpose.
//
// Design, step by step, each step's tree timed by chip_smoke.py phase 3
// at 524,288 instances of n=150, ETH=6, sat=32 (the padded engine's
// batch) and at 16,384, in order and then in reverse, on an H100 80GB
// HBM3 at 700 W (PERF.md).  The first port (one instance a thread, whole
// rows staged in 39,936 B of shared memory a block, every row masked and
// clamped, one byte store a cell) took 1.975-1.981 and 0.222-0.230 ms:
//   1. rows staged 32 columns at a time into a [column][instance] layout
//      (wf::stage_cols), 8,448 B a block, still one instance a thread and
//      the first port's row: 1.769-1.771 and 0.172-0.175 ms;
//   2. column masks only in rows 1..ETH and dD in bit arithmetic
//      (wf::affine_row, the traceback's row): 1.377-1.379 and 0.065 ms;
//   3. two instances a thread on 16x2 DPX lanes (DirBand), clamps kept,
//      dD riding D's min, each thread's two bytes of a cell in one 16-bit
//      store (behind a branch for a block's last instances, at a 64-bit
//      address a cell), rows not unrolled: 0.782-0.784 and 0.118 ms;
//   4. the plane padded to a multiple of a block's instances, so that the
//      stores need no branch, and each store's address one 32 x 32 ->
//      64-bit multiply-add: 0.615-0.618 and 0.063 ms;
//   5. rows unrolled by 4 (the shared tile loop): 0.612-0.617 and
//      0.067-0.075 ms.  Blocks of 64 threads read 0.634-0.636 and
//      0.066-0.068 ms, of 256 0.631-0.633 and 0.087-0.088, so blocks of
//      128 stay; __launch_bounds__(128, 1) (no spills at any ETH, 96
//      registers at ETH=6) reads 0.618-0.624 and 0.049-0.051.
// What holds it is the stores: a fill_ of the same planes, written in
// order, takes 0.313-0.314 ms; with the recurrence left out the same
// stores take about the kernel's time, and with the stores left out the
// recurrence takes well under it.  Staging a block's bytes of 4 rows in
// shared memory and writing them in 16-byte stores, barriers every 4
// rows, streaming stores, blocks of 512 instances and a negated copy of
// V were no faster (a harness outside the repository, no figure kept).
// 64 registers at ETH=6, 40 at ETH=0, 128 at ETH=12, 16 B of spills at
// ETH=11 only; 16,640 B of shared memory a block.  Its steady loop at
// ETH=6 runs 10.9 SASS instructions a cell, 4.9 of them DPX, LOP3 and
// PRMT (the bound's 4.35 plus one LOP3 to assemble the nibble a cell of
// two instances) and 1.5 IADD3 (the negated operands of the two relu
// add-mins, addresses).
#include "wf_common.cuh"

namespace {

using wf::ONE;
constexpr uint32_t TWO = 2 * ONE;
constexpr int THREADS = 128;  // affine_dist_kernel: 2 * THREADS instances

// The band of both instances: V = D and F = M1 + 1 (F[BAND-1] unused).
// row() takes it from row i-1 to row i, in place; M2 runs along the row.
//
// Why it gives the reference's bits (repro.core.affine_wf._row_step):
//   - Values unclamped.  The reference clamps to sat after every step;
//     but min(min(x, sat) + c, sat) = min(x + c, sat) for c >= 0 and min
//     commutes with min(., sat), so min(v, sat) of each value here is the
//     reference's, any two values >= sat are interchangeable, and only
//     the two outputs need the clamp.  An operand that is always >= sat
//     leaves a min out: the off-band up neighbour of d = BAND-1 (its M1
//     and the extension of d = BAND-2's M1) and the off-band left one of
//     d = 0 (its M2 and the extension of d = 1's).
//   - No column masks.  A cell left of column 0 starts at sat (row 0)
//     and takes the min of operands from cells left of column 0, all >=
//     sat, so it stays >= sat, as the reference's mask sets it.
//   - No match select.  The reference takes the diagonal on a match,
//     without a min; this takes min(diagonal, M1, M2) on every cell.
//     Both are the banded Gotoh optimum: a path to (i, j) ending in a gap
//     over a[i] consumed b[j] earlier, paired with some a[k] or in a gap,
//     and moving that pairing or gap so that a[i] meets b[j] last costs
//     no more (a gap of L costs 1 + L, a mismatch 1) and keeps the path
//     inside the band; so on a match M1 and M2 are never below the
//     diagonal.  The same holds on column 0 of rows 1..ETH, where the
//     reference takes M1 even on a match: the diagonal and M2 come from
//     cells left of column 0, >= sat, and min(M1, them, sat) = min(M1,
//     sat).
//   - 16-bit lanes.  Row 0 is at most sat; D grows by at most one a row
//     (its diagonal term is at most D + 1), so D <= sat + n, M1 + 1 and
//     M2 + 1 <= D + 3, and the largest sum, xor + D, is at most 255 + sat
//     + n: 1,248 at the longest read the wrappers take (n = 908 at eth 0,
//     ops.check_wf_geometry) with sat <= 85, far below 2^15.
template <int ETH>
struct AffineBand : wf::DistBand {
  static constexpr int BAND = 2 * ETH + 1;
  uint32_t V[BAND], F[BAND];

  __device__ __forceinline__ explicit AffineBand(int sat) {
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const int j0 = d - ETH;
      V[d] = (j0 < 0 ? sat : min(j0 == 0 ? 0 : 1 + j0, sat)) * ONE;
      F[d] = (sat + 1) * ONE;
    }
  }

  template <bool MASK, class Sink>
  __device__ __forceinline__ void row(const uint32_t (&ch)[BAND],
                                      uint32_t c1, int, Sink&) {
    uint32_t left = 0, g = 0;  // this row: D and M2 + 1 of the cell left
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      // D + (bytes differ): xor is 0 where they match, else 1..255
      const uint32_t diag = __viaddmin_s16x2(ch[d] ^ c1, V[d], V[d] + ONE);
      uint32_t m1 = 0, m2 = 0;
      if (d + 1 < BAND) {  // M1 = min(D_up + 2, M1_up + 1)
        m1 = d + 2 < BAND ? __viaddmin_s16x2(V[d + 1], TWO, F[d + 1])
                          : V[d + 1] + TWO;
        F[d] = m1 + ONE;
      }
      if (d > 0) {  // M2 = min(D_left + 2, M2_left + 1)
        m2 = d > 1 ? __viaddmin_s16x2(left, TWO, g) : left + TWO;
        g = m2 + ONE;
      }
      uint32_t v = diag;
      if (d > 0 && d + 1 < BAND)
        v = __vimin3_s16x2(diag, m1, m2);
      else if (d + 1 < BAND)
        v = __vmins2(diag, m1);
      else if (d > 0)
        v = __vmins2(diag, m2);
      V[d] = left = v;
    }
  }
};

constexpr int DIR_THREADS = 128;  // affine_wf_kernel: 2 * DIR_THREADS
constexpr uint32_t FOUR = 4 * ONE;
constexpr uint32_t CODES = 3 * ONE;  // dD's code bits in both halves
// dD's codes: 1 substitution, 2 enter M1, 3 enter M2 (0 the match)
constexpr uint32_t SUB = FOUR + ONE, M1C = 2 * ONE, M2C = 3 * ONE;
// v in both halves, a negative v as its 16-bit two's complement
constexpr uint32_t lanes(int v) { return (uint32_t)(uint16_t)v * ONE; }
constexpr uint32_t NEG6 = lanes(-6), NEG7 = lanes(-7);

// affine_wf_kernel's band, both instances, every value scaled by 4: V =
// 4 D and M = 4 M1 + 2, the reference's clamped values (M with dD's
// code for M1).  row() takes it from row i-1 to row i, in place, 4 M2 +
// 3 running along the row, and hands each cell's nibble dD | dM1 << 2 |
// dM2 << 3 to the sink, one in the low byte of each half.  The bytes
// come scaled by 8 (chr), so that their xor is 0 on a match and at
// least 8 on a mismatch.
//
// Why it gives the reference's bits (repro.core.affine_wf._row_step):
//   - Clamps kept: M1 = min(D_up + 2, M1_up + 1, sat) and M2 likewise are
//     one three-input min each (VIMNMX3; 4 x that + 2 is the min of 4 D
//     + 10, M + 4 and 4 sat + 2), and D is their min with D + 1, so D <=
//     sat too.  The raw candidates that the direction bits compare stay
//     below sat + 42 <= 127, so 4 x 127 and the xor's 8 x 255 stay far
//     below 2^15.
//   - dM1 = (D_up + 2 < M1_up + 1) = (4 M1_up - 4 D_up - 4 >= 4): one
//     add-min with a relu, max(min(M - V - 6, 4), 0), is 4 dM1 in place;
//     its add takes -V - 6 in both halves, NEG6 - V, which borrows from
//     neither half since V <= 4 x 127.  dM2 likewise from
//     the cell to the left.  Off the band (d = BAND-1 up, d = 0 left)
//     both are 0, the raw candidates being big + 2 and big + 1, and M1
//     and M2 are sat.
//   - dD rides the min that gives D: D + 1, M1 and M2 enter it as 4 v +
//     1, 4 v + 2 and 4 v + 3, so the min's value is the reference's dmin
//     and its two low bits the first of sub, M1, M2 that reaches it, the
//     reference's order on ties.  A match takes the diagonal with code 0:
//     the add-min min(xor + 4 D, that min) gives 4 D on a match, where M1
//     and M2 are never below D (AffineBand's argument: the clamp to sat
//     keeps the order), and the min on a mismatch (xor + 4 D >= 4 D + 8).
//     M1 and M2 carry their codes from their own mins, so no add stands
//     between those mins and D's.  One and (v & ~CODES) strips the code
//     for the next row; another (v & CODES | 4 dM1) starts the nibble.
//   - Column masks only in rows 1..ETH (MASK), where a cell left of
//     column 0 takes sat and byte 0, and the cell on column 0 takes M1
//     with dD = 2, as the reference does; past row ETH no cell is left of
//     column 0.
template <int ETH>
struct DirBand {
  static constexpr int BAND = 2 * ETH + 1;
  static constexpr bool MASKED = ETH > 0;  // rows 1..ETH reach left of 0
  static constexpr int SHIFT = 2;          // V = 4 D
  uint32_t V[BAND], M[BAND];
  const uint32_t sat4;

  __device__ __forceinline__ explicit DirBand(int sat)
      : sat4((uint32_t)(4 * sat) * ONE) {
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const int j0 = d - ETH;
      V[d] = (uint32_t)(4 * (j0 < 0 ? sat : min(j0 == 0 ? 0 : 1 + j0, sat)))
             * ONE;
      M[d] = sat4 + M1C;
    }
  }

  __device__ __forceinline__ static uint32_t chr(uint32_t pair) {
    return pair << 3;  // bytes 0..255: 8 x 255 stays in its half
  }

  template <bool MASK, class Sink>
  __device__ __forceinline__ void row(const uint32_t (&ch)[BAND],
                                      uint32_t c1, int i, Sink& sink) {
    uint32_t left = 0, ml = 0;  // the cell left: 4 D and 4 M2 + 3
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const int jj = i + d - ETH;  // the cell's column
      uint32_t m1 = sat4 + M1C, f1 = 0;  // 4 M1 + 2 and 4 dM1
      if (d + 1 < BAND) {
        m1 = __vimin3_s16x2(V[d + 1] + 8 * ONE + M1C, M[d + 1] + FOUR,
                            sat4 + M1C);
        f1 = __viaddmin_s16x2_relu(M[d + 1], NEG6 - V[d + 1], FOUR);
        if (MASK && jj < 0) m1 = sat4 + M1C;
      }
      uint32_t m2 = sat4 + M2C, f2 = 0;  // 4 M2 + 3 and 4 dM2
      if (d > 0) {
        m2 = __vimin3_s16x2(left + 8 * ONE + M2C, ml + FOUR, sat4 + M2C);
        f2 = __viaddmin_s16x2_relu(ml, NEG7 - left, FOUR);
        if (MASK && jj <= 0) m2 = sat4 + M2C;
      }
      const uint32_t dmin = __vimin3_s16x2(V[d] + SUB, m1, m2);
      uint32_t v = __viaddmin_s16x2(ch[d] ^ c1, V[d], dmin);
      if (MASK) v = jj == 0 ? m1 : (jj < 0 ? sat4 : v);
      const uint32_t dn = v & ~CODES;
      uint32_t nib = ((v & CODES) | f1) + 2 * f2;
      if (MASK && jj < 0) nib = 0;
      sink(i, d, nib);
      V[d] = left = dn;
      M[d] = m1;
      ml = m2;
    }
  }
};

// Where DirBand's nibbles go: the plane's byte (cell, r) at cell * Rp +
// r, the thread's two instances' bytes of a cell in one 16-bit store.
// Rp pads R to a multiple of a block's instances, so that every thread
// of a launch stores (those past R into the padding) without a branch,
// and the per-cell address is one 32 x 32 -> 64-bit multiply-add.
struct DirSink {
  uint8_t* p;                // byte (0, r) of the thread's first instance
  uint32_t Rp;               // bytes a cell of the plane
  unsigned long long row;    // bytes a row of the band's cells
  __device__ __forceinline__ void operator()(int i, int d,
                                             uint32_t nib) const {
    uint8_t* q = p + (unsigned long long)(uint32_t)(i - 1) * row +
                 (unsigned long long)(uint32_t)d * Rp;
    *(uint16_t*)q = (uint16_t)__byte_perm(nib, 0, 0x20);
  }
};

}  // namespace

template <int ETH>
__global__ void __launch_bounds__(THREADS)
    affine_dist_kernel(const uint8_t* __restrict__ s1,
                       const uint8_t* __restrict__ s2,
                       int32_t* __restrict__ out, int R, int n, int sat) {
  AffineBand<ETH> band(sat);
  wf::pair_distances<ETH, THREADS>(s1, s2, out, R, n, sat, band);
}

template <int ETH>
__global__ void __launch_bounds__(DIR_THREADS)
    affine_wf_kernel(const uint8_t* __restrict__ s1,
                     const uint8_t* __restrict__ s2,
                     int32_t* __restrict__ out, uint8_t* __restrict__ dirs,
                     int R, uint32_t Rp, int n, int sat) {
  const long long r =
      (long long)blockIdx.x * (2 * DIR_THREADS) + 2 * threadIdx.x;
  DirBand<ETH> band(sat);
  const DirSink sink{dirs + r, Rp, (unsigned long long)(2 * ETH + 1) * Rp};
  wf::pair_distances<ETH, DIR_THREADS>(s1, s2, out, R, n, sat, band, sink);
}

extern "C" int affine_wf_dist_launch(const void* s1, const void* s2, void* out,
                                     int R, int n, int eth, int sat,
                                     void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  // one thread a pair of instances
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<affine_dist_kernel<decltype(e)::value>>(
        (R + 1) / 2, THREADS, 0, stream, a, b, o, R, n, sat);
  });
}

// Rp: the plane's R padded to a multiple of 2 * DIR_THREADS (ops.py's
// DIR_ROWS), which every store of the launch stays below.
extern "C" int affine_wf_launch(const void* s1, const void* s2, void* out,
                                void* dirs, int R, int Rp, int n, int eth,
                                int sat, void* stream) {
  if (Rp < R || Rp % (2 * DIR_THREADS)) return (int)cudaErrorInvalidValue;
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  auto* d = (uint8_t*)dirs;
  // one thread a pair of instances
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<affine_wf_kernel<decltype(e)::value>>(
        (R + 1) / 2, DIR_THREADS, 0, stream, a, b, o, d, R, (uint32_t)Rp,
        n, sat);
  });
}
