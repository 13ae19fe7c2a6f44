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
// affine_wf_kernel, the padded engine's: one thread per instance, the
// bands in registers, rows staged whole through shared memory with
// coalesced loads (wf::affine_band).  Its direction bits compare values
// that the clamps make equal, so it keeps the reference's clamps and
// masks.  The direction plane keeps the Pallas kernel's (cell, instance)
// layout: thread r writes byte (cell, r) at cell * R + r, so a warp's 32
// stores of one cell land in 32 neighbouring bytes.  The wrapper hands
// the plane out as an (R, n, band) view of it, with no transpose.
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
struct AffineBand {
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

  __device__ __forceinline__ void row(const uint32_t (&ch)[BAND],
                                      uint32_t c1) {
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
__global__ void affine_wf_kernel(const uint8_t* __restrict__ s1,
                                 const uint8_t* __restrict__ s2,
                                 int32_t* __restrict__ out,
                                 uint8_t* __restrict__ dirs, int R, int n,
                                 int sat) {
  extern __shared__ uint8_t smem[];
  const int W = n + 2 * ETH;
  const long long r0 = (long long)blockIdx.x * blockDim.x;
  const int rows = (int)min((long long)blockDim.x, (long long)R - r0);
  uint8_t* a_sm = smem;
  uint8_t* b_sm = smem + (long long)blockDim.x * n;
  wf::stage_rows(a_sm, s1 + r0 * n, (long long)rows * n);
  wf::stage_rows(b_sm, s2 + r0 * W, (long long)rows * W);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const long long r = r0 + t;
  int de, dm;
  wf::affine_band<ETH>(a_sm + (long long)t * n, b_sm + (long long)t * W, n,
                       sat, dirs + r, R, de, dm);
  out[r] = de;
  out[R + r] = dm;
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

extern "C" int affine_wf_launch(const void* s1, const void* s2, void* out,
                                void* dirs, int R, int n, int eth, int sat,
                                int threads, int smem, void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  auto* d = (uint8_t*)dirs;
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<affine_wf_kernel<decltype(e)::value>>(
        R, threads, smem, stream, a, b, o, d, R, n, sat);
  });
}
