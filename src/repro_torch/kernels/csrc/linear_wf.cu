// Banded linear Wagner-Fischer (paper Alg. 2) for Hopper.
//
// Replaces the Pallas kernel linear_wf_pallas
// (src/repro/kernels/linear_wf.py, body _kernel): D[n][n] and the min of
// the last band row for every (read, window) instance.
//
// What bounds it on the H100: integer instructions, not bytes (n=150,
// ETH=6: 1,950 band cells against 320 bytes an instance).  A thread holds
// two instances, one in each 16-bit half of its registers, and runs
// Hopper's DPX instructions on both: per pair of cells an xor, an add-min
// (VIADDMNMX), a three-input min (VIMNMX3) and an add, of which three are
// integer-pipe instructions (chip_smoke.py's bound, LIN_PIPE_PER_CELL).
// The steady loop at ETH=6 is 250 SASS instructions for 4 rows of both
// instances, 2.4 a cell, and staging adds about 0.5 a cell (cuobjdump,
// chip_smoke.py phase_sass).
//
// Design, step by step, each timed by chip_smoke.py phase 3 at 1,048,576
// instances of n=150, ETH=6 on an H100 80GB HBM3 at 700 W (PERF.md; one
// instance a thread with every row masked took 1.93 ms, 159 SASS
// instructions a row):
//   - band values unclamped, so that the clamps go to the two outputs and
//     the column masks of rows 1..ETH from every row (LinearBand says
//     why): 93 instructions a row, 1.84 ms;
//   - rows unrolled by UNROLL, so that the window's slide is register
//     renaming: 65 a row, 1.63 ms;
//   - rows staged TILE columns at a time into a [column][instance] layout
//     (wf::stage_cols), not whole: 8,448 B of shared memory a block, not
//     39,936, 1.06 ms;
//   - two instances a thread on 16x2 DPX lanes: 0.57 ms;
//   - the staging loops without branches, then with a pointer stepped by
//     a constant for full blocks: 0.41 ms.
// The staging and the tile loop are wf::pair_distances, which the affine
// distance kernel (affine_wf.cu) shares; this file holds the recurrence.
#include "wf_common.cuh"

namespace {

using wf::ONE;
constexpr int THREADS = 128;  // a block: 2 * THREADS instances

// The band of both instances: B and E = B + 1.  row() takes it from row
// i-1 to row i, in place.  Per pair of cells: the xor (zero where the
// bytes match), B + (xor != 0) as min(xor + B, E), the min of it, the up
// neighbour's E and the left one's, and E.
//
// The values run unclamped: the reference clamps to SAT after every
// step, but min(min(x, SAT) + 1, SAT) = min(x + 1, SAT) and min commutes
// with min(., SAT), so min(B[d], SAT) is the reference's cell at every
// row and only the two outputs need the clamp; a value grows by at most
// one a row, so xor + B stays far below 2^15 at any read length the
// wrappers take (ops.check_wf_geometry).  For the same reason an
// operand >= SAT can be left out of a min: off-band up, and the left
// neighbour of d = 0.  Nor do rows 1..ETH need the reference's column
// masks: a cell left of column 0 (j < 0) starts at SAT and takes the min
// of operands that are all >= SAT, and the diagonal of a cell on column
// 0 comes from one of them, so every row runs the same code.
template <int ETH>
struct LinearBand : wf::DistBand {
  static constexpr int BAND = 2 * ETH + 1;
  uint32_t V[BAND], E[BAND];  // B and B + 1

  __device__ __forceinline__ LinearBand() {
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      V[d] = (d < ETH ? ETH + 1 : d - ETH) * ONE;
      E[d] = V[d] + ONE;
    }
  }

  template <bool MASK, class Sink>
  __device__ __forceinline__ void row(const uint32_t (&ch)[BAND],
                                      uint32_t c1, int, Sink&) {
    uint32_t left = 0;  // E of the cell to the left, this row
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const uint32_t diag = __viaddmin_s16x2(ch[d] ^ c1, V[d], E[d]);
      uint32_t v = diag;
      if (d > 0 && d + 1 < BAND)
        v = __vimin3_s16x2(diag, E[d + 1], left);
      else if (d + 1 < BAND)
        v = __vmins2(diag, E[d + 1]);
      else if (d > 0)
        v = __vmins2(diag, left);
      V[d] = v;
      E[d] = left = v + ONE;
    }
  }
};

}  // namespace

template <int ETH>
__global__ void __launch_bounds__(THREADS)
    linear_wf_kernel(const uint8_t* __restrict__ s1,
                     const uint8_t* __restrict__ s2,
                     int32_t* __restrict__ out, int R, int n) {
  LinearBand<ETH> band;
  wf::pair_distances<ETH, THREADS>(s1, s2, out, R, n, ETH + 1, band);
}

extern "C" int linear_wf_launch(const void* s1, const void* s2, void* out,
                                int R, int n, int eth, void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  // one thread a pair of instances
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<linear_wf_kernel<decltype(e)::value>>(
        (R + 1) / 2, THREADS, 0, stream, a, b, o, R, n);
  });
}
