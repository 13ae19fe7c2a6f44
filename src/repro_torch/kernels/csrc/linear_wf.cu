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
//     the column masks of rows 1..ETH from every row (band_row says why):
//     93 instructions a row, 1.84 ms;
//   - rows unrolled by UNROLL, so that the window's slide is register
//     renaming: 65 a row, 1.63 ms;
//   - rows staged TILE columns at a time into a [column][instance] layout
//     (wf::stage_cols), not whole: 8,448 B of shared memory a block, not
//     39,936, 1.06 ms;
//   - two instances a thread on 16x2 DPX lanes: 0.57 ms;
//   - the staging loops without branches, then with a pointer stepped by
//     a constant for full blocks: 0.41 ms.
#include "wf_common.cuh"

namespace {

// Two instances a thread, one in each 16-bit half of a register, on
// Hopper's DPX instructions for 16x2 lanes.
constexpr uint32_t ONE = 0x00010001u;  // 1 in both halves

// One row i of the band of both instances, in place: B holds row i-1 on
// entry and row i on exit, E = B + 1; ch[d] = b[i-1+d] and c1 = a[i-1],
// each byte in the low byte of its half.  Per pair of cells: the xor
// (zero where the bytes match), B + (xor != 0) as min(xor + B, E), the
// min of it, the up neighbour's E and the left one's, and E.
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
__device__ __forceinline__ void band_row(uint32_t (&B)[2 * ETH + 1],
                                         uint32_t (&E)[2 * ETH + 1],
                                         const uint32_t (&ch)[2 * ETH + 1],
                                         uint32_t c1) {
  constexpr int BAND = 2 * ETH + 1;
  uint32_t left = 0;  // E of the cell to the left, this row
#pragma unroll
  for (int d = 0; d < BAND; ++d) {
    const uint32_t diag = __viaddmin_s16x2(ch[d] ^ c1, B[d], E[d]);
    uint32_t v = diag;
    if (d > 0 && d + 1 < BAND)
      v = __vimin3_s16x2(diag, E[d + 1], left);
    else if (d + 1 < BAND)
      v = __vmins2(diag, E[d + 1]);
    else if (d > 0)
      v = __vmins2(diag, left);
    B[d] = v;
    E[d] = left = v + ONE;
  }
}

template <int ETH>
__device__ __forceinline__ void slide(uint32_t (&ch)[2 * ETH + 1],
                                      uint32_t next) {
#pragma unroll
  for (int d = 0; d < 2 * ETH; ++d) ch[d] = ch[d + 1];
  ch[2 * ETH] = next;
}

constexpr int UNROLL = 4;
constexpr int THREADS = 128;            // a block: 2 * THREADS instances
constexpr int ROWS = 2 * THREADS;
constexpr int TILE = 32;                // columns a block stages at a time
constexpr int PITCH = ROWS + 4;         // bytes a staged column takes

// The bytes of a thread's two instances at column c of a staged tile
// (two neighbouring bytes), one in the low byte of each half.
__device__ __forceinline__ uint32_t pair_at(const uint8_t* p, int c) {
  return __byte_perm(*(const uint16_t*)(p + c * PITCH), 0, 0x4140);
}

// Rows of a staged tile: column c of a and b holds the read's and the
// window's bytes of the row that column ends.  Unrolled by UNROLL rows,
// so that the window's slide is register renaming but at the loop's
// back edge.
template <int ETH>
__device__ __forceinline__ void tile_rows(uint32_t (&B)[2 * ETH + 1],
                                          uint32_t (&E)[2 * ETH + 1],
                                          uint32_t (&ch)[2 * ETH + 1],
                                          const uint8_t* a, const uint8_t* b,
                                          int cols) {
  int c = 0;
  for (; c + UNROLL <= cols; c += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      slide<ETH>(ch, pair_at(b, c + u));
      band_row<ETH>(B, E, ch, pair_at(a, c + u));
    }
  }
  for (; c < cols; ++c) {
    slide<ETH>(ch, pair_at(b, c));
    band_row<ETH>(B, E, ch, pair_at(a, c));
  }
}

}  // namespace

template <int ETH>
__global__ void __launch_bounds__(THREADS)
    linear_wf_kernel(const uint8_t* __restrict__ s1,
                     const uint8_t* __restrict__ s2,
                     int32_t* __restrict__ out, int R, int n) {
  constexpr int BAND = 2 * ETH + 1;
  constexpr int SAT = ETH + 1;
  __shared__ __align__(4) uint8_t a_t[TILE * PITCH];
  __shared__ __align__(4) uint8_t b_t[TILE * PITCH];
  const int W = n + 2 * ETH;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, (long long)R - r0);
  const uint8_t* a_src = s1 + r0 * n;
  const uint8_t* b_src = s2 + r0 * W;
  const int t2 = 2 * threadIdx.x;  // the thread's first instance

  // the window's first 2*ETH bytes, which row 1 finds in place
  wf::stage_cols<ROWS, THREADS>(b_t, PITCH, b_src, W, 0, 2 * ETH, rows);
  __syncthreads();
  uint32_t B[BAND], E[BAND], ch[BAND];
#pragma unroll
  for (int d = 0; d < BAND; ++d) {
    B[d] = (d < ETH ? SAT : d - ETH) * ONE;
    E[d] = B[d] + ONE;
  }
#pragma unroll
  for (int d = 0; d + 1 < BAND; ++d) ch[d + 1] = pair_at(b_t + t2, d);

  // tile k holds the read's columns [32k, 32k + 32) and the window's
  // columns 2*ETH further on: rows 32k + 1 .. 32k + 32.  Every instance of
  // a launch has the same n, so the block's threads advance together.
  for (int c0 = 0; c0 < n; c0 += TILE) {
    const int cols = min(TILE, n - c0);
    __syncthreads();  // the previous tile is read
    wf::stage_cols<ROWS, THREADS>(a_t, PITCH, a_src, n, c0, cols, rows);
    wf::stage_cols<ROWS, THREADS>(b_t, PITCH, b_src, W, c0 + 2 * ETH, cols,
                                  rows);
    __syncthreads();
    tile_rows<ETH>(B, E, ch, a_t + t2, b_t + t2, cols);
  }
  uint32_t mn = B[0];
#pragma unroll
  for (int d = 1; d < BAND; ++d) mn = __vmins2(mn, B[d]);
  const uint32_t end = __vmins2(B[ETH], SAT * ONE);
  mn = __vmins2(mn, SAT * ONE);
  const long long r = r0 + t2;
  if (t2 < rows) {
    out[r] = (int)(end & 0xffff);
    out[R + r] = (int)(mn & 0xffff);
  }
  if (t2 + 1 < rows) {
    out[r + 1] = (int)(end >> 16);
    out[R + r + 1] = (int)(mn >> 16);
  }
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
