// Shared pieces of the banded Wagner-Fischer kernels for Hopper (sm_90a).
//
// The two distance kernels (linear_wf.cu, affine_wf.cu's
// affine_dist_kernel) and the padded affine kernel (affine_wf.cu's
// affine_wf_kernel, which also writes the direction planes) run two WF
// instances a thread, one in each 16-bit half of a register, on one body
// (pair_distances below); the traceback runs one instance a thread on
// int32 lanes (affine_row).  An instance is a read of n bases against a
// reference window of n + 2*ETH bases.  The 2*ETH+1 band cells of the
// current row live in registers: ETH is a template parameter, every
// loop over the band is unrolled, so the arrays below never touch local
// memory.
//
// affine_row reproduces the int8 arithmetic of the reference
// (repro.core.affine_wf._banded_affine_impl) in int32 registers.  No
// intermediate value exceeds sat + 42 <= 127 (the wrappers reject sat >
// 85), so int32 and int8 give the same bits.  The distance kernels run
// their values unclamped and clamp only their outputs; the padded
// kernel keeps the clamps and scales its values by 4 (each kernel's
// header says why that gives the same bits).
#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <utility>
#include <cuda_runtime.h>

namespace wf {

constexpr int OP_MATCH = 0, OP_SUB = 1, OP_INS = 2, OP_DEL = 3, OP_NONE = 4;

// Every kernel is compiled for each band half-width 0..MAX_ETH (the
// wrappers' ops.SUPPORTED_ETH).  At ETH=12 the affine pass keeps five
// 25-cell arrays in registers.
constexpr int MAX_ETH = 12;

template <typename F, int... E>
int by_eth(int eth, F&& f, std::integer_sequence<int, E...>) {
  int rc = (int)cudaErrorInvalidValue;
  (void)((eth == E && ((rc = f(std::integral_constant<int, E>{})), true)) ||
         ...);
  return rc;
}

// f(std::integral_constant<int, eth>{}) for eth in [0, MAX_ETH], so that f
// can launch the instance of that eth; cudaErrorInvalidValue for any other.
template <typename F>
int by_eth(int eth, F&& f) {
  return by_eth(eth, f, std::make_integer_sequence<int, MAX_ETH + 1>{});
}

// Copy columns [col0, col0 + ncols) of a block's first `rows` rows (row t
// at src + t * stride, t < ROWS) into dst[c * pitch + t], ncols <= 32:
// the layout in which each thread reads its own rows a column at a time,
// a warp on neighbouring bytes.  Each warp copies 32 neighbouring bytes
// of a row, so the loads coalesce; with pitch / 4 odd its stores fall in
// 32 banks.  THREADS, the block's size, is a multiple of 32.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_cols(uint8_t* dst, int pitch,
                                           const uint8_t* __restrict__ src,
                                           int stride, int col0, int ncols,
                                           int rows) {
  constexpr int STEP = THREADS / 32;  // rows the block's warps take at once
  const int c = threadIdx.x % 32;
  if (c >= ncols) return;
  const int t0 = threadIdx.x / 32;
  const uint8_t* s = src + col0 + c;
  uint8_t* d = dst + c * pitch + t0;
  if (rows == ROWS) {
    // a pointer stepped by a constant: one IMAD.WIDE a byte
    const uint8_t* p = s + (long long)t0 * stride;
    const long long step = (long long)STEP * stride;
#pragma unroll 16
    for (int k = 0; k < ROWS / STEP; ++k, p += step) d[k * STEP] = *p;
  } else {
    // rows past `rows` copy the last one: no branch in the loop
#pragma unroll 16
    for (int k = 0; k < ROWS / STEP; ++k)
      d[k * STEP] = s[min(t0 + k * STEP, rows - 1) * stride];
  }
}

// Two instances a thread, one in each 16-bit half of a register, on
// Hopper's DPX instructions for 16x2 lanes.
constexpr uint32_t ONE = 0x00010001u;  // 1 in both halves
constexpr int TILE = 32;    // columns a block stages at a time
constexpr int UNROLL = 4;   // rows of a tile unrolled

// The bytes of a thread's two instances at column c of a staged tile of
// PITCH bytes a column (two neighbouring bytes), one in the low byte of
// each half.
template <int PITCH>
__device__ __forceinline__ uint32_t pair_at(const uint8_t* p, int c) {
  return __byte_perm(*(const uint16_t*)(p + c * PITCH), 0, 0x4140);
}

template <int ETH>
__device__ __forceinline__ void slide(uint32_t (&ch)[2 * ETH + 1],
                                      uint32_t next) {
#pragma unroll
  for (int d = 0; d < 2 * ETH; ++d) ch[d] = ch[d + 1];
  ch[2 * ETH] = next;
}

// What a band of the distance kernels shares: no masked rows, values
// unscaled, bytes as they are, no direction bytes.
struct DistBand {
  static constexpr bool MASKED = false;  // rows 1..ETH need no masks
  static constexpr int SHIFT = 0;        // values scaled by 2^SHIFT
  __device__ __forceinline__ static uint32_t chr(uint32_t pair) {
    return pair;
  }
};

// A sink for direction bytes that keeps none (the distance kernels).
struct NoSink {
  __device__ __forceinline__ void operator()(int, int, uint32_t) const {}
};

// Row i of a staged tile (column c of a and b holds the read's and the
// window's bytes of the row that column ends): the window slides and the
// band takes the row; MASK: the row reaches left of column 0.
template <int ETH, int PITCH, bool MASK, class Band, class Sink>
__device__ __forceinline__ void tile_row(Band& band,
                                         uint32_t (&ch)[2 * ETH + 1],
                                         const uint8_t* a, const uint8_t* b,
                                         int c, int i, Sink& sink) {
  slide<ETH>(ch, Band::chr(pair_at<PITCH>(b, c)));
  band.template row<MASK>(ch, Band::chr(pair_at<PITCH>(a, c)), i, sink);
}

// The rows of a staged tile whose first column is row i0 + 1.  A band
// with MASKED runs rows 1..ETH (which reach left of column 0) masked;
// every other row runs unmasked, unrolled by UNROLL rows, so that the
// window's slide is register renaming but at the loop's back edge.
template <int ETH, int PITCH, class Band, class Sink>
__device__ __forceinline__ void tile_rows(Band& band,
                                          uint32_t (&ch)[2 * ETH + 1],
                                          const uint8_t* a, const uint8_t* b,
                                          int cols, int i0, Sink& sink) {
  int c = 0;
  if (Band::MASKED)
    for (; c < cols && i0 + c < ETH; ++c)
      tile_row<ETH, PITCH, true>(band, ch, a, b, c, i0 + c + 1, sink);
  for (; c + UNROLL <= cols; c += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      tile_row<ETH, PITCH, false>(band, ch, a, b, c + u, i0 + c + u + 1,
                                  sink);
  }
  for (; c < cols; ++c)
    tile_row<ETH, PITCH, false>(band, ch, a, b, c, i0 + c + 1, sink);
}

// The body of the two distance kernels and of the padded affine kernel:
// a block of THREADS threads runs 2 * THREADS instances, thread t the
// block's instances 2t and 2t+1, and writes out[r] = min(V[ETH], sat)
// and out[R + r] = min over the band of min(V[d], sat) of the last row,
// V scaled by 2^Band::SHIFT.  Band holds the band's values V (and
// whatever else its recurrence keeps) and provides row<MASK>(ch, c1, i,
// sink), which takes the band from row i-1 to row i given ch[d] =
// b[i-1+d] and c1 = a[i-1], each byte in the low byte of its half as
// Band::chr gives it, and hands the row's direction bytes, if any, to
// sink; it starts as row 0.
//
// The block stages its reads and windows TILE columns at a time into a
// [column][instance] layout (stage_cols), where each thread reads its
// two instances' bytes of a column in one 16-bit load.  Every instance
// of a launch has the same n, so the block's threads advance together.
template <int ETH, int THREADS, class Band, class Sink = NoSink>
__device__ __forceinline__ void pair_distances(
    const uint8_t* __restrict__ s1, const uint8_t* __restrict__ s2,
    int32_t* __restrict__ out, int R, int n, int sat, Band& band,
    Sink sink = Sink()) {
  constexpr int BAND = 2 * ETH + 1;
  constexpr int ROWS = 2 * THREADS;
  constexpr int PITCH = ROWS + 4;  // PITCH / 4 odd: stores in 32 banks
  __shared__ __align__(4) uint8_t a_t[TILE * PITCH];
  __shared__ __align__(4) uint8_t b_t[TILE * PITCH];
  const int W = n + 2 * ETH;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, (long long)R - r0);
  const uint8_t* a_src = s1 + r0 * n;
  const uint8_t* b_src = s2 + r0 * W;
  const int t2 = 2 * threadIdx.x;  // the thread's first instance

  // the window's first 2*ETH bytes, which row 1 finds in place
  stage_cols<ROWS, THREADS>(b_t, PITCH, b_src, W, 0, 2 * ETH, rows);
  __syncthreads();
  uint32_t ch[BAND];
#pragma unroll
  for (int d = 0; d + 1 < BAND; ++d)
    ch[d + 1] = Band::chr(pair_at<PITCH>(b_t + t2, d));

  // tile k holds the read's columns [32k, 32k + 32) and the window's
  // columns 2*ETH further on: rows 32k + 1 .. 32k + 32
  for (int c0 = 0; c0 < n; c0 += TILE) {
    const int cols = min(TILE, n - c0);
    __syncthreads();  // the previous tile is read
    stage_cols<ROWS, THREADS>(a_t, PITCH, a_src, n, c0, cols, rows);
    stage_cols<ROWS, THREADS>(b_t, PITCH, b_src, W, c0 + 2 * ETH, cols,
                              rows);
    __syncthreads();
    tile_rows<ETH, PITCH>(band, ch, a_t + t2, b_t + t2, cols, c0, sink);
  }
  constexpr int SH = Band::SHIFT;
  const uint32_t s = (uint32_t)(sat << SH) * ONE;
  uint32_t mn = band.V[0];
#pragma unroll
  for (int d = 1; d < BAND; ++d) mn = __vmins2(mn, band.V[d]);
  const uint32_t end = __vmins2(band.V[ETH], s);
  mn = __vmins2(mn, s);
  const long long r = r0 + t2;
  if (t2 < rows) {
    out[r] = (int)(end & 0xffff) >> SH;
    out[R + r] = (int)(mn & 0xffff) >> SH;
  }
  if (t2 + 1 < rows) {
    out[r + 1] = (int)(end >> 16) >> SH;
    out[R + r + 1] = (int)(mn >> 16) >> SH;
  }
}

// The traceback kernel's band pass: the reference's affine recurrence
// (repro.core.affine_wf._row_step) a row at a time on int32 lanes, one
// instance a thread, with the direction bytes (4 meaningful bits each)
// packed 8 to a 32-bit word.
template <int ETH>
__host__ __device__ constexpr int dir_words() {
  return (2 * ETH + 8) / 8;  // words a row: ceil((2*ETH+1) / 8)
}

// Row 0 of the band.
template <int ETH>
__device__ __forceinline__ void affine_init(int (&D)[2 * ETH + 1],
                                            int (&M1)[2 * ETH + 1],
                                            int sat) {
#pragma unroll
  for (int d = 0; d < 2 * ETH + 1; ++d) {
    const int j0 = d - ETH;
    D[d] = j0 < 0 ? sat : min(j0 == 0 ? 0 : 1 + j0, sat);
    M1[d] = sat;
  }
}

// Row i of the reference's recurrence, in place: D and M1 hold row i-1
// on entry and row i on exit; ch[d] = b[i-1+d], c1 = a[i-1].  Cell d's
// direction byte goes to bits [4*(d%8), 4*(d%8)+4) of words[d/8].  MASK:
// the row reaches left of column 0 (i <= ETH) and needs the reference's
// column masks; a row past ETH computes the same bits without them.
// D's clamp to sat is left out: m1n and m2 are clamped, so their min
// with sub is too.
template <int ETH, bool MASK>
__device__ __forceinline__ void affine_row(int (&D)[2 * ETH + 1],
                                           int (&M1)[2 * ETH + 1],
                                           const int (&ch)[2 * ETH + 1],
                                           int c1, int i, int sat,
                                           uint32_t (&words)[dir_words<ETH>()]) {
  constexpr int BAND = 2 * ETH + 1;
  const int big = sat + 40;
  int m1n[BAND];
  uint32_t dm1[BAND];
#pragma unroll
  for (int d = 0; d < BAND; ++d) {
    const int e = (d + 1 < BAND ? M1[d + 1] : big) + 1;  // raw
    const int o = (d + 1 < BAND ? D[d + 1] : big) + 2;   // raw
    m1n[d] = (MASK && i + d - ETH < 0) ? sat : min(min(e, o), sat);
    dm1[d] = o < e;
  }
#pragma unroll
  for (int w = 0; w < dir_words<ETH>(); ++w) words[w] = 0;
  int dl = big, ml = big;
#pragma unroll
  for (int d = 0; d < BAND; ++d) {
    const int jj = i + d - ETH;
    const int m2e = ml + 1, m2o = dl + 2;  // raw
    // min(ml + 1, sat) does not wait for dl
    const int m2 = (MASK && jj <= 0) ? sat : min(min(m2e, sat), m2o);
    const int dg = D[d];
    const int sub = dg + 1;
    const int dmin = min(min(sub, m1n[d]), m2);
    const bool mt = c1 == ch[d];
    int dval = mt ? dg : dmin;
    // dD (0 match, 1 sub, 2 enter M1, 3 enter M2) in bit arithmetic: a
    // nested select here compiles to a branch a cell, and the branches
    // keep the scheduler from overlapping cells and rows
    const uint32_t ns = dmin != sub, nm = dmin != m1n[d];
    uint32_t dd = (1 + ns + (ns & nm)) & (mt ? 0u : 3u);
    if (MASK) {
      dval = jj == 0 ? m1n[d] : (jj < 0 ? sat : dval);
      dd = jj == 0 ? 2u : dd;
    }
    uint32_t nib = dd | (dm1[d] << 2) | ((uint32_t)(m2o < m2e) << 3);
    if (MASK) nib = jj < 0 ? 0u : nib;
    words[d / 8] |= nib << (4 * (d % 8));
    D[d] = dval;
    dl = dval;
    ml = m2;
  }
#pragma unroll
  for (int d = 0; d < BAND; ++d) M1[d] = m1n[d];
}

// Launch on the caller's current device and stream, and report the launch
// status: a launch refused for its shared memory never runs, and only
// cudaGetLastError tells.  Above the default 48 KB a kernel needs its
// dynamic shared memory limit raised; that is done once per kernel
// instance and device, when a launch first asks for more than the limit
// set so far, rather than on every launch.
constexpr int kMaxDevices = 64;
constexpr int kDefaultSmem = 48 * 1024;

template <auto Kernel, typename... Args>
int launch(int R, int threads, int smem, void* stream, Args... args) {
  static int smem_set[kMaxDevices] = {};
  static std::mutex mu;
  if (smem > kDefaultSmem) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(mu);
    if (smem > smem_set[device]) {
      e = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      smem_set[device] = smem;
    }
  }
  const int blocks = (R + threads - 1) / threads;
  Kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace wf
