// Fused banded affine WF + traceback for Hopper.
//
// Replaces the Pallas kernel affine_traceback_pallas
// (src/repro/kernels/traceback.py, _kernel): the affine forward pass
// writes one packed direction byte per band cell (dD | dM1<<2 | dM2<<3),
// then a traceback walk reads them back and emits END-aligned op rows.
// The directions live in shared memory and never in device memory, which
// is the point of the TPU kernel.  Each thread runs one instance and then
// walks its own directions with the fused traceback_step logic of
// repro.core.affine_wf: op k goes to element (max_ops-1-k) % max_ops of
// its row, so on truncation later ops overwrite earlier ones as in the
// reference, and the TPU kernel's lockstep across lanes is not needed.
//
// What bounds it on the H100: its instructions at one warp a scheduler.
// The main path launches it on 16,384 instances (n=150, ETH=6), one a
// thread: 4 warps an SM, one a scheduler.  The recurrence's operations
// would take 0.044 ms at the int32 rate; the kernel runs about 300 SASS
// instructions a row and 100 a walk step, which at one instruction a
// clock per scheduler take about 0.066 ms, and the latency that no other
// warp hides adds about a quarter to that (chip_smoke.py phase_sass;
// PERF.md).
//
// Design, step by step, each timed by chip_smoke.py phase 3 at 16,384
// instances beside its parent on an H100 80GB HBM3 at 700 W (PERF.md;
// one direction byte a cell and blocks of 64 took 0.38 ms):
//   A. directions packed 8 cells to a 32-bit word, laid out
//      [row][word][thread] (a row's stores and the walk's reads fall in 32
//      banks): 1,200 B an instance, not 1,950, so blocks of 128 and one
//      wave: 0.27 ms;
//   B. reads and windows staged in shared memory 32 columns at a time:
//      0.31 ms, slower, and taken out again in G;
//   C. the block fills its op rows with OP_NONE in 16-byte stores, where
//      each thread wrote its own row in strided 4-byte stores: 0.23 ms;
//   D. rows past ETH without the column masks: 0.22-0.23 ms;
//   E. the direction bits in arithmetic: a nested select compiled to a
//      branch a cell, which kept the scheduler from overlapping cells; and
//      __launch_bounds__(128, 1), or ptxas capped the registers at 80 and
//      spilled: 0.17 ms;
//   F. the walk gathers its ops into 16-byte quads of the op tensor, where
//      each step's 4-byte store took a sector of its own: 0.133 ms;
//   G. reads and windows loaded from device memory by each thread, not
//      staged: 0.088 ms;
//   H. the steady rows unrolled by four: 0.083 ms.
// Two lanes an instance (lane 1 a row behind, two shuffles a row: 8 warps
// an SM) took 0.135 ms against F's 0.133: its 406 instructions an
// instance-row against 309 ate the second warp's gain.
#include "wf_common.cuh"

namespace {

// Row i of the forward pass: the window slides by next_ch, the row's
// direction words go to my[((i-1) * WORDS + x) * T].
template <int ETH, bool MASK>
__device__ __forceinline__ void dir_row(int (&D)[2 * ETH + 1],
                                        int (&M1)[2 * ETH + 1],
                                        int (&ch)[2 * ETH + 1], int c1,
                                        int next_ch, int i, int sat,
                                        uint32_t* my, int T) {
  constexpr int WORDS = wf::dir_words<ETH>();
#pragma unroll
  for (int d = 0; d < 2 * ETH; ++d) ch[d] = ch[d + 1];
  ch[2 * ETH] = next_ch;
  uint32_t w[WORDS];
  wf::affine_row<ETH, MASK>(D, M1, ch, c1, i, sat, w);
#pragma unroll
  for (int x = 0; x < WORDS; ++x) my[((i - 1) * WORDS + x) * T] = w[x];
}

// Rows past ETH, unrolled by UNROLL: a row's cell d waits only for cells
// d and d+1 of the row before, so the unrolled rows overlap.
constexpr int UNROLL = 4;

// The forward pass of one instance: a (n bytes) against b (n + 2*ETH),
// read from device memory, where each thread's loads are its own and not
// in the chain of a row; D ends as row n, the row's direction words go
// to my[((i-1) * WORDS + x) * T].
template <int ETH>
__device__ __forceinline__ void forward(const uint8_t* __restrict__ a,
                                        const uint8_t* __restrict__ b, int n,
                                        int sat, int (&D)[2 * ETH + 1],
                                        uint32_t* my, int T) {
  constexpr int BAND = 2 * ETH + 1;
  int M1[BAND], ch[BAND];
  wf::affine_init<ETH>(D, M1, sat);
#pragma unroll
  for (int d = 0; d + 1 < BAND; ++d) ch[d + 1] = b[d];
  int i = 1;
  for (; i <= min(ETH, n); ++i)  // rows 1..ETH reach left of column 0
    dir_row<ETH, true>(D, M1, ch, a[i - 1], b[i - 1 + 2 * ETH], i, sat, my,
                       T);
  for (; i + UNROLL - 1 <= n; i += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      dir_row<ETH, false>(D, M1, ch, a[i + u - 1], b[i + u - 1 + 2 * ETH],
                          i + u, sat, my, T);
  }
  for (; i <= n; ++i)
    dir_row<ETH, false>(D, M1, ch, a[i - 1], b[i - 1 + 2 * ETH], i, sat, my,
                        T);
}

// OP_NONE into p[0, count) with the block's threads, 16 bytes a store
// where it can: p is 16-byte aligned.
__device__ __forceinline__ void fill_none(int32_t* __restrict__ p,
                                          long long count) {
  const int4 none = make_int4(wf::OP_NONE, wf::OP_NONE, wf::OP_NONE,
                              wf::OP_NONE);
  const long long n4 = count / 4;
  for (long long x = threadIdx.x; x < n4; x += blockDim.x)
    reinterpret_cast<int4*>(p)[x] = none;
  for (long long x = 4 * n4 + threadIdx.x; x < count; x += blockDim.x)
    p[x] = wf::OP_NONE;
}

// The elements of a 16-byte quad q of the op tensor that `have` marks
// (bit s: q[s] = vs): one store when all four are.
__device__ __forceinline__ void flush_quad(int32_t* q, uint32_t have, int v0,
                                           int v1, int v2, int v3) {
  if (have == 0xF) {
    *reinterpret_cast<int4*>(q) = make_int4(v0, v1, v2, v3);
    return;
  }
  if (have & 1) q[0] = v0;
  if (have & 2) q[1] = v1;
  if (have & 4) q[2] = v2;
  if (have & 8) q[3] = v3;
}

}  // namespace

template <int ETH>
__global__ void __launch_bounds__(128, 1)
    affine_traceback_kernel(const uint8_t* __restrict__ s1,
                            const uint8_t* __restrict__ s2,
                            int32_t* __restrict__ dists,
                            int32_t* __restrict__ ops,
                            int32_t* __restrict__ cnt, int R, int n, int sat,
                            int max_ops) {
  constexpr int BAND = 2 * ETH + 1;
  constexpr int WORDS = wf::dir_words<ETH>();
  extern __shared__ __align__(16) uint32_t tb_smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int W = n + 2 * ETH;
  const long long r0 = (long long)blockIdx.x * T;
  const int rows = (int)min((long long)T, (long long)R - r0);
  uint32_t* my = tb_smem + t;  // word x of row q: my[(q * WORDS + x) * T]
  // The block's op rows are one span, r0 * max_ops int32s from the start
  // (a multiple of 128 bytes): filled with OP_NONE here, in stores that
  // coalesce, before the walks write their ops into it after a barrier.
  fill_none(ops + r0 * max_ops, (long long)rows * max_ops);
  int D[BAND];
  const int tc = min(t, rows - 1);  // threads past `rows` compute its last
  forward<ETH>(s1 + (r0 + tc) * n, s2 + (r0 + tc) * W, n, sat, D, my, T);
  __syncthreads();  // the fill is in place before any walk writes
  if (t >= rows) return;  // no barrier follows
  const long long r = r0 + t;
  int mn = D[0];
#pragma unroll
  for (int d = 1; d < BAND; ++d) mn = min(mn, D[d]);
  dists[r] = D[ETH];
  dists[R + r] = mn;

  // Op k goes to element r * max_ops + (max_ops - 1 - k) % max_ops of
  // the op tensor.  The positions descend, so the walk gathers the ops
  // that fall in one 16-byte quad of the tensor (its base is 16-byte
  // aligned) and writes the quad in one store when it holds 4 of them,
  // element by element at the row's ends and where the walk wraps.
  const long long row0 = r * max_ops;
  int pos = max_ops - 1;
  int32_t* quad = ops + ((row0 + pos) & ~3LL);  // the quad gathered
  int slot = (int)((row0 + pos) & 3);           // where op k goes in it
  int v0 = 0, v1 = 0, v2 = 0, v3 = 0;
  uint32_t have = 0;  // bit s: element s of the quad gathered
  const int ncell = n * BAND;
  int i = n, d = ETH, st = 0, k = 0;
  while (true) {
    const int j = i + d - ETH;
    if (!(i > 0 || j > 0)) break;
    // the cell of (i-1, d) in the reference's flat (n * band) numbering,
    // clamped as there: a walk that leaves the band where the values
    // saturate reads a neighbouring row's cell, as the reference does
    const int cell = min(max(max(i - 1, 0) * BAND + d, 0), ncell - 1);
    const int q = cell / BAND, dc = cell - q * BAND;
    const uint32_t nib = my[(q * WORDS + dc / 8) * T] >> (4 * (dc % 8));
    const int dd = nib & 3, dm1 = (nib >> 2) & 1, dm2 = (nib >> 3) & 1;
    const bool top = i == 0;
    const bool left = j == 0 && !top;
    const bool in_d = st == 0 && !top && !left;
    const bool go_m1 = (st == 1 && !top && !left) || (in_d && dd == 2);
    const bool go_m2 = (st == 2 && !top && !left) || (in_d && dd == 3);
    const bool diag = in_d && dd <= 1;
    const bool vert = left || go_m1;
    const int op = diag ? (dd == 0 ? wf::OP_MATCH : wf::OP_SUB)
                        : (vert ? wf::OP_INS : wf::OP_DEL);
    const int ni = (diag || vert) ? i - 1 : i;
    const int nd = vert ? d + 1 : ((top || go_m2) ? d - 1 : d);
    st = go_m1 ? (dm1 == 1 ? 0 : 1) : (go_m2 ? (dm2 == 1 ? 0 : 2) : st);
    v0 = slot == 0 ? op : v0;
    v1 = slot == 1 ? op : v1;
    v2 = slot == 2 ? op : v2;
    v3 = slot == 3 ? op : v3;
    have |= 1u << slot;
    if (slot == 0 || pos == 0) {  // the next op goes to another quad
      flush_quad(quad, have, v0, v1, v2, v3);
      have = 0;
    }
    if (pos == 0) {  // the walk wraps: later ops overwrite earlier ones
      pos = max_ops - 1;
      quad = ops + ((row0 + pos) & ~3LL);
      slot = (int)((row0 + pos) & 3);
    } else {
      --pos;
      quad = slot == 0 ? quad - 4 : quad;
      slot = (slot + 3) & 3;
    }
    i = ni;
    d = nd;
    ++k;
  }
  if (have) flush_quad(quad, have, v0, v1, v2, v3);
  cnt[r] = k;
}

extern "C" int affine_traceback_launch(const void* s1, const void* s2,
                                       void* dists, void* ops, void* cnt,
                                       int R, int n, int eth, int sat,
                                       int max_ops, int threads, int smem,
                                       void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* dd = (int32_t*)dists;
  auto* o = (int32_t*)ops;
  auto* c = (int32_t*)cnt;
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<affine_traceback_kernel<decltype(e)::value>>(
        R, threads, smem, stream, a, b, dd, o, c, R, n, sat, max_ops);
  });
}
