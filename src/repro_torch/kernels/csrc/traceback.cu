// Fused banded affine WF + traceback for Hopper.
//
// Replaces the Pallas kernel affine_traceback_pallas
// (src/repro/kernels/traceback.py, _kernel): the affine forward pass
// writes one packed direction byte per band cell (dD | dM1<<2 | dM2<<3),
// then a traceback walk reads them back and emits END-aligned op rows.
//
// What bounds it on the H100: integer operations in the forward pass,
// and then the shared memory that holds the direction bytes: n*(2*ETH+1)
// bytes per instance (1,950 at n=150, ETH=6) cap a block at 64
// instances, so few threads run on each SM.  Each thread also writes its
// own (max_ops,) op row, rows max_ops*4 bytes apart, so neither the
// OP_NONE fill nor the walk's stores coalesce across a warp.  It runs
// once per mapped read, not per candidate, so it is the smallest of the
// three kernels.
//
// Design: the direction bytes live in dynamic shared memory laid out
// [cell][thread], so they never touch device memory (the point of the
// TPU kernel).  Each thread then walks its own directions with the fused
// traceback_step logic of repro.core.affine_wf and writes its own
// (max_ops,) op row: op k goes to row (max_ops-1-k) % max_ops, so on
// truncation later ops overwrite earlier ones as in the reference.  The
// TPU kernel's lockstep across lanes is not needed: every walk's k-th op
// lands in the same place either way.
#include "wf_common.cuh"

template <int ETH>
__global__ void affine_traceback_kernel(const uint8_t* __restrict__ s1,
                                        const uint8_t* __restrict__ s2,
                                        int32_t* __restrict__ dists,
                                        int32_t* __restrict__ ops,
                                        int32_t* __restrict__ cnt, int R,
                                        int n, int sat, int max_ops) {
  constexpr int BAND = 2 * ETH + 1;
  extern __shared__ uint8_t dirs_sm[];
  const int T = blockDim.x;
  const long long r = (long long)blockIdx.x * T + threadIdx.x;
  if (r >= R) return;
  const int W = n + 2 * ETH;
  uint8_t* my = dirs_sm + threadIdx.x;  // cell c of this thread: my[c * T]
  int de, dm;
  wf::affine_band<ETH, true>(s1 + r * n, s2 + r * W, n, sat, my, T, de, dm);
  dists[r] = de;
  dists[R + r] = dm;

  int32_t* orow = ops + r * max_ops;
  for (int q = 0; q < max_ops; ++q) orow[q] = wf::OP_NONE;
  const int ncell = n * BAND;
  int i = n, d = ETH, st = 0, k = 0;
  while (true) {
    const int j = i + d - ETH;
    if (!(i > 0 || j > 0)) break;
    // the walk never leaves [0, ncell); the clamp only guards memory
    const int cell = min(max(max(i - 1, 0) * BAND + d, 0), ncell - 1);
    const int byte = my[cell * T];
    const int dd = byte & 3, dm1 = (byte >> 2) & 1, dm2 = (byte >> 3) & 1;
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
    int row = (max_ops - 1 - k) % max_ops;
    if (row < 0) row += max_ops;
    orow[row] = op;
    i = ni;
    d = nd;
    ++k;
  }
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
