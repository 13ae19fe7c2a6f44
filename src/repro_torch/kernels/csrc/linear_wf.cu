// Banded linear Wagner-Fischer (paper Alg. 2) for Hopper.
//
// Replaces the Pallas kernel linear_wf_pallas
// (src/repro/kernels/linear_wf.py, body _kernel): D[n][n] and the min of
// the last band row for every (read, window) instance.
//
// What bounds it on the H100: integer operations.  The recurrence needs
// 7 int32 ops per band cell (the mismatch compare, diag+sub, up+1, left+1
// and three mins, saturation included), n * (2*ETH+1) cells per instance,
// against 312 input bytes and 8 output bytes: about 43 ops per byte at
// n=150, ETH=6, far above the ~5 int32 ops/byte at which 16.7 Tops/s
// meets 3.35 TB/s.  The kernel also runs the column masks of the first
// ETH rows on every row, which the bound does not count.
//
// Design: one thread per instance, the band in registers (ETH is a
// template parameter, the band loops unrolled), so the recurrence runs
// without any memory traffic; the window slides through a register
// array, one new byte per row.  A block first stages its rows into
// shared memory with coalesced loads, because a thread reading its own
// row from device memory would stride by n bytes across the warp.
#include "wf_common.cuh"

template <int ETH>
__global__ void linear_wf_kernel(const uint8_t* __restrict__ s1,
                                 const uint8_t* __restrict__ s2,
                                 int32_t* __restrict__ out, int R, int n) {
  constexpr int BAND = 2 * ETH + 1;
  constexpr int SAT = ETH + 1;
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
  const uint8_t* a = a_sm + (long long)t * n;
  const uint8_t* b = b_sm + (long long)t * W;

  int B[BAND], ch[BAND];
#pragma unroll
  for (int d = 0; d < BAND; ++d) B[d] = d < ETH ? SAT : min(d - ETH, SAT);
#pragma unroll
  for (int d = 0; d + 1 < BAND; ++d) ch[d + 1] = b[d];

  for (int i = 1; i <= n; ++i) {
#pragma unroll
    for (int d = 0; d + 1 < BAND; ++d) ch[d] = ch[d + 1];
    ch[BAND - 1] = b[i - 1 + BAND - 1];
    const int c1 = a[i - 1];
    int cand[BAND];
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const int j = i + d - ETH;
      const int diag = j >= 1 ? B[d] + (c1 != ch[d]) : SAT;
      const int up_src = d + 1 < BAND ? B[d + 1] : SAT;
      const int up = j >= 0 ? min(up_src + 1, SAT) : SAT;
      cand[d] = min(min(diag, up), SAT);
    }
    // left propagation: the (min, +1) running scan across the band
    int run = SAT;
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      run = min(cand[d], min(run + 1, SAT));
      B[d] = i + d - ETH >= 0 ? run : SAT;
    }
  }
  int mn = B[0];
#pragma unroll
  for (int d = 1; d < BAND; ++d) mn = min(mn, B[d]);
  const long long r = r0 + t;
  out[r] = B[ETH];
  out[R + r] = mn;
}

extern "C" int linear_wf_launch(const void* s1, const void* s2, void* out,
                                int R, int n, int eth, int threads, int smem,
                                void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<linear_wf_kernel<decltype(e)::value>>(
        R, threads, smem, stream, a, b, o, R, n);
  });
}
