// Distance-only banded affine (Gotoh) Wagner-Fischer for Hopper.
//
// Replaces the Pallas kernel affine_wf_dist_pallas
// (src/repro/kernels/affine_wf.py, _kernel_dist with _row_step and
// _init_bands): D[n][n] and the min of the last band row, three bands
// D/M1/M2, no direction planes.
//
// What bounds it on the H100: integer operations.  The recurrence needs
// 14 int32 ops per band cell (M1 and M2: two adds and two mins each; D:
// the sub add, three mins, the match compare and its select),
// n * (2*ETH+1) cells per instance against 320 bytes in and out.
//
// Design: the linear kernel's layout (one thread per instance, bands in
// registers, rows staged through shared memory) with three bands.  The
// in-row M2/D dependence is a chain across the band; unrolled over the
// compile-time band it is straight-line register code, one cell after
// the other, with no shared memory or synchronisation inside a row.
#include "wf_common.cuh"

template <int ETH>
__global__ void affine_wf_dist_kernel(const uint8_t* __restrict__ s1,
                                      const uint8_t* __restrict__ s2,
                                      int32_t* __restrict__ out, int R, int n,
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
  int de, dm;
  wf::affine_band<ETH, false>(a_sm + (long long)t * n, b_sm + (long long)t * W,
                              n, sat, nullptr, 0, de, dm);
  const long long r = r0 + t;
  out[r] = de;
  out[R + r] = dm;
}

extern "C" int affine_wf_dist_launch(const void* s1, const void* s2, void* out,
                                     int R, int n, int eth, int sat,
                                     int threads, int smem, void* stream) {
  auto* a = (const uint8_t*)s1;
  auto* b = (const uint8_t*)s2;
  auto* o = (int32_t*)out;
  switch (eth) {
    case 4: return wf::launch<affine_wf_dist_kernel<4>>(R, threads, smem, stream, a, b, o, R, n, sat);
    case 6: return wf::launch<affine_wf_dist_kernel<6>>(R, threads, smem, stream, a, b, o, R, n, sat);
    case 8: return wf::launch<affine_wf_dist_kernel<8>>(R, threads, smem, stream, a, b, o, R, n, sat);
    default: return (int)cudaErrorInvalidValue;
  }
}
