// Banded affine (Gotoh) Wagner-Fischer for Hopper: distances only, or
// distances plus the packed direction planes.
//
// Replaces two Pallas kernels of src/repro/kernels/affine_wf.py that share
// _row_step and _init_bands:
//   affine_wf_dist_pallas (_kernel_dist): D[n][n] and the min of the last
//     band row, three bands D/M1/M2, no direction planes;
//   affine_wf_pallas (_kernel): the same distances, and one packed
//     direction byte dD | dM1<<2 | dM2<<3 per band cell written out as an
//     (n * (2*ETH+1), R) uint8 plane; cells left of column 0 hold 0.
//
// What bounds them on the H100: integer operations.  The recurrence needs
// 14 int32 ops per band cell (M1 and M2: two adds and two mins each; D:
// the sub add, three mins, the match compare and its select) and the
// direction byte 8 more, n * (2*ETH+1) cells per instance.  Against that,
// an instance reads 2n + 2*ETH bytes and writes 8, plus n * (2*ETH+1)
// direction bytes with the planes: 1,950 at n=150, ETH=6.  At the H100
// SXM's published peaks (16.7 int32 Tops/s, 3.35 TB/s) the operations
// still take about four times as long as the bytes.
//
// Design: one thread per instance, the bands in registers (ETH is a
// template parameter and the band loops unroll), rows staged through
// shared memory with coalesced loads.  The in-row M2/D dependence is a
// chain across the band; unrolled over the compile-time band it is
// straight-line register code.  The direction plane keeps the Pallas
// kernel's (cell, instance) layout: thread r writes byte (cell, r) at
// cell * R + r, so a warp's 32 stores of one cell land in 32 neighbouring
// bytes.  The wrapper hands the plane out as an (R, n, band) view of it,
// with no transpose.
#include "wf_common.cuh"

template <int ETH, bool EMIT>
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
  wf::affine_band<ETH, EMIT>(a_sm + (long long)t * n, b_sm + (long long)t * W,
                             n, sat, EMIT ? dirs + r : nullptr, R, de, dm);
  out[r] = de;
  out[R + r] = dm;
}

template <bool EMIT>
static int launch_eth(int R, int n, int eth, int sat, int threads, int smem,
                      void* stream, const uint8_t* a, const uint8_t* b,
                      int32_t* o, uint8_t* d) {
  return wf::by_eth(eth, [&](auto e) {
    return wf::launch<affine_wf_kernel<decltype(e)::value, EMIT>>(
        R, threads, smem, stream, a, b, o, d, R, n, sat);
  });
}

extern "C" int affine_wf_dist_launch(const void* s1, const void* s2, void* out,
                                     int R, int n, int eth, int sat,
                                     int threads, int smem, void* stream) {
  return launch_eth<false>(R, n, eth, sat, threads, smem, stream,
                           (const uint8_t*)s1, (const uint8_t*)s2,
                           (int32_t*)out, nullptr);
}

extern "C" int affine_wf_launch(const void* s1, const void* s2, void* out,
                                void* dirs, int R, int n, int eth, int sat,
                                int threads, int smem, void* stream) {
  return launch_eth<true>(R, n, eth, sat, threads, smem, stream,
                          (const uint8_t*)s1, (const uint8_t*)s2,
                          (int32_t*)out, (uint8_t*)dirs);
}
