// k-mer hashing + sliding-window minimizers for Hopper.
//
// Replaces the Pallas kernel minimizer_pallas
// (src/repro/kernels/minimizer.py, _kernel): for every read of L base
// codes, the 2-bit code of each k-mer (k shift-ors in uint32, a sentinel
// base spilling into its neighbour's field as there), its hash32, and for
// every window of w consecutive k-mers the smallest hash and the position
// of its leftmost occurrence.  Outputs are int64 (hash, position) rows of
// n_win = L - (w + k - 1) + 1 windows, the dtypes of the plain version
// repro_torch.core.minimizers.minimizers.
//
// What bounds it on the H100: memory.  A read is L bytes in and 16 bytes
// out per window (two int64s): 1,910 bytes at L=150, k=12, w=30, against
// about 2,500 int32 operations that the function needs (a rolling code
// and the hash per k-mer, three (value, position) min steps per window
// for a van Herk / Gil-Werman window minimum), so at the H100 SXM's
// published peaks the bytes take about four times as long.
//
// Design: a block takes a few whole reads.  It stages their bytes in
// shared memory with coalesced loads, then one thread per (read, k-mer)
// assembles the code and writes its hash to shared memory, and after a
// barrier one thread per (read, window) scans its w hashes left to right
// with a strict <, which keeps the leftmost of equal minima as the
// reference's (value, index) doubling does.  The scan costs w-1 compares
// per window, more operations than the bound counts, but they read shared
// memory only; the stores of neighbouring windows are neighbouring int64s,
// so the writes the bound counts coalesce.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void minimizer_kernel(const uint8_t* __restrict__ seq,
                                 int64_t* __restrict__ out_hash,
                                 int64_t* __restrict__ out_pos, int R, int L,
                                 int k, int w, int reads_per_block) {
  extern __shared__ uint32_t sm[];
  const int n_kmers = L - k + 1;
  const int n_win = n_kmers - w + 1;
  const long long r0 = (long long)blockIdx.x * reads_per_block;
  const int rows = (int)min((long long)reads_per_block, (long long)R - r0);
  uint32_t* h = sm;  // [read][k-mer] hashes, then the reads' bytes
  uint8_t* s = (uint8_t*)(sm + (long long)reads_per_block * n_kmers);

  const long long nbytes = (long long)rows * L;
  const uint8_t* src = seq + r0 * L;
  for (long long x = threadIdx.x; x < nbytes; x += blockDim.x) s[x] = src[x];
  __syncthreads();

  const int nk = rows * n_kmers;
  for (int x = threadIdx.x; x < nk; x += blockDim.x) {
    const int rr = x / n_kmers;
    const uint8_t* p = s + rr * L + (x - rr * n_kmers);
    uint32_t acc = 0;
    for (int j = 0; j < k; ++j) acc |= (uint32_t)p[j] << (2 * (k - 1 - j));
    h[x] = hash32(acc);
  }
  __syncthreads();

  const int nw = rows * n_win;
  const long long o0 = r0 * n_win;
  for (int x = threadIdx.x; x < nw; x += blockDim.x) {
    const int rr = x / n_win;
    const int t = x - rr * n_win;
    const uint32_t* q = h + rr * n_kmers + t;
    uint32_t best = q[0];
    int arg = 0;
    for (int j = 1; j < w; ++j) {
      const uint32_t v = q[j];
      if (v < best) {
        best = v;
        arg = j;
      }
    }
    out_hash[o0 + x] = (int64_t)best;
    out_pos[o0 + x] = (int64_t)(t + arg);
  }
}

extern "C" int minimizer_launch(const void* seq, void* out_hash, void* out_pos,
                                int R, int L, int k, int w,
                                int reads_per_block, int threads, int smem,
                                void* stream) {
  const int blocks = (R + reads_per_block - 1) / reads_per_block;
  minimizer_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (int64_t*)out_hash, (int64_t*)out_pos, R, L, k, w,
      reads_per_block);
  return (int)cudaGetLastError();
}
