// k-mer hashing + sliding-window minimizers for Hopper.
//
// Replaces the Pallas kernel minimizer_pallas
// (src/repro/kernels/minimizer.py, _kernel): for every read of L base
// codes, the 2-bit code of each k-mer (k shift-ors in uint32, a sentinel
// base spilling into its neighbour's field as there), its hash32, and for
// every window of w consecutive k-mers the smallest hash and the position
// of its leftmost occurrence.  Outputs are int64 (hash, position) rows of
// n_win = L - (w + k - 1) + 1 windows, the dtypes of the plain version
// repro_torch.core.minimizers.minimizers.  Compiled twice: with CODES the
// first output is the minimizer's k-mer code, which seeding and the index
// build consume, recovered from its hash by unhash32 (hash32 is a
// bijection on 32 bits).
//
// What bounds it on the H100: memory.  A read is L bytes in and 16 bytes
// out per window (two int64s): 1,910 bytes at L=150, k=12, w=30, against
// about 2,500 int32 operations that the function needs (a rolling code
// and the hash per k-mer, three (value, position) min steps per window
// for a van Herk / Gil-Werman window minimum), so at the H100 SXM's
// published peaks the bytes take about four times as long.
//
// Design, so that the stores take all the time (a block's phases are
// split by barriers; the blocks an SM holds, nine at L=150, overlap them):
//  * a block of 128 threads takes about 1,024 windows of whole rows (ten
//    reads of 150) and stages their bytes in 16-byte loads;
//  * a thread codes a run of MINI_RUN consecutive k-mers, each from the
//    last by a shift, an or and a mask, and writes their hashes to
//    shared memory;
//  * van Herk / Gil-Werman over blocks of w windows: one thread scans a
//    block's k-mers backward for suffix minima, another the next block's
//    forward for prefix minima, a compare and two selects a step and no
//    branch, both into shared memory as (hash, position) pairs;
//  * the block's outputs are one contiguous range of each output tensor:
//    a thread takes two windows, the smaller of each one's suffix and
//    prefix minimum, and writes them in one 16-byte store to each.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the inverse of hash32 (repro_torch.core.minimizers.unhash32)
__device__ __forceinline__ uint32_t unhash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x43021123u;
  x = (x ^ (x >> 15) ^ (x >> 30)) * 0x1D69E2A5u;
  return x ^ (x >> 16);
}

// a window's first output: its smallest hash, or with CODES that
// minimizer's k-mer code
template <bool CODES>
__device__ __forceinline__ long long first_out(uint32_t hash) {
  return (long long)(CODES ? unhash32(hash) : hash);
}

// a window's minimum from its suffix and prefix minima: on a tie the
// suffix, further left, wins
__device__ __forceinline__ uint2 window_min(uint2 suffix, uint2 prefix) {
  return prefix.x < suffix.x ? prefix : suffix;
}

// consecutive k-mers a thread codes, each from the last by a shift-or
constexpr int MINI_RUN = 16;

// where the staged bytes start in a block's shared memory, after the
// minima and the hashes: 16-byte aligned (ops.minimizer_layout sizes the
// block to match)
__device__ __forceinline__ int stage_offset(int reads_per_block, int n_kmers,
                                            int n_win) {
  return (reads_per_block * (16 * n_win + 4 * n_kmers) + 15) & ~15;
}

template <bool CODES>
__global__ void minimizer_kernel(const uint8_t* __restrict__ seq,
                                 int64_t* __restrict__ out_hash,
                                 int64_t* __restrict__ out_pos, int R, int L,
                                 int k, int w, int reads_per_block) {
  extern __shared__ __align__(16) uint2 sm[];
  const int n_kmers = L - k + 1;
  const int n_win = n_kmers - w + 1;
  const long long r0 = (long long)blockIdx.x * reads_per_block;
  const int rows = (int)min((long long)reads_per_block, (long long)R - r0);
  // [read][window] (hash, position) minima, [read][k-mer] hashes, bytes
  uint2* o = (uint2*)sm;                 // suffix minima
  uint2* pm = o + reads_per_block * n_win;  // prefix minima
  uint32_t* h = (uint32_t*)(pm + reads_per_block * n_win);
  uint8_t* s = (uint8_t*)sm + stage_offset(reads_per_block, n_kmers, n_win);

  // the 16-byte-aligned chunks of memory that hold the block's rows, one
  // 16-byte load a chunk; a chunk that holds a byte of seq lies in the
  // same page as that byte, so the bytes around seq it reads are mapped
  const uint8_t* lo = seq + r0 * L;
  const uint8_t* hi = lo + (long long)rows * L;
  const uint8_t* lo16 = (const uint8_t*)((uintptr_t)lo & ~(uintptr_t)15);
  for (const uint8_t* c = lo16 + 16 * threadIdx.x; c < hi;
       c += 16 * blockDim.x)
    *(uint4*)(s + (c - lo16)) = *(const uint4*)c;
  s += lo - lo16;
  __syncthreads();

  // a thread per run of MINI_RUN consecutive k-mers: the first code from
  // k - 1 bases, then each next one by a shift, an or and a mask; a byte
  // past 3 spills into its neighbour's field (as the plain version's
  // shift-or does), which no rolling code can undo, so a run that holds
  // one assembles each of its codes from its k bases instead
  const uint32_t mask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1;
  const int runs = (n_kmers + MINI_RUN - 1) / MINI_RUN;
  for (int x = threadIdx.x; x < rows * runs; x += blockDim.x) {
    const int rr = x / runs;
    const int i0 = (x - rr * runs) * MINI_RUN;
    const int cnt = min(MINI_RUN, n_kmers - i0);
    const uint8_t* p = s + rr * L + i0;
    uint32_t* hr = h + rr * n_kmers + i0;
    uint32_t code = 0, any = 0;
    for (int j = 0; j < k - 1; ++j) {
      const uint32_t c = p[j];
      any |= c;
      code = (code << 2) | c;
    }
    for (int j = 0; j < cnt; ++j) {
      const uint32_t c = p[j + k - 1];
      any |= c;
      code = ((code << 2) | c) & mask;
      hr[j] = hash32(code);
    }
    if (any > 3) {
      for (int j = 0; j < cnt; ++j) {
        uint32_t acc = 0;
        for (int q = 0; q < k; ++q)
          acc |= (uint32_t)p[j + q] << (2 * (k - 1 - q));
        hr[j] = hash32(acc);
      }
    }
  }
  __syncthreads();

  // van Herk / Gil-Werman over blocks of w windows [i0, i0 + w) of a
  // row: window i0 + j is k-mers [i0 + j, i0 + w) (the suffix of the
  // block's k-mers) and [i0 + w, i0 + w + j) (a prefix of the next
  // block's).  One thread scans a block backward for its suffix minima,
  // another the next block forward for its prefix minima; the stores
  // below take the smaller of each window's two.  (hash, position)
  // pairs: on equal hashes the lower position wins, as the plain
  // version's pair doubling decides.
  const int nb = (n_win + w - 1) / w;
  for (int x = threadIdx.x; x < 2 * rows * nb; x += blockDim.x) {
    const int y = x >> 1;
    const int rr = y / nb;
    const int i0 = (y - rr * nb) * w;
    const int nwin = min(w, n_win - i0);
    const uint32_t* hr = h + rr * n_kmers + i0;
    if (x & 1) {
      uint2* prow = pm + rr * n_win + i0;
      uint32_t ph = 0xFFFFFFFFu, pp = 0;  // window i0 has no prefix
      prow[0] = make_uint2(ph, pp);
      for (int j = 1; j < nwin; ++j) {
        const uint32_t v = hr[w + j - 1];
        const bool take = v < ph;  // the prefix's leftmost keeps a tie
        ph = take ? v : ph;
        pp = take ? (uint32_t)(i0 + w + j - 1) : pp;
        prow[j] = make_uint2(ph, pp);
      }
    } else {
      uint2* orow = o + rr * n_win + i0;
      // the block's k-mers all exist: i0 + w - 1 <= n_kmers - 1
      uint32_t bh = hr[w - 1], bp = i0 + w - 1;
      if (w - 1 < nwin) orow[w - 1] = make_uint2(bh, bp);
      for (int j = w - 2; j >= 0; --j) {
        const uint32_t v = hr[j];
        const bool take = v <= bh;  // the lower position wins a tie
        bh = take ? v : bh;
        bp = take ? (uint32_t)(i0 + j) : bp;
        if (j < nwin) orow[j] = make_uint2(bh, bp);
      }
    }
  }
  __syncthreads();

  // the block's outputs are one contiguous range of each output: a
  // thread writes two windows in one 16-byte store (the wrapper's outputs
  // start on 16 bytes; a range that starts on an odd window writes that
  // one alone, as its odd last one)
  const int nw = rows * n_win;
  const long long o0 = r0 * n_win;
  const int head = (int)(o0 & 1);
  const int pairs = (nw - head) >> 1;
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    const int e = head + 2 * q;
    const uint2 v0 = window_min(o[e], pm[e]);
    const uint2 v1 = window_min(o[e + 1], pm[e + 1]);
    *(longlong2*)(out_hash + o0 + e) =
        make_longlong2(first_out<CODES>(v0.x), first_out<CODES>(v1.x));
    *(longlong2*)(out_pos + o0 + e) = make_longlong2(v0.y, v1.y);
  }
  if (threadIdx.x == 0) {
    if (head) {
      const uint2 v = window_min(o[0], pm[0]);
      out_hash[o0] = first_out<CODES>(v.x);
      out_pos[o0] = v.y;
    }
    if ((nw - head) & 1) {
      const uint2 v = window_min(o[nw - 1], pm[nw - 1]);
      out_hash[o0 + nw - 1] = first_out<CODES>(v.x);
      out_pos[o0 + nw - 1] = v.y;
    }
  }
}

extern "C" int minimizer_launch(const void* seq, void* out_first,
                                void* out_pos, int R, int L, int k, int w,
                                int codes, int reads_per_block, int threads,
                                int smem, void* stream) {
  const int blocks = (R + reads_per_block - 1) / reads_per_block;
  auto kernel = codes ? minimizer_kernel<true> : minimizer_kernel<false>;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (int64_t*)out_first, (int64_t*)out_pos, R, L, k,
      w, reads_per_block);
  return (int)cudaGetLastError();
}
