// Flash attention for Hopper on the CUDA cores: float32, causal or
// bidirectional, GQA, f32 online softmax.
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:69, _kernel) for float32 inputs;
// bfloat16 goes to the tensor-core kernel, flash_attention_wgmma.cu.  For
// each batch row b, query head h and query position i it computes
//   softmax_j(q_i . k_j / sqrt(hd), j <= i when causal) . v_j
// with k and v read from KV head h // (H / KV), as the Pallas body does: q
// scaled in f32 before the product, f32 scores, masked scores set to
// -1e30, running max and sum rescaled by exp(m - m_new), P.V accumulated in
// f32, output acc / max(l, 1e-30), kv tiles past the diagonal skipped.  The
// one difference is rounding: exp(x) is taken as ex2.approx(x * log2(e))
// (relative error below 2^-21).  It reads the LM layers' (B, S, heads, hd)
// layout in place, with 64-bit strides and offsets: at B=32, S=32768, 16
// heads of 128, q alone has 2.1e9 elements.
//
// What bounds it on the H100: operations.  Per (batch, head) the causal
// triangle needs S(S+1)/2 * hd multiply-adds for Q.K^T and as many for
// P.V, against q, k, v and o read or written once (about 1,000 flops per
// byte at S=4096, hd=80, far past the card's ~20 f32 flops per byte).  The
// reference computes in f32 and the check holds the kernel to 2e-3, so the
// products stay f32 FMAs on the CUDA cores (67 TFLOP/s published; TF32's
// ten-bit mantissa would not do): the bound is 2 x 2 x S(S+1)/2 x hd
// flops per head over that rate.  The S(S+1)/2 exponentials per head run
// on the special-function units, at hd=80 under 1/20 of the FMAs' time.
//
// Design: one block of 256 threads per (b, h, 128-row query tile), one
// block per SM.  Loads are 16-byte cp.async.cg copies (4-byte cp.async.ca
// where a base or stride is not a multiple of 16 bytes), rows past S
// zero-filled by the copy: Q once (each thread then scales the chunks it
// copied), then 64-key tiles of K through a two-stage ring and of V into
// one buffer.  Tile j+1's K is in flight during all of tile j, and V_j
// during S_j = Q.K_j^T: two barriers per tile and no load on the critical
// path.  One V stage, not two, at every head dim: V_j has all of S_j to
// land, and at hd=128 a second stage would not fit (Q 67.6 KB, two K
// stages 67.6 KB, V 33.8 KB, P 34.8 KB: 203.8 KB of the 227 KB a block
// may use).  Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i
// (i < 8): in S_j the keys tx + 16 j (j < 4), an 8 x 4 tile of scores, each
// step of four head dims one float4 of each of its 8 Q rows and 4 K rows
// for 128 FMAs; in P.V the output columns 4 tx + 64 e (float4s) and, past
// the last whole 64, tx + 16 e (scalars): 8 x hd/16 accumulators (64 at
// hd=128).  Rows are padded to hd + 4 floats, so the 16 K rows a warp
// reads and the two adjacent Q or P rows it broadcasts fall in distinct
// banks.  The 16 threads of a row are one half-warp: they reduce the row
// max with shuffles and keep partial row sums, reduced once at the end.
// Masks (key >= S, or key > query when causal) run on the diagonal and
// ragged tiles only.  Every query row sees key 0 in its first tile, so
// the running max is finite from then on and exp never sees -1e30 - -1e30
// except as exp(0) on rows still fully masked.  Blocks start in
// flash_common.cuh's order, every (batch, head) pair in one group: the
// longest causal tiles of every head first.
#include <cstdint>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block
constexpr int BK = 64;        // keys per K or V tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int RT = BQ / 16;   // query rows per thread: ty + 16 i
constexpr int KT = BK / 16;   // keys per thread in S: tx + 16 j
constexpr int PLD = BK + 4;   // padded row of the P tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory in floats: Q (BQ rows), two K stages and one V tile (BK
// rows each), all padded to HD + 4, then P (BQ rows of PLD).
template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;
  static constexpr int K_OFF = BQ * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int P_OFF = V_OFF + BK * LD;
  static constexpr size_t BYTES = sizeof(float) * (P_OFF + BQ * PLD);
  // output columns per thread: float4s at 4 tx + 64 e, then scalars at
  // 64 * C4 + tx + 16 e
  static constexpr int C4 = HD / 64;
  static constexpr int C1 = (HD % 64) / 16;
  static constexpr int CO = 4 * C4 + C1;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copies rows [row0, row0 + ROWS) of one head's (S, HD) panel into dst
// (rows of HD + 4); rows at or past S are zero-filled (the source address
// is then the panel's own base, never read).  Thread t copies chunks t,
// t + THREADS, ... of four floats: scale_rows repeats that walk.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int row0, int S,
                                          bool aligned) {
  constexpr int LD = HD + 4, CHUNKS = ROWS * HD / 4;
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    if (CHUNKS % THREADS && c >= CHUNKS) break;
    const int r = c / (HD / 4), d = 4 * (c % (HD / 4)), s = row0 + r;
    const bool valid = s < S;
    const float* g = valid ? src + int64_t(s) * row_stride + d : src;
    float* p = dst + r * LD + d;
    if (aligned) {
      cp_async16(p, g, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(p + e, valid ? g + e : g, valid);
    }
  }
}

template <int HD, int ROWS>
__device__ __forceinline__ void scale_rows(float* dst, float mul) {
  constexpr int LD = HD + 4, CHUNKS = ROWS * HD / 4;
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    if (CHUNKS % THREADS && c >= CHUNKS) break;
    float4* p = reinterpret_cast<float4*>(dst + (c / (HD / 4)) * LD +
                                          4 * (c % (HD / 4)));
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

// Output column of this thread's accumulator e (Layout::CO of them).
template <int HD>
__device__ __forceinline__ int out_col(int e, int tx) {
  using L = Layout<HD>;
  return e < 4 * L::C4 ? 64 * (e / 4) + 4 * tx + e % 4
                       : 64 * L::C4 + tx + 16 * (e - 4 * L::C4);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int H, int rep, int group, int causal,
                       float scale, int aligned,
                       int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                       int64_t kss, int64_t ksh, int64_t osb, int64_t oss,
                       int64_t osh) {
  using L = Layout<HD>;
  constexpr int LD = L::LD, CO = L::CO;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sV = smem + L::V_OFF;
  float* sP = smem + L::P_OFF;

  int b, h, iq;
  flash_tile(blockIdx.x, (S + BQ - 1) / BQ, group, H, causal, b, h, iq);
  const int g = h / rep;
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qh = q + int64_t(b) * qsb + int64_t(h) * qsh;
  const float* kh = k + int64_t(b) * ksb + int64_t(g) * ksh;
  const float* vh = v + int64_t(b) * ksb + int64_t(g) * ksh;
  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min((q0 + BQ + BK - 1) / BK, nk_all) : nk_all;

  load_rows<HD, BQ>(sQ, qh, qss, q0, S, aligned);
  cp_async_commit();
  load_rows<HD, BK>(smem + L::K_OFF, kh, kss, 0, S, aligned);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q chunks have landed
  scale_rows<HD, BQ>(sQ, scale);

  float m[RT], l[RT], acc[RT][CO];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CO; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    const float* sK = smem + L::K_OFF + (j & 1) * BK * LD;
    cp_async_wait<0>();  // K_j
    // K_j and the scaled Q are visible; every thread is done with tile
    // j - 1: its P, its V and the K stage that K_{j+1} overwrites
    __syncthreads();
    load_rows<HD, BK>(sV, vh, kss, k0, S, aligned);
    cp_async_commit();
    if (j + 1 < nk)
      load_rows<HD, BK>(smem + L::K_OFF + ((j + 1) & 1) * BK * LD, kh, kss,
                        k0 + BK, S, aligned);
    cp_async_commit();  // possibly empty: keeps the group count fixed

    float s[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < KT; ++c) s[i][c] = 0.f;
    // unrolled whole up to hd=80; at hd=128 (254 registers) by eight
#pragma unroll(HD <= 80 ? HD / 4 : 8)
    for (int d = 0; d < HD; d += 4) {
      float4 kv[KT];
#pragma unroll
      for (int c = 0; c < KT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          s[i][c] = fmaf(a.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(a.y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(a.z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(a.w, kv[c].w, s[i][c]);
        }
      }
    }

    if (k0 + BK > S || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int qpos = q0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const int kpos = k0 + tx + 16 * c;
          if (kpos >= S || (causal && kpos > qpos)) s[i][c] = NEG;
        }
      }
    }
    // online softmax, one row per (i, half-warp)
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < KT; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float corr = ex2((m[i] - mx) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float p = ex2((s[i][c] - mx) * LOG2E);
        sum += p;
        sP[(ty + 16 * i) * PLD + tx + 16 * c] = p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < CO; ++e) acc[i][e] *= corr;
    }
    cp_async_wait<1>();  // V_j (K_{j+1} may still be in flight)
    __syncthreads();     // P and V_j are visible

    // whole at hd=128, by four below it
#pragma unroll(HD == 128 ? BK / 4 : 4)
    for (int c = 0; c < BK; c += 4) {
      float4 p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        p[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * PLD + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = &sV[(c + cc) * LD];
        float vv[CO];
#pragma unroll
        for (int e = 0; e < 4 * L::C4; e += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(vr + 64 * (e / 4) + 4 * tx);
          vv[e] = t.x;
          vv[e + 1] = t.y;
          vv[e + 2] = t.z;
          vv[e + 3] = t.w;
        }
#pragma unroll
        for (int e = 4 * L::C4; e < CO; ++e) vv[e] = vr[out_col<HD>(e, tx)];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                         : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < CO; ++e) acc[i][e] = fmaf(pi, vv[e], acc[i][e]);
        }
      }
    }
  }

  float* oh = o + int64_t(b) * osb + int64_t(h) * osh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float den = l[i];
#pragma unroll
    for (int off = 8; off; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off, 16);
    den = fmaxf(den, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < CO; ++e)
      oh[int64_t(row) * oss + out_col<HD>(e, tx)] = acc[i][e] / den;
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int H, int KV, int causal, float scale,
                   int aligned, const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  // every (batch, head) pair in one group (flash_common.cuh)
  flash_attention_kernel<HD><<<(S + BQ - 1) / BQ * H * B, THREADS, smem,
                               stream>>>(
      q, k, v, o, S, H, H / KV, B * H, causal, scale, aligned, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

bool aligned16(const void* p, int64_t s0, int64_t s1, int64_t s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace

// float32 only; hd 16, 32, 64, 80 or 128.  Strides are in elements:
// (batch, seq, head) of q, of k and v (equal), and of o; head_dim is
// contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int hd, int causal, float scale, int64_t qsb, int64_t qss,
    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t osb,
    int64_t oss, int64_t osh, void* stream) {
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, osb, oss, osh};
  const int aligned = aligned16(q, qsb, qss, qsh) &&
                      aligned16(k, ksb, kss, ksh) &&
                      aligned16(v, ksb, kss, ksh);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(HD)                                                     \
  case HD:                                                                 \
    return launch<HD>(qf, kf, vf, of, B, S, H, KV, causal, scale, aligned, \
                      st, s);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
