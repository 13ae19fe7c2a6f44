// Flash attention for Hopper: causal or bidirectional, GQA, f32 online
// softmax.
//
// Replaces the Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:69, _kernel).  For each batch row
// b, query head h and query position i it computes
//   softmax_j(q_i . k_j / sqrt(hd), j <= i when causal) . v_j
// with k and v read from KV head h // (H / KV), as the Pallas body does:
// q cast to f32 and scaled before the product, scores in f32, masked
// scores set to -1e30, running max and sum rescaled by exp(m - m_new), p
// rounded to v's dtype before the P.V product and accumulated in f32,
// output acc / max(l, 1e-30) in q's dtype, kv tiles past the diagonal
// skipped.  (The Pallas body also rounds each tile's P.V product to v's
// dtype before adding it; here the f32 sum is kept, which depends on no
// tile size.)  It reads the LM layers' (B, S, heads, hd) layout in place,
// with 64-bit strides and offsets: at B=32, S=32768, 16 heads of 128, q
// alone has 2.1e9 elements.
//
// What bounds it on the H100: operations.  Per (batch, head) the causal
// triangle needs 2 * S(S+1)/2 * hd multiply-adds for Q.K^T and as many
// for P.V; against that, q, k, v and o are read or written once: at
// S=32768, hd=64 about 4,000 flops per byte, far past the H100's ~295
// bf16 flops per byte.  The bound is the products at the tensor cores'
// 989 TFLOP/s (bf16, dense).  This first kernel does them as f32 FMAs on
// the CUDA cores (67 TFLOP/s published), so it cannot come within 15x of
// that bound; feeding the tensor cores (mma.sync / wgmma with TMA) is
// later work.
//
// Design: the Pallas program holds its KV head's whole (S, hd) K and V
// panels in VMEM; at S=32768 that is 8 MB, far past a block's 227 KB of
// shared memory.  Here one block of 256 threads takes one (b, h, 64-row
// query tile) and streams 64-row K and V tiles through one shared buffer
// (K for the scores, then V for the product: less shared memory, more
// blocks per SM).  Q is staged once, scaled, in f32.  Thread (ty, tx) of
// a 16 x 16 grid owns rows 4ty..4ty+3 of the tile: scores for key columns
// tx + 16j (j < 4), and output columns tx*EPT .. tx*EPT+EPT-1 (EPT =
// hd/16), so the f32 accumulator is 4 x EPT registers (32 at hd=128).
// The 16 threads of a row are one half-warp and reduce the row max and
// sum with shuffles.  Shared rows are padded to hd+4 floats: float4 reads
// of Q and K rows hit distinct banks.  A ragged last tile is zero-filled
// and masked to -1e30; since every query row sees key 0 in its first
// tile, the running max is finite from then on and exp never sees
// -1e30 - -1e30 except as exp(0) on rows still fully masked.  Causal
// query tiles are launched longest first (reverse order) so that the
// short ones fill the tail.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int PLD = BK + 4;   // padded row of the P tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (HD + 4) + size_t(BK) * (HD + 4) +
                          size_t(BQ) * PLD);
}

// Stage rows [row0, row0 + ROWS) of one head's (S, HD) panel as f32 times
// mul; rows at or past S are zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row_stride, int row0, int S,
                                      float mul) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = row0 + r;
    dst[r * LD + d] = s < S ? to_f(src[int64_t(s) * row_stride + d]) * mul
                            : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int rep, int causal, float scale, int64_t qsb,
                       int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                       int64_t ksh, int64_t osb, int64_t oss, int64_t osh) {
  constexpr int LD = HD + 4;
  constexpr int EPT = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // BQ x LD: q * scale
  float* sKV = sQ + BQ * LD;    // BK x LD: this tile's K, then its V
  float* sP = sKV + BK * LD;    // BQ x PLD: p rounded to T

  const int nq = gridDim.x;
  const int iq = causal ? nq - 1 - int(blockIdx.x) : int(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qh = q + int64_t(b) * qsb + int64_t(h) * qsh;
  const T* kh = k + int64_t(b) * ksb + int64_t(g) * ksh;
  const T* vh = v + int64_t(b) * ksb + int64_t(g) * ksh;

  stage<T, HD, BQ>(sQ, qh, qss, q0, S, scale);

  float m[4], l[4], acc[4][EPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }

  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min((q0 + BQ + BK - 1) / BK, nk_all) : nk_all;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the last tile's V reads are done; sQ is staged
    stage<T, HD, BK>(sKV, kh, kss, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 c =
            *reinterpret_cast<const float4*>(&sKV[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, c.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c.w, s[i][j]);
        }
      }
    }

    // online softmax, one row per (i, half-warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty * 4 + i) * PLD + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // every K read is done and sP is complete
    stage<T, HD, BK>(sKV, vh, kss, k0, S, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&sP[(ty * 4 + i) * PLD + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = &sKV[(c + cc) * LD + tx * EPT];
        float vv[EPT];
        if constexpr (EPT % 4 == 0) {
#pragma unroll
          for (int e = 0; e < EPT; e += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vr + e);
            vv[e] = t.x;
            vv[e + 1] = t.y;
            vv[e + 2] = t.z;
            vv[e + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < EPT; ++e) vv[e] = vr[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                         : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[i][e] = fmaf(pi, vv[e], acc[i][e]);
        }
      }
    }
  }

  T* oh = o + int64_t(b) * osb + int64_t(h) * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_ = q0 + ty * 4 + i;
    if (s_ >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      oh[int64_t(s_) * oss + tx * EPT + e] = from_f<T>(acc[i][e] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int causal, float scale,
                   const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, causal, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int KV, int causal,
                     float scale, const int64_t* st, cudaStream_t stream) {
#define FLASH_CASE(HD)                                                   \
  case HD:                                                               \
    return launch<T, HD>(q, k, v, o, B, S, H, KV, causal, scale, st, stream);
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

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements: (batch, seq,
// head) of q, of k and v (equal), and of o; head_dim is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int hd, int dtype, int causal, float scale, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t osb, int64_t oss, int64_t osh, void* stream) {
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, B, S, H, KV, causal, scale, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, causal,
                                   scale, st, s);
  return cudaErrorInvalidValue;
}
