// Split-KV single-token attention of decode_attention_cells.cu
// (flash-decoding with the query rows batched).
//
// Arithmetic, as csrc/decode_attention.cu and the reference: for query row n
// and head h (kv head h / (Hq/Hkv)),
//   s[t] = max(dot(bf16(q), bf16(k[t])) * scale + mask[n, t], NEG)
// with NEG = -0.7 * FLT_MAX, a softmax with f32 max and sum, p rounded to
// bf16 before the PV product, the result divided by max(l, 1e-30). A q8_0
// arena (int8, one f32 scale per 32 elements along D) is dequantized in f32
// and rounded to bf16.
//
// Pass 1 (split_kernel): one block per (slice of `split` keys, kv head).
// Every query row (all NB rows over the shared cell arena) times its g_rep
// query heads is handled in the block, kRows at a time, so each K/V element
// of the slice is read from device memory once per pass (once in all when
// the rows fit one pass: NB * g_rep <= kRows). Warps take keys; a lane holds
// D/32 elements of the key in registers and dots them with every row's
// query from shared memory. The slice's scores go to shared memory, a warp
// per row takes their max and sum, and a thread per output dimension d
// walks the slice's V column once for all rows. The partial (m, l, acc) of
// each (row, head, slice) goes to a workspace.
// Pass 2 (combine_kernel): one block per (row, head) merges the partials:
// M = max m_j, out = sum_j exp(m_j - M) acc_j / max(sum_j exp(m_j - M) l_j,
// 1e-30).
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;     // query rows per pass of a block
constexpr int kMaxSplit = 64; // keys per block, at most
constexpr int kMaxD = 256;
constexpr float kNeg = -0.7f * FLT_MAX;

struct Args {
  const float* q;           // (NB, Hq, D)
  void* k;                  // the layer's arena slice (Bk, T, Hkv*D)
  void* v;
  float* ks;                // (Bk, T, Hkv*D/32) f32 for q8_0, else null
  float* vs;
  const float* mask;        // (NB, T) f32 >= NEG
  float* ws_acc;            // (NB, Hq, n_split, D)
  float* ws_ml;             // (NB, Hq, n_split, 2)
  int NB, Bk, Hq, Hkv, D, T, split, n_split;
  float scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element `col` (of Hkv*D) of arena row `row` (batch folded in), as read.
template <bool kQ8>
__device__ __forceinline__ float load_kv(const void* base, const float* sc, size_t row,
                                         int hd, int col) {
  if (kQ8) {
    const int8_t* p = static_cast<const int8_t*>(base);
    return round_bf16((float)p[row * hd + col] * sc[row * (hd / 32) + col / 32]);
  }
  return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[row * hd + col]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (n_split, Hkv, Bk); rows of arena batch z: n in [z*rpb, (z+1)*rpb),
// rpb = NB / Bk. Shared memory: kRows*D floats (queries) + kRows*split (scores).
template <bool kQ8>
__global__ void __launch_bounds__(kThreads) split_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* sc = smem + kRows * a.D;
  const int j = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int g_rep = a.Hq / a.Hkv, hd = a.Hkv * a.D, nd = a.D / 32;
  const int rpb = a.NB / a.Bk, R = rpb * g_rep;
  const int t0 = j * a.split, nt = min(a.split, a.T - t0);
  const size_t row0 = (size_t)z * a.T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int rc = min(kRows, R - r0);
    __syncthreads();  // the previous pass is done with qs and sc
    for (int i = threadIdx.x; i < rc * a.D; i += kThreads) {
      const int r = r0 + i / a.D;
      const int n = z * rpb + r / g_rep, h = hk * g_rep + r % g_rep;
      qs[i] = round_bf16(a.q[((size_t)n * a.Hq + h) * a.D + i % a.D]);
    }
    __syncthreads();

    // scores: a warp per key, the key's D elements in registers
    for (int tt = warp; tt < nt; tt += kWarps) {
      const int t = t0 + tt;
      float kr[kMaxD / 32];
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i)
        kr[i] = i < nd ? load_kv<kQ8>(a.k, a.ks, row0 + t, hd, hk * a.D + i * 32 + lane) : 0.f;
      for (int r = 0; r < rc; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i)
          if (i < nd) acc += qs[r * a.D + i * 32 + lane] * kr[i];
        acc = warp_sum(acc);
        if (lane == 0) {
          const int n = z * rpb + (r0 + r) / g_rep;
          sc[r * a.split + tt] = fmaxf(acc * a.scale + a.mask[(size_t)n * a.T + t], kNeg);
        }
      }
    }
    __syncthreads();

    // the slice's softmax: a warp per row
    for (int r = warp; r < rc; r += kWarps) {
      float m = kNeg;
      for (int tt = lane; tt < nt; tt += 32) m = fmaxf(m, sc[r * a.split + tt]);
      m = warp_max(m);
      float l = 0.f;
      for (int tt = lane; tt < nt; tt += 32) {
        const float p = expf(sc[r * a.split + tt] - m);
        l += p;
        sc[r * a.split + tt] = round_bf16(p);
      }
      l = warp_sum(l);
      if (lane == 0) {
        const int n = z * rpb + (r0 + r) / g_rep, h = hk * g_rep + (r0 + r) % g_rep;
        float* ml = a.ws_ml + (((size_t)n * a.Hq + h) * a.n_split + j) * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
    __syncthreads();

    // PV: a thread per output dimension, every row of the pass at once
    for (int d = threadIdx.x; d < a.D; d += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int tt = 0; tt < nt; ++tt) {
        const float vv = load_kv<kQ8>(a.v, a.vs, row0 + t0 + tt, hd, hk * a.D + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rc) acc[r] += sc[r * a.split + tt] * vv;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rc) {
          const int n = z * rpb + (r0 + r) / g_rep, h = hk * g_rep + (r0 + r) % g_rep;
          a.ws_acc[(((size_t)n * a.Hq + h) * a.n_split + j) * a.D + d] = acc[r];
        }
      }
    }
  }
}

// grid (Hq, NB), kThreads threads; shared memory: n_split floats.
template <bool kQ8>
__global__ void __launch_bounds__(kThreads) combine_kernel(Args a, float* out) {
  extern __shared__ float w[];
  const int h = blockIdx.x, n = blockIdx.y;
  const size_t nh = (size_t)n * a.Hq + h;
  const float* ml = a.ws_ml + nh * a.n_split * 2;

  float M = kNeg;
  for (int j = 0; j < a.n_split; ++j) M = fmaxf(M, ml[2 * j]);
  for (int j = threadIdx.x; j < a.n_split; j += kThreads) w[j] = expf(ml[2 * j] - M);
  __syncthreads();
  float L = 0.f;
  for (int j = 0; j < a.n_split; ++j) L += w[j] * ml[2 * j + 1];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const float* acc = a.ws_acc + nh * a.n_split * a.D;
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    float o = 0.f;
    for (int j = 0; j < a.n_split; ++j) o += w[j] * acc[(size_t)j * a.D + d];
    out[nh * a.D + d] = o * inv;
  }
}

// Launch both passes on `stream`; returns cudaGetLastError().
inline int launch(Args a, float* out, cudaStream_t stream) {
  if (a.D % 32 || a.D > kMaxD || a.split > kMaxSplit || a.split < 1 || a.Hq % a.Hkv ||
      a.NB % a.Bk)
    return (int)cudaErrorInvalidValue;
  const size_t smem1 = sizeof(float) * (size_t)kRows * (a.D + a.split);
  const size_t smem2 = sizeof(float) * (size_t)a.n_split;
  const dim3 g1(a.n_split, a.Hkv, a.Bk), g2(a.Hq, a.NB);
  if (a.ks != nullptr) {
    cudaFuncSetAttribute(combine_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem2);
    split_kernel<true><<<g1, kThreads, smem1, stream>>>(a);
    combine_kernel<true><<<g2, kThreads, smem2, stream>>>(a, out);
  } else {
    cudaFuncSetAttribute(combine_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem2);
    split_kernel<false><<<g1, kThreads, smem1, stream>>>(a);
    combine_kernel<false><<<g2, kThreads, smem2, stream>>>(a, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace split_decode
