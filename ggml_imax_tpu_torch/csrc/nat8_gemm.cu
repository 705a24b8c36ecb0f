// W8A16 GEMM over nat8 int8 weights (prefill and batched rows).
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_nat8_w8a16_stk (the
// per-layer matmuls) and ::_kernel_nat8_w8a16 (one tensor).
//
// Computes out = x_bf16 @ w (+ xs @ bias) with f32 accumulation, where the
// weight is rounded exactly as the reference rounds it:
// w = bf16(bf16(q) * bf16(s)), one rounding of the product (q is exact in
// bf16, and the scale is cast to bf16 even when it is stored f32). xs holds
// the per-group sums of bf16(x) in f32; g = 32 or 16.
//
// Bound on the H100: operations. At M = 512 each weight byte feeds
// 2 * 512 = 1024 flops, well above the ~295 flop/byte where bf16 tensor
// cores take over from the memory, so 2*M*K*N over 989 TFLOP/s is the floor
// (10.6 us for GPT-2 XL's fc_w at the 512-row prefill bucket).
//
// Design: as w4a16_gemm.cu. nvcuda::wmma bf16 16x16x16 with f32
// accumulators; a block of 4 warps owns a 64x64 output tile, each warp a
// 32x32 quarter. The K loop steps 32 rows at a time (one per-32 group or
// two per-16 ones): the block copies its 64x32 slice of x to shared memory
// and expands the 32 x 64 int8 weight slice (one 16-byte load per thread)
// into a bf16 tile there, so both tensor-core operands are bit-identical to
// the reference's. Ragged M and N are masked (a ragged N or an unaligned
// weight loads byte by byte); the accumulators are staged through shared
// memory for the edge and the optional bias term. No async copies, no
// double buffering, no wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDX = BK + 8;   // bf16 elements; keeps wmma rows 32-byte aligned
constexpr int LDW = BN + 8;
constexpr int LDO = BN + 4;   // f32 staging

__device__ __forceinline__ float load_scale(const float* s, size_t i) { return s[i]; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

template <typename ST>
__global__ void __launch_bounds__(128)
nat8_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const ST* __restrict__ s, const ST* __restrict__ bias,
                 const float* __restrict__ xs, float* __restrict__ out, int M, int K,
                 int N, int g, int vec) {
  __shared__ __align__(32) __nv_bfloat16 xt[BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 wt[BK * LDW];
  __shared__ __align__(32) float ot[BM * LDO];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kb = 0; kb < K / BK; ++kb) {
    // x tile: 64 rows x 32 bf16 = 64 x 4 chunks of 16 bytes; 2 per thread
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * 128;
      const int row = c / 4, part = c % 4;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + kb * BK + part * 8);
      *reinterpret_cast<uint4*>(&xt[row * LDX + part * 8]) = v;
    }
    // weight tile: 32 rows x 64 columns; each thread expands one row's 16
    // columns into bf16(q) * bf16(s), rounded once
    {
      const int row = tid / 4, c16 = (tid % 4) * 16;
      const int k = kb * BK + row, n = n0 + c16;
      const int8_t* src = q + (size_t)k * N + n;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (vec && n + 16 <= N) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else {
        for (int i = 0; i < 16; ++i)
          if (n + i < N) w[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
      }
      const size_t srow = (size_t)(k / g) * N;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qv = (int)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xFFu);
        const float sc = __bfloat162float(
            __float2bfloat16_rn(n + i < N ? load_scale(s, srow + n + i) : 0.f));
        // bf16 * bf16 is exact in f32; one rounding to bf16, as the reference
        wt[row * LDW + c16 + i] = __float2bfloat16_rn((float)qv * sc);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &xt[(wm + 16 * i) * LDX + kk], LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &wt[kk * LDW + wn + 16 * j], LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&ot[(wm + 16 * i) * LDO + wn + 16 * j], acc[i][j], LDO,
                              wmma::mem_row_major);
  __syncthreads();
  const int nb = K / g;
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = ot[r * LDO + c];
    if (bias != nullptr) {
      float t = 0.f;
      for (int b = 0; b < nb; ++b)
        t += xs[(size_t)m * nb + b] * load_scale(bias, (size_t)b * N + n);
      v += t;
    }
    out[(size_t)m * N + n] = v;
  }
}

}  // namespace

// x (M, K) bf16, q (K, N) int8, scale/bias (K/g, N) f32 or bf16 (bias may be
// null), xs (M, K/g) f32 per-group sums of x, out (M, N) f32. Requires
// g in {16, 32} and K % 32 == 0; M and N are free.
extern "C" int ggml_nat8_gemm(const void* x, const void* q, const void* scale,
                              const void* bias, const void* xs, void* out, int M, int K,
                              int N, int g, int scale_is_bf16, void* stream) {
  if ((g != 16 && g != 32) || K % BK) return (int)cudaErrorInvalidValue;
  const int vec = (N % 16 == 0) && ((uintptr_t)q % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_is_bf16)
    nat8_gemm_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q, (const __nv_bfloat16*)scale,
        (const __nv_bfloat16*)bias, (const float*)xs, (float*)out, M, K, N, g, vec);
  else
    nat8_gemm_kernel<float><<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)scale,
        (const float*)bias, (const float*)xs, (float*)out, M, K, N, g, vec);
  return (int)cudaGetLastError();
}
