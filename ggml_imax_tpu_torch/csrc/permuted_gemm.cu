// W4A16 / W8A16 GEMMs over the three permuted weight layouts: the
// block-interleaved plane split, the row-pair u-order nib4 and the u-order
// int8 rows. M is any size >= 1: these layouts have no W8A8 path, so decode
// runs them at M = 1 and prefill at the 512-row bucket.
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_noround (planes; its
// wrapper qmatmul_pallas), ::_kernel_rowpair (_qmatmul_rowpair) and
// ::_kernel_int8 (_qmatmul_int8).
//
// Each computes out = x_bf16 @ w with f32 sums over the weight as the
// reference rounds it, read in its stored layout in place (no repack, no
// dequantized copy in device memory):
// - planes: w = bf16(bf16(nib - zero) * bf16(s)), then + bf16(bias) rounded
//   to bf16 again: the bias is inside the weight. The low plane of a quant
//   block takes scale row k / g of its elements 0-15, the high plane that
//   of 16-31: with per-16 scales (Q2_K, Q3_K) two different rows.
// - row-pair: w = bf16(bf16((nib ^ 8) - 8) * bf16(s)), per-32 scales;
// - u-order int8: w = bf16(bf16(q) * bf16(s)), g = 16 or 32;
//   both plus the exact f32 term xs @ bias, xs the per-group sums of bf16(x).
//
// The reference permutes x to the stored row order; here x stays natural
// and each K step of 32 natural rows computes where its rows are stored.
// In a K tile of bk rows, NB = bk / group:
// - planes: byte row j * NB + b holds elements 32b + j (low nibble) and
//   32b + 16 + j (high nibble) of the tile;
// - row-pair: element 32b + e is row u = e * NB + b, the (u & 1) nibble of
//   byte row u >> 1;
// - u-order int8: element g b + e is row u = e * NB + b.
//
// Bound on the H100: bytes at M = 1 (K N / 2 or K N weight bytes), the
// tensor cores at the 512-row prefill bucket (2 M K N flops, ~1,000-2,000
// flops per weight byte, above the ~295 where bf16 tensor cores take over).
//
// Design: as w4a16_gemm.cu. nvcuda::wmma bf16 16x16x16 with f32
// accumulators; a block of 4 warps owns a 64x64 output tile, each warp a
// 32x32 quarter. Each K step copies the 64x32 slice of x to shared memory
// and expands the 32 x 64 weight slice into a bf16 tile there, so both
// tensor-core operands are bit-identical to the reference's. The planes
// fill reads each byte once (both nibbles); the row-pair fill reads a byte
// row for one nibble, so each byte row is read by two K steps (the second
// read mostly from L1/L2). At M = 1 the tile's 63 empty rows are zeros and
// the grid has N / 64 blocks: no split-K yet, no async copies, no wgmma.
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

enum Layout { PLANES = 0, ROWPAIR = 1, INT8_ROWS = 2 };

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const void* scale;
  const void* bias;
  const float* xs;    // (M, K / g) per-group sums of bf16(x); row-pair, int8
  float* out;
  int M, K, N, bk, g, zero;
};

__device__ __forceinline__ float load_scale(const float* s, size_t i) { return s[i]; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

// a scale or bias as the reference uses it: cast to bf16 first
template <typename ST>
__device__ __forceinline__ float as_bf16(const ST* p, size_t i) {
  return __bfloat162float(__float2bfloat16_rn(load_scale(p, i)));
}

// bf16 * bf16 is exact in f32, so one rounding gives the reference's product
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Expand natural rows k0 .. k0 + 31 x columns n0 .. n0 + 63 of the weight
// into wt (32 x LDW bf16). N % 16 == 0, so a thread's columns are all in
// range or all out.
template <int L, typename ST>
__device__ __forceinline__ void fill_weights(const Args& a, int k0, int n0, int tid,
                                             __nv_bfloat16* wt) {
  const ST* s = static_cast<const ST*>(a.scale);
  const ST* bias = static_cast<const ST*>(a.bias);
  const int N = a.N;
  const size_t tile = (size_t)(k0 / a.bk);        // K tile of these rows
  if (L == PLANES) {
    // one byte row j of block b: elements j (low) and 16 + j (high)
    const int nb = a.bk / 32, b = (k0 % a.bk) / 32;
    const int j = tid / 8, c8 = (tid % 8) * 8, n = n0 + c8;
    uint32_t w[2] = {0u, 0u};
    if (n < N) {
      const uint8_t* src = a.q + (tile * (a.bk / 2) + (size_t)j * nb + b) * N + n;
      w[0] = *reinterpret_cast<const uint32_t*>(src);
      w[1] = *reinterpret_cast<const uint32_t*>(src + 4);
    }
    const size_t rlo = (size_t)((k0 + j) / a.g) * N;
    const size_t rhi = (size_t)((k0 + 16 + j) / a.g) * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
      float wlo = 0.f, whi = 0.f;
      if (n < N) {
        wlo = round_bf16((float)((int)(byte & 0xFu) - a.zero) * as_bf16(s, rlo + n + i));
        whi = round_bf16((float)((int)(byte >> 4) - a.zero) * as_bf16(s, rhi + n + i));
        if (bias != nullptr) {
          wlo = round_bf16(wlo + as_bf16(bias, rlo + n + i));
          whi = round_bf16(whi + as_bf16(bias, rhi + n + i));
        }
      }
      wt[j * LDW + c8 + i] = __float2bfloat16_rn(wlo);
      wt[(16 + j) * LDW + c8 + i] = __float2bfloat16_rn(whi);
    }
  } else {
    // one natural row r, 16 columns: find its stored row
    const int r = tid / 4, c16 = (tid % 4) * 16, n = n0 + c16;
    const int kk = (k0 % a.bk) + r;                // row within the tile
    const int grp = (L == ROWPAIR) ? 32 : a.g;
    const int u = (kk % grp) * (a.bk / grp) + kk / grp;
    size_t row;
    int shift = 0;
    if (L == ROWPAIR) {
      row = tile * (a.bk / 2) + (u >> 1);
      shift = 4 * (u & 1);
    } else {
      row = tile * a.bk + u;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (n < N) {
      const uint4 v = *reinterpret_cast<const uint4*>(a.q + row * N + n);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
    const size_t srow = (size_t)((k0 + r) / grp) * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
      const int qv = (L == ROWPAIR) ? (int)(((byte >> shift) & 0xFu) ^ 8u) - 8
                                    : (int)(int8_t)byte;
      const float sc = n < N ? as_bf16(s, srow + n + i) : 0.f;
      wt[r * LDW + c16 + i] = __float2bfloat16_rn((float)qv * sc);
    }
  }
}

template <int L, typename ST>
__global__ void __launch_bounds__(128) permuted_gemm_kernel(Args a) {
  __shared__ __align__(32) __nv_bfloat16 xt[BM * LDX];
  __shared__ __align__(32) __nv_bfloat16 wt[BK * LDW];
  __shared__ __align__(32) float ot[BM * LDO];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, K = a.K, N = a.N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 64 rows x 32 bf16 = 64 x 4 chunks of 16 bytes; 2 per thread
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * 128;
      const int row = c / 4, part = c % 4;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < M)
        v = *reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + row) * K + k0 + part * 8);
      *reinterpret_cast<uint4*>(&xt[row * LDX + part * 8]) = v;
    }
    fill_weights<L, ST>(a, k0, n0, tid, wt);
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
  const ST* bias = static_cast<const ST*>(a.bias);
  const int nbias = K / ((L == ROWPAIR) ? 32 : a.g);
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = ot[r * LDO + c];
    if (L != PLANES && bias != nullptr) {
      float t = 0.f;
      for (int b = 0; b < nbias; ++b)
        t += a.xs[(size_t)m * nbias + b] * load_scale(bias, (size_t)b * N + n);
      v += t;
    }
    a.out[(size_t)m * N + n] = v;
  }
}

template <int L>
int launch(const Args& a, int scale_is_bf16, void* stream) {
  const int grp = (L == ROWPAIR) ? 32 : a.g;
  if (a.M < 1 || a.K % BK || a.N % 16 || a.bk <= 0 || a.bk % BK || a.K % a.bk ||
      (grp != 16 && grp != 32))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_is_bf16)
    permuted_gemm_kernel<L, __nv_bfloat16><<<grid, 128, 0, st>>>(a);
  else
    permuted_gemm_kernel<L, float><<<grid, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 in natural order, out (M, N) f32; scale/bias f32 or bf16
// (bias may be null); bk the layout's K tile. Requires K % 32 == 0,
// bk % 32 == 0, K % bk == 0 and N % 16 == 0; q and x 16-byte aligned.

// q (K/2, N) u8 planes; scale/bias (K/g, N), g 16 or 32; zero the nibble
// zero point.
extern "C" int ggml_planes_w4a16(const void* x, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int K, int N,
                                 int bk, int g, int zero, int scale_is_bf16,
                                 void* stream) {
  const Args a{(const __nv_bfloat16*)x, (const uint8_t*)q, scale, bias, nullptr,
               (float*)out, M, K, N, bk, g, zero};
  return launch<PLANES>(a, scale_is_bf16, stream);
}

// q (K/2, N) u8 row pairs; scale/bias (K/32, N); xs (M, K/32) f32.
extern "C" int ggml_rowpair_w4a16(const void* x, const void* q, const void* scale,
                                  const void* bias, const void* xs, void* out, int M,
                                  int K, int N, int bk, int scale_is_bf16,
                                  void* stream) {
  const Args a{(const __nv_bfloat16*)x, (const uint8_t*)q, scale, bias,
               (const float*)xs, (float*)out, M, K, N, bk, 32, 0};
  return launch<ROWPAIR>(a, scale_is_bf16, stream);
}

// q (K, N) int8 u-order rows; scale/bias (K/g, N), g 16 or 32; xs (M, K/g).
extern "C" int ggml_int8_rows_w8a16(const void* x, const void* q, const void* scale,
                                    const void* bias, const void* xs, void* out, int M,
                                    int K, int N, int bk, int g, int scale_is_bf16,
                                    void* stream) {
  const Args a{(const __nv_bfloat16*)x, (const uint8_t*)q, scale, bias,
               (const float*)xs, (float*)out, M, K, N, bk, g, 0};
  return launch<INT8_ROWS>(a, scale_is_bf16, stream);
}
