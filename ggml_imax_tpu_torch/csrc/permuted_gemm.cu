// W4A16 / W8A16 products over the three permuted weight layouts: the
// block-interleaved plane split, the row-pair u-order nib4 and the u-order
// int8 rows. M is any size >= 1: these layouts have no W8A8 path, so decode
// runs them at M = 1 and prefill at the 512-row bucket.
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_noround (planes; its
// wrapper qmatmul_pallas), ::_kernel_rowpair (_qmatmul_rowpair) and
// ::_kernel_int8 (_qmatmul_int8).
//
// Each computes out = bf16(x) @ w with f32 sums over the weight as the
// reference rounds it, read in its stored layout in place (no repack, no
// dequantized copy in device memory):
// - planes: w = bf16(bf16(nib - zero) * bf16(s)), then + bf16(bias) rounded
//   to bf16 again: the bias is inside the weight. The low plane of a quant
//   block takes scale row k / g of its elements 0-15, the high plane that
//   of 16-31: with per-16 scales (Q2_K, Q3_K) two different rows.
// - row-pair: w = bf16(bf16((nib ^ 8) - 8) * bf16(s)), per-32 scales;
// - u-order int8: w = bf16(bf16(q) * bf16(s)), g = 16 or 32;
//   both plus the exact f32 term xs . bias, xs the per-group sums of
//   bf16(x), added group by group inside the K loop.
//
// The reference permutes x to the stored row order; here x stays natural
// and each piece of K computes where its rows are stored. In a K tile of
// bk rows, NB = bk / group:
// - planes: byte row j * NB + b holds elements 32b + j (low nibble) and
//   32b + 16 + j (high nibble) of the tile;
// - row-pair: element 32b + e is row u = e * NB + b, the (u & 1) nibble of
//   byte row u >> 1. With NB even, byte row (e * NB + b) / 2 (b even) holds
//   element e of blocks b (low) and b + 1 (high);
// - u-order int8: element g b + e is row u = e * NB + b.
//
// Two routes behind each C entry, chosen by M, and `split`, the number of
// pieces K is cut into across blocks (ops/qmm.py::permuted_plan: enough
// blocks for the 132 SMs, at most 8 pieces). With split > 1 the split
// blocks of an output tile are one thread-block cluster: each keeps its
// partial sums in its shared memory, and the ranks share out the outputs,
// each summed over the ranks in K order through distributed shared memory.
// No workspace in device memory, no float atomics: the same bits on every
// run.
//
// GEMV route, M <= 8 (decode). Bound on the H100: bytes (K N / 2 or K N
// weight bytes plus the scale and bias rows, over 3.35 TB/s; 0.3-0.8 us at
// GPT-2 117M's products), so the design is about reading each byte once
// with enough loads in flight, and about fixed costs, which are most of a
// launch this small. It follows nat8_gemv.cu: a thread owns 8 adjacent
// columns (one 8-byte load per byte row), 8 threads span a block's 64
// columns and 32 slots of threads take units of K. A unit follows the
// stored layout, so each weight byte is read once and each scale or bias
// value once per unit and column, never once per element: planes one
// quant block (16 byte rows, both nibbles; its low and high scale rows),
// row-pair two quant blocks b, b + 1 sharing their byte rows when NB is
// even (one block when NB is odd: both nibbles of a byte row when NB is 1,
// one nibble otherwise, the other read by the partner block's unit from
// L1/L2), int8 one group of g rows. A unit's byte rows are walked in chunks,
// the next chunk's loads issued before the current one is expanded: a fully
// unrolled unit is so much straight-line code at M 8 that instruction
// fetch, not memory, set the time. x (f32, at most 8 rows) goes to shared
// memory once per block, rounded to bf16, 32 units at a time; the bias
// term's group sums are taken there. One f32 accumulator per (row, column);
// the 32 slots' partials are added by warp shuffles and then across the 8
// warps in shared memory, in a fixed order.
//
// Tile route, M > 8 (prefill). Bound: the tensor cores (2 M K N flops,
// ~1,000-2,000 flops per weight byte at the 512-row bucket). nvcuda::wmma
// bf16 16x16x16 with f32 accumulators; a block of 8 warps owns a 128 x 64
// output tile (each warp 32 x 32) and walks K in steps of 64, so each
// expanded weight serves 128 rows. Each step copies the 128 x 64 slice of
// bf16 x to shared memory and expands the 64 x 64 weight slice into a bf16
// tile there, so both tensor-core operands are bit-identical to the
// reference's. The expansion was half of a step's time, so it works on two
// columns per bf16x2 instruction and stores 16 bytes at a time, and the
// step's address math advances a cursor instead of dividing. The step's
// scale and bias rows (and for the bias term its per-group x sums) are
// staged in shared memory once, and every expansion reads them there. Each
// step's raw x and weight bytes are loaded into registers, and its scales
// staged, one step ahead, before the current step's mma_sync, so
// device-memory latency overlaps the tensor cores. Two __syncthreads a
// step. Not yet: cp.async or TMA rings, wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cooperative_groups.h>

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

enum Layout { PLANES = 0, ROWPAIR = 1, INT8_ROWS = 2 };

constexpr int kGemvMaxM = 8;   // ops/qmm.py _PERMUTED_GEMV_MAX_M
constexpr int kMaxSplit = 8;   // a portable cluster's blocks (ops/qmm.py _PERMUTED_MAX_SPLIT)

struct Args {
  const void* x;      // (M, K): f32 on the GEMV route, bf16 on the tile route
  const uint8_t* q;
  const void* scale;
  const void* bias;
  const float* xs;    // (M, K / group) per-group sums of bf16(x): tile route
                      // with a row-pair or int8 bias
  float* out;
  int M, K, N, bk, g, zero, split;
};

__device__ __forceinline__ float load_scale(const float* s, size_t i) { return s[i]; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

// bf16 * bf16 is exact in f32, so one rounding gives the reference's product
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 consecutive values p[i .. i + 7] as f32 (i a multiple of 8, p 16-byte
// aligned)
__device__ __forceinline__ void load8(const float* p, size_t i, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + i) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, size_t i, float v[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p + i));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t byte_of(uint2 w, int c) {
  return ((c < 4 ? w.x : w.y) >> (8 * (c % 4))) & 0xFFu;
}

__device__ __forceinline__ float rowpair_value(uint32_t nib) {
  return (float)((int)(nib ^ 8u) - 8);
}

// With split > 1 the split blocks of an output tile are one thread-block
// cluster, ranked in K order. After every block put its partial sums at
// part[0 .. count) of its shared memory, the ranks share the outputs: each
// output's sum over the ranks' parts is taken in rank order (its loads
// through distributed shared memory issued together), and store(t, sum)
// writes it.
template <typename F>
__device__ __forceinline__ void cluster_sum(const float* part, int count, F&& store) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (count + ranks - 1) / ranks, t1 = min(count, (rank + 1) * per);
  for (int t = rank * per + (int)threadIdx.x; t < t1; t += blockDim.x) {
    float v[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      v[r] = r < ranks ? cluster.map_shared_rank(part, r)[t] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) sum += v[r];
    store(t, sum);
  }
  cluster.sync();  // the other ranks keep their shared memory until it is read
}

// Natural rows of K a GEMV unit covers.
__host__ __device__ __forceinline__ int unit_rows(int L, int bk, int g) {
  if (L == PLANES) return 32;
  if (L == ROWPAIR) return (bk / 32) % 2 == 0 ? 64 : 32;
  return g;
}

// ---------------------------------------------------------------- GEMV

constexpr int kGemvThreads = 256;
constexpr int kLanes = 8;                        // threads across a block's columns
constexpr int kGemvCols = 8 * kLanes;            // 64 columns per block
constexpr int kSlots = kGemvThreads / kLanes;    // 32 units in flight per block
constexpr int kMaxUnitRows = 64;
constexpr int kXs = kSlots * kMaxUnitRows;       // x row stride in shared memory

// byte rows of a unit walked per chunk
template <int MR>
constexpr int kChunk = MR <= 2 ? 8 : 4;

// Walk byte rows src + r * stride, r = 0 .. rows - 1 (rows a multiple of
// RC), RC at a time, loading the next chunk before f(r, bytes) expands the
// current one.
template <int RC, typename F>
__device__ __forceinline__ void walk_rows(const uint8_t* src, size_t stride, int rows, F&& f) {
  uint2 w[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) w[i] = __ldg(reinterpret_cast<const uint2*>(src + i * stride));
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += RC) {
    uint2 cur[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) cur[i] = w[i];
    if (r0 + RC < rows) {
#pragma unroll
      for (int i = 0; i < RC; ++i)
        w[i] = __ldg(reinterpret_cast<const uint2*>(src + (r0 + RC + i) * stride));
    }
#pragma unroll
    for (int i = 0; i < RC; ++i) f(r0 + i, cur[i]);
  }
}

// acc[m][c] += x[m][e] * w[c] over the 8 columns
template <int MR>
__device__ __forceinline__ void fma_row(float (&acc)[MR][8], const __nv_bfloat16* xr, int e,
                                        const float w[8]) {
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float xv = __bfloat162float(xr[m * kXs + e]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
  }
}

// acc[m][c] += xs[m] * bias[grp][n + c], xs[m] the sum of the group's
// `rows` bf16 x values at xg: the exact f32 bias term
template <int MR, typename ST>
__device__ __forceinline__ void bias_term(const Args& a, float (&acc)[MR][8], int grp, int n,
                                          const __nv_bfloat16* xg, int rows) {
  float bv[8];
  load8(static_cast<const ST*>(a.bias), (size_t)grp * a.N + n, bv);
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float xv = 0.f;
#pragma unroll 4
    for (int e = 0; e < rows; ++e) xv += __bfloat162float(xg[m * kXs + e]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, bv[c], acc[m][c]);
  }
}

// One unit u of columns n .. n + 7; xr: x of the unit's natural rows in
// shared memory (row m at xr[m * kXs]).
template <int L, typename ST, int MR>
__device__ __forceinline__ void gemv_unit(const Args& a, int u, int n, const __nv_bfloat16* xr,
                                          float (&acc)[MR][8]) {
  constexpr int RC = kChunk<MR>;
  const ST* s = static_cast<const ST*>(a.scale);
  const ST* bias = static_cast<const ST*>(a.bias);
  const size_t N = (size_t)a.N;
  if (L == PLANES) {
    const int nb = a.bk / 32, b = u % nb;
    const uint8_t* src = a.q + ((size_t)(u / nb) * (a.bk / 2) + b) * N + n;
    const size_t rlo = (size_t)(32 * u / a.g) * N + n, rhi = (size_t)((32 * u + 16) / a.g) * N + n;
    float slo[8], shi[8], blo[8], bhi[8];
    load8(s, rlo, slo);
    load8(s, rhi, shi);
    const bool has_bias = bias != nullptr;
    if (has_bias) {
      load8(bias, rlo, blo);
      load8(bias, rhi, bhi);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      slo[c] = round_bf16(slo[c]);
      shi[c] = round_bf16(shi[c]);
      blo[c] = has_bias ? round_bf16(blo[c]) : 0.f;
      bhi[c] = has_bias ? round_bf16(bhi[c]) : 0.f;
    }
    const float z = (float)a.zero;
    walk_rows<RC>(src, (size_t)nb * N, 16, [&](int j, uint2 w) {
      float wl[8], wh[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t byte = byte_of(w, c);
        wl[c] = round_bf16(((float)(byte & 0xFu) - z) * slo[c]);
        wh[c] = round_bf16(((float)(byte >> 4) - z) * shi[c]);
        if (has_bias) {
          wl[c] = round_bf16(wl[c] + blo[c]);
          wh[c] = round_bf16(wh[c] + bhi[c]);
        }
      }
      fma_row<MR>(acc, xr, j, wl);
      fma_row<MR>(acc, xr, 16 + j, wh);
    });
  } else if (L == ROWPAIR) {
    const int nb = a.bk / 32;
    if (nb % 2 == 0) {
      // blocks B, B + 1 (b even): byte row (e * nb + b) / 2 of the tile holds
      // element e of both
      const int B = 2 * u, b = B % nb;
      const uint8_t* src = a.q + ((size_t)(B / nb) * (a.bk / 2) + b / 2) * N + n;
      float s0[8], s1[8];
      load8(s, (size_t)B * N + n, s0);
      load8(s, (size_t)(B + 1) * N + n, s1);
#pragma unroll
      for (int c = 0; c < 8; ++c) { s0[c] = round_bf16(s0[c]); s1[c] = round_bf16(s1[c]); }
      walk_rows<RC>(src, (size_t)(nb / 2) * N, 32, [&](int e, uint2 w) {
        float wl[8], wh[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t byte = byte_of(w, c);
          wl[c] = round_bf16(rowpair_value(byte & 0xFu) * s0[c]);
          wh[c] = round_bf16(rowpair_value(byte >> 4) * s1[c]);
        }
        fma_row<MR>(acc, xr, e, wl);
        fma_row<MR>(acc, xr, 32 + e, wh);
      });
      if (bias != nullptr) {
        bias_term<MR, ST>(a, acc, B, n, xr, 32);
        bias_term<MR, ST>(a, acc, B + 1, n, xr + 32, 32);
      }
    } else {
      const int B = u, b = B % nb;
      const size_t row0 = (size_t)(B / nb) * (a.bk / 2);
      float s0[8];
      load8(s, (size_t)B * N + n, s0);
#pragma unroll
      for (int c = 0; c < 8; ++c) s0[c] = round_bf16(s0[c]);
      if (nb == 1) {
        // byte row i holds elements 2i (low) and 2i + 1 (high) of this block
        walk_rows<RC>(a.q + row0 * N + n, N, 16, [&](int i, uint2 w) {
          float wl[8], wh[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const uint32_t byte = byte_of(w, c);
            wl[c] = round_bf16(rowpair_value(byte & 0xFu) * s0[c]);
            wh[c] = round_bf16(rowpair_value(byte >> 4) * s0[c]);
          }
          fma_row<MR>(acc, xr, 2 * i, wl);
          fma_row<MR>(acc, xr, 2 * i + 1, wh);
        });
      } else {
        // odd nb > 1: a byte row pairs elements of two blocks; take one nibble
#pragma unroll 4
        for (int e = 0; e < 32; ++e) {
          const int uu = e * nb + b;
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(a.q + (row0 + (uu >> 1)) * N + n));
          float wv[8];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            wv[c] = round_bf16(rowpair_value((byte_of(w, c) >> (4 * (uu & 1))) & 0xFu) * s0[c]);
          fma_row<MR>(acc, xr, e, wv);
        }
      }
      if (bias != nullptr) bias_term<MR, ST>(a, acc, B, n, xr, 32);
    }
  } else {
    // one group B of g natural rows: stored rows tile * bk + e * nb + b
    const int nb = a.bk / a.g, B = u, b = B % nb;
    const uint8_t* src = a.q + ((size_t)(B / nb) * a.bk + b) * N + n;
    float s0[8];
    load8(s, (size_t)B * N + n, s0);
#pragma unroll
    for (int c = 0; c < 8; ++c) s0[c] = round_bf16(s0[c]);
    walk_rows<RC>(src, (size_t)nb * N, a.g, [&](int e, uint2 w) {
      float wv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) wv[c] = round_bf16((float)(int8_t)byte_of(w, c) * s0[c]);
      fma_row<MR>(acc, xr, e, wv);
    });
    if (bias != nullptr) bias_term<MR, ST>(a, acc, B, n, xr, a.g);
  }
}

// grid (ceil(N / 64), split); block y takes units [y U / split, (y + 1) U / split)
template <int L, typename ST, int MR>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(Args a) {
  // x rows during the K loop, the warps' partial sums after it
  // and the block's sums
  constexpr int kXBytes = MR * kXs * 2, kRedBytes = (kGemvThreads / 32 + 1) * MR * kGemvCols * 4;
  __shared__ __align__(16) unsigned char smem[kXBytes > kRedBytes ? kXBytes : kRedBytes];
  __nv_bfloat16* xsh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  const float* x = static_cast<const float*>(a.x);

  const int lane = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const int n = blockIdx.x * kGemvCols + lane * 8;
  const int ur = unit_rows(L, a.bk, a.g), U = a.K / ur;
  const int u0 = (int)((long long)blockIdx.y * U / a.split);
  const int u1 = (int)((long long)(blockIdx.y + 1) * U / a.split);

  float acc[MR][8];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

  for (int r0 = u0; r0 < u1; r0 += kSlots) {
    const int nu = min(kSlots, u1 - r0), kb = r0 * ur, kc = nu * ur / 8;
    __syncthreads();  // the previous round is done with xsh
    for (int i = threadIdx.x; i < MR * kc; i += kGemvThreads) {
      const int m = i / kc, c = (i % kc) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < a.M) {
        const float4* p = reinterpret_cast<const float4*>(x + (size_t)m * a.K + kb + c);
        const float4 lo = __ldg(p), hi = __ldg(p + 1);
        v = make_uint4(as_u32(__floats2bfloat162_rn(lo.x, lo.y)),
                       as_u32(__floats2bfloat162_rn(lo.z, lo.w)),
                       as_u32(__floats2bfloat162_rn(hi.x, hi.y)),
                       as_u32(__floats2bfloat162_rn(hi.z, hi.w)));
      }
      *reinterpret_cast<uint4*>(xsh + m * kXs + c) = v;
    }
    __syncthreads();
    if (slot < nu && n < a.N) gemv_unit<L, ST, MR>(a, r0 + slot, n, xsh + slot * ur, acc);
  }

  // the warp's 4 slots (lanes 8 and 16 apart), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();  // done with xsh
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < kLanes) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[(warp * MR + m) * kGemvCols + lane * 8 + c] = acc[m][c];
  }
  __syncthreads();
  float* part = red + (kGemvThreads / 32) * MR * kGemvCols;
  auto store = [&](int t, float v) {
    const int m = t / kGemvCols, nn = blockIdx.x * kGemvCols + t % kGemvCols;
    if (m < a.M && nn < a.N) a.out[(size_t)m * a.N + nn] = v;
  };
  for (int t = threadIdx.x; t < MR * kGemvCols; t += kGemvThreads) {
    const int m = t / kGemvCols, col = t % kGemvCols;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvThreads / 32; ++w) v += red[(w * MR + m) * kGemvCols + col];
    if (a.split > 1)
      part[t] = v;
    else
      store(t, v);
  }
  if (a.split > 1) cluster_sum(part, MR * kGemvCols, store);
}

// ---------------------------------------------------------------- tile

constexpr int TBM = 128, TBN = 64, TBK = 64, kTileThreads = 256;
constexpr int LDX = TBK + 8;   // bf16 elements; keeps wmma rows 32-byte aligned
constexpr int LDW = TBN + 8;
constexpr int LDO = TBN + 4;   // f32 staging
constexpr int kMaxGroups = TBK / 16;   // scale rows of one K step, at most
constexpr int kXtBytes = TBM * LDX * 2, kWtBytes = TBK * LDW * 2, kOtBytes = TBM * LDO * 4;
constexpr int kAbBytes = kXtBytes + kWtBytes > kOtBytes ? kXtBytes + kWtBytes : kOtBytes;

struct TileSmem {
  // the x and weight tiles during the K loop, the f32 output tile after it
  unsigned char ab[kAbBytes];
  unsigned short ss[2][kMaxGroups][TBN];   // a step's scale rows, bf16
  float bs[2][kMaxGroups][TBN];    // its bias rows (planes: bf16-rounded)
  float xg[2][TBM][kMaxGroups];    // its per-group x sums (the bias term)
  __device__ __nv_bfloat16* xt() { return reinterpret_cast<__nv_bfloat16*>(ab); }
  __device__ __nv_bfloat16* wt() { return reinterpret_cast<__nv_bfloat16*>(ab + kXtBytes); }
  __device__ float* ot() { return reinterpret_cast<float*>(ab); }
};

// What one thread carries from one step to the next: its raw x and weight
// bytes (whether they are in range, the row-pair nibble shift), and its
// share of the step's scale, bias and x group sums.
struct StepRegs {
  uint4 x[4];
  uint4 w;
  bool in;
  int shift;
  float s, b, xg[TBM * kMaxGroups / kTileThreads];
};

__device__ __forceinline__ int log2_group(int grp) { return grp == 16 ? 4 : 5; }

// Where this thread's weight bytes of successive K steps are stored: the
// step's K tile t and, in it, the quant block b (planes: of the thread's
// half; row-pair with an even NB: the step's first block) or the natural
// row kk (the per-row fill). Advanced one step at a time, so the K loop
// divides by nothing.
template <int L>
struct WCursor {
  int t, b;

  static __device__ __forceinline__ bool per_row(const Args& a) {
    return !(L == PLANES || (L == ROWPAIR && (a.bk / 32) % 2 == 0));
  }

  __device__ __forceinline__ void init(const Args& a, int k0) {
    const int tid = threadIdx.x;
    if (per_row(a)) {
      const int k = k0 + tid / 4;
      t = k / a.bk;
      b = k % a.bk;
    } else {
      const int nb = a.bk / 32, B = k0 / 32 + (L == PLANES ? tid / 128 : 0);
      t = B / nb;
      b = B % nb;
    }
  }

  __device__ __forceinline__ void next(const Args& a) {
    const int step = per_row(a) ? TBK : TBK / 32, span = per_row(a) ? a.bk : a.bk / 32;
    for (b += step; b >= span; b -= span) ++t;
  }

  // this step's bytes (nullptr: out of range) and nibble shift
  __device__ __forceinline__ const uint8_t* src(const Args& a, int k0, int n0, int& shift) const {
    const int tid = threadIdx.x;
    const size_t N = (size_t)a.N;
    shift = 0;
    if (L == PLANES) {
      // half h (32 rows), byte row j of its quant block: elements j and 16 + j
      const int j = (tid % 128) / 8, n = n0 + (tid % 8) * 8;
      if (k0 + 32 * (tid / 128) >= a.K || n >= a.N) return nullptr;
      return a.q + ((size_t)t * (a.bk / 2) + (size_t)j * (a.bk / 32) + b) * N + n;
    } else if (!per_row(a)) {
      // blocks b, b + 1 of the step share byte rows: element e of both. K %
      // bk == 0 and bk % 64 == 0, so the step is in range.
      const int e = tid / 8, n = n0 + (tid % 8) * 8;
      if (n >= a.N) return nullptr;
      return a.q + ((size_t)t * (a.bk / 2) + (size_t)e * (a.bk / 64) + b / 2) * N + n;
    } else {
      // one natural row kk of tile t, 16 columns: its stored row
      const int n = n0 + (tid % 4) * 16;
      if (k0 + tid / 4 >= a.K || n >= a.N) return nullptr;
      const int lg = (L == ROWPAIR) ? 5 : log2_group(a.g);
      const int u = (b & ((1 << lg) - 1)) * (a.bk >> lg) + (b >> lg);
      if (L == ROWPAIR) {
        shift = 4 * (u & 1);
        return a.q + ((size_t)t * (a.bk / 2) + (u >> 1)) * N + n;
      }
      return a.q + ((size_t)t * a.bk + u) * N + n;
    }
  }
};

// Issue step k0's x and weight-byte loads into registers.
template <int L>
__device__ __forceinline__ void load_bytes(const Args& a, const WCursor<L>& cur, StepRegs& r,
                                           int k0, int m0, int n0) {
  const int tid = threadIdx.x;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  // x tile: 128 rows x 64 bf16 = 128 x 8 chunks of 16 bytes; 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kTileThreads, row = c / 8, part = c % 8;
    r.x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + row < a.M && k0 + part * 8 < a.K)
      r.x[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * a.K + k0 + part * 8));
  }
  const uint8_t* p = cur.src(a, k0, n0, r.shift);
  r.in = p != nullptr;
  r.w = make_uint4(0u, 0u, 0u, 0u);
  if (p != nullptr) {
    if (!WCursor<L>::per_row(a)) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      r.w.x = v.x;
      r.w.y = v.y;
    } else {
      r.w = __ldg(reinterpret_cast<const uint4*>(p));
    }
  }
}

// Issue step k0's loads of its scale and bias rows ((64 / group) x 64
// values, one per thread) and, for the bias term, its x group sums.
template <int L, typename ST, bool kBias>
__device__ __forceinline__ void load_scales(const Args& a, StepRegs& r, int k0, int m0, int n0) {
  const int tid = threadIdx.x;
  const ST* s = static_cast<const ST*>(a.scale);
  const ST* bias = static_cast<const ST*>(a.bias);
  const int grp = (L == ROWPAIR) ? 32 : a.g, ng = TBK >> log2_group(grp);
  r.s = r.b = 0.f;
  if (tid < ng * TBN) {
    const int k = k0 + (tid / TBN) * grp, n = n0 + tid % TBN;
    if (k < a.K && n < a.N) {
      const size_t at = (size_t)(k >> log2_group(grp)) * a.N + n;
      r.s = load_scale(s, at);
      if (bias != nullptr) r.b = load_scale(bias, at);
    }
  }
  if (kBias) {
    const int ngrp = a.K / grp;
#pragma unroll
    for (int i = 0; i < TBM * kMaxGroups / kTileThreads; ++i) {
      const int t = tid + i * kTileThreads, row = t / kMaxGroups, j = t % kMaxGroups;
      const int m = m0 + row, k = k0 + j * grp;
      r.xg[i] = (j < ng && m < a.M && k < a.K)
                    ? a.xs[(size_t)m * ngrp + (k >> log2_group(grp))] : 0.f;
    }
  }
}

// Stage the scale, bias and x group sums held in r into buffer `buf`.
template <int L, bool kBias>
__device__ __forceinline__ void stage_scales(const Args& a, TileSmem& sm, const StepRegs& r,
                                             int buf) {
  const int tid = threadIdx.x;
  const int grp = (L == ROWPAIR) ? 32 : a.g, ng = TBK >> log2_group(grp);
  if (tid < ng * TBN) {
    reinterpret_cast<__nv_bfloat16*>(&sm.ss[buf][0][0])[tid] = __float2bfloat16_rn(r.s);
    sm.bs[buf][tid / TBN][tid % TBN] = (L == PLANES) ? round_bf16(r.b) : r.b;
  }
  if (kBias) {
#pragma unroll
    for (int i = 0; i < TBM * kMaxGroups / kTileThreads; ++i) {
      const int t = tid + i * kTileThreads;
      sm.xg[buf][t / kMaxGroups][t % kMaxGroups] = r.xg[i];
    }
  }
}

// Bytes 2p and 2p + 1 of `nibs` (one value 0-15 per byte) as the bf16 pair
// (128 + v0, 128 + v1): the bits 0x4300 | v are exactly 128 + v.
__device__ __forceinline__ __nv_bfloat162 nib_pair(uint32_t nibs, int p) {
  return as_bf162(__byte_perm(nibs, 0u, p == 0 ? 0x4140 : 0x4342) | 0x43004300u);
}

// Byte i of `w` as a signed int8 in f32: flipping its sign bit gives q + 128,
// and the f32 bits 0x4B0000uu are exactly 2^23 + uu.
__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}

// The staged bf16 scales of row `row`, columns c and c + 1.
__device__ __forceinline__ __nv_bfloat162 scale_pair(const TileSmem& sm, int buf, int row, int c) {
  return *reinterpret_cast<const __nv_bfloat162*>(&sm.ss[buf][row][c]);
}

// Store the x bytes of r into the x tile and expand its weight bytes (rows
// k0 .. k0 + 63, columns n0 .. n0 + 63) into the weight tile with the
// scales staged in buffer `buf`, two columns per bf16x2 instruction:
// (v + 128) - (zero + 128) is exact, and mul.rn.bf16x2 rounds the exact
// product once, as the reference's bf16(bf16(q) * bf16(s)) does. Rows past
// K are zeros.
template <int L>
__device__ __forceinline__ void expand_step(const Args& a, TileSmem& sm, const StepRegs& r,
                                            int buf) {
  const int tid = threadIdx.x;
  __nv_bfloat16* xt = sm.xt();
  __nv_bfloat16* wt = sm.wt();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kTileThreads;
    *reinterpret_cast<uint4*>(&xt[(c / 8) * LDX + (c % 8) * 8]) = r.x[i];
  }
  if (L == PLANES || !WCursor<L>::per_row(a)) {
    // 8 columns c8 .. c8 + 7 of two rows: planes the low and high planes of
    // byte row j of half h; row-pair element e of blocks b and b + 1
    int rlo, rhi, slo, shi;
    __nv_bfloat162 off;
    uint32_t lo[2] = {r.w.x & 0x0F0F0F0Fu, r.w.y & 0x0F0F0F0Fu};
    uint32_t hi[2] = {(r.w.x >> 4) & 0x0F0F0F0Fu, (r.w.y >> 4) & 0x0F0F0F0Fu};
    const int c8 = (tid % 8) * 8;
    if (L == PLANES) {
      const int h = tid / 128, j = (tid % 128) / 8, lg = log2_group(a.g);
      rlo = 32 * h + j;
      rhi = rlo + 16;
      slo = rlo >> lg;
      shi = rhi >> lg;
      off = __float2bfloat162_rn(128.f + (float)a.zero);
    } else {
      rlo = tid / 8;
      rhi = rlo + 32;
      slo = 0;
      shi = 1;
      off = __float2bfloat162_rn(136.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) { lo[i] ^= 0x08080808u; hi[i] ^= 0x08080808u; }
    }
    const bool has_bias = L == PLANES && a.bias != nullptr;
    uint32_t ol[4], oh[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = c8 + 2 * p;
      __nv_bfloat162 wl =
          __hmul2(__hsub2(nib_pair(lo[p / 2], p % 2), off), scale_pair(sm, buf, slo, c));
      __nv_bfloat162 wh =
          __hmul2(__hsub2(nib_pair(hi[p / 2], p % 2), off), scale_pair(sm, buf, shi, c));
      if (has_bias) {
        wl = __floats2bfloat162_rn(__low2float(wl) + sm.bs[buf][slo][c],
                                   __high2float(wl) + sm.bs[buf][slo][c + 1]);
        wh = __floats2bfloat162_rn(__low2float(wh) + sm.bs[buf][shi][c],
                                   __high2float(wh) + sm.bs[buf][shi][c + 1]);
      }
      ol[p] = r.in ? as_u32(wl) : 0u;
      oh[p] = r.in ? as_u32(wh) : 0u;
    }
    *reinterpret_cast<uint4*>(&wt[rlo * LDW + c8]) = make_uint4(ol[0], ol[1], ol[2], ol[3]);
    *reinterpret_cast<uint4*>(&wt[rhi * LDW + c8]) = make_uint4(oh[0], oh[1], oh[2], oh[3]);
  } else {
    // one natural row, 16 columns
    const int row = tid / 4, c16 = (tid % 4) * 16;
    const int sr = row >> ((L == ROWPAIR) ? 5 : log2_group(a.g));
    const uint32_t w[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
    const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
    uint32_t o[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      __nv_bfloat162 q;
      if (L == ROWPAIR)
        q = __hsub2(nib_pair(((w[p / 2] >> r.shift) & 0x0F0F0F0Fu) ^ 0x08080808u, p % 2), off);
      else
        q = __floats2bfloat162_rn(int8_at(w[p / 2], 2 * (p % 2)),
                                  int8_at(w[p / 2], 2 * (p % 2) + 1));
      o[p] = r.in ? as_u32(__hmul2(q, scale_pair(sm, buf, sr, c16 + 2 * p))) : 0u;
    }
    *reinterpret_cast<uint4*>(&wt[row * LDW + c16]) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(&wt[row * LDW + c16 + 8]) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// grid (ceil(N / 64), ceil(M / 128), split); block z takes K steps
// [z S / split, (z + 1) S / split) of S = ceil(K / 64). kBias: a row-pair
// or int8 weight with a bias (the exact f32 term).
template <int L, typename ST, bool kBias>
__global__ void __launch_bounds__(kTileThreads, 2) tile_kernel(Args a) {
  __shared__ __align__(128) TileSmem sm;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int M = a.M, K = a.K, N = a.N;
  const int steps = (K + TBK - 1) / TBK;
  const int s0 = (int)((long long)blockIdx.z * steps / a.split);
  const int s1 = (int)((long long)(blockIdx.z + 1) * steps / a.split);
  const int ng = TBK / ((L == ROWPAIR) ? 32 : a.g);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  // the bias term of column tid % 64, rows tid / 64 + 4 i
  float bacc[kBias ? TBM / 4 : 1];
#pragma unroll
  for (int i = 0; i < (kBias ? TBM / 4 : 1); ++i) bacc[i] = 0.f;
  const int bc = tid % TBN, br = tid / TBN;

  // registers: step st's x and weight bytes, step st + 1's scales
  StepRegs r;
  WCursor<L> cur;
  cur.init(a, s0 * TBK);
  if (s0 < s1) {
    load_bytes<L>(a, cur, r, s0 * TBK, m0, n0);
    load_scales<L, ST, kBias>(a, r, s0 * TBK, m0, n0);
    stage_scales<L, kBias>(a, sm, r, 0);
    if (s0 + 1 < s1) load_scales<L, ST, kBias>(a, r, (s0 + 1) * TBK, m0, n0);
  }
  __syncthreads();
  for (int st = s0; st < s1; ++st) {
    const int buf = (st - s0) & 1, k0 = st * TBK;
    expand_step<L>(a, sm, r, buf);
    if (kBias) {
#pragma unroll
      for (int i = 0; i < TBM / 4; ++i) {
        float t = 0.f;
        for (int j = 0; j < ng; ++j) t = fmaf(sm.xg[buf][br + 4 * i][j], sm.bs[buf][j][bc], t);
        bacc[i] += t;
      }
    }
    if (st + 1 < s1) {
      stage_scales<L, kBias>(a, sm, r, buf ^ 1);
      cur.next(a);
      load_bytes<L>(a, cur, r, k0 + TBK, m0, n0);
      if (st + 2 < s1) load_scales<L, ST, kBias>(a, r, k0 + 2 * TBK, m0, n0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &sm.xt()[(wm + 16 * i) * LDX + kk], LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &sm.wt()[kk * LDW + wn + 16 * j], LDW);
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
      wmma::store_matrix_sync(&sm.ot()[(wm + 16 * i) * LDO + wn + 16 * j], acc[i][j], LDO,
                              wmma::mem_row_major);
  __syncthreads();
  float* ot = sm.ot();
  if (a.split == 1) {
    const int n = n0 + bc;
#pragma unroll
    for (int i = 0; i < TBM / 4; ++i) {
      const int row = br + 4 * i, m = m0 + row;
      if (m < M && n < N) a.out[(size_t)m * N + n] = ot[row * LDO + bc] + (kBias ? bacc[i] : 0.f);
    }
    return;
  }
  if (kBias) {
#pragma unroll
    for (int i = 0; i < TBM / 4; ++i) ot[(br + 4 * i) * LDO + bc] += bacc[i];
  }
  // rank 0 adds the cluster's tiles; part index t = row * LDO + column
  cluster_sum(ot, TBM * LDO, [&](int t, float v) {
    const int row = t / LDO, c = t % LDO, m = m0 + row, n = n0 + c;
    if (c < TBN && m < M && n < N) a.out[(size_t)m * N + n] = v;
  });
}

// Launch kern on grid; with split > 1 the split blocks of each output tile
// form one cluster (along y for the GEMV, z for the tile).
template <typename... P>
cudaError_t launch_kernel(void (*kern)(P...), dim3 grid, bool along_y, const Args& a,
                          cudaStream_t st) {
  if (a.split == 1) {
    kern<<<grid, 256, 0, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = along_y ? a.split : 1;
  attr.val.clusterDim.z = along_y ? 1 : a.split;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <int L, typename ST>
cudaError_t launch_typed(const Args& a, cudaStream_t st) {
  if (a.M <= kGemvMaxM) {
    const dim3 grid((a.N + kGemvCols - 1) / kGemvCols, a.split);
    if (a.M == 1) return launch_kernel(gemv_kernel<L, ST, 1>, grid, true, a, st);
    if (a.M <= 2) return launch_kernel(gemv_kernel<L, ST, 2>, grid, true, a, st);
    if (a.M <= 4) return launch_kernel(gemv_kernel<L, ST, 4>, grid, true, a, st);
    return launch_kernel(gemv_kernel<L, ST, 8>, grid, true, a, st);
  }
  const dim3 grid((a.N + TBN - 1) / TBN, (a.M + TBM - 1) / TBM, a.split);
  if (L != PLANES && a.bias != nullptr)
    return launch_kernel(tile_kernel<L, ST, L != PLANES>, grid, false, a, st);
  return launch_kernel(tile_kernel<L, ST, false>, grid, false, a, st);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

template <int L>
int launch(const Args& a, int scale_is_bf16, void* stream) {
  const int grp = (L == ROWPAIR) ? 32 : a.g;
  if (a.M < 1 || a.K % 32 || a.N % 16 || a.bk <= 0 || a.bk % 32 || a.K % a.bk ||
      (grp != 16 && grp != 32) || misaligned(a.x) || misaligned(a.q) ||
      misaligned(a.scale) || (a.bias != nullptr && misaligned(a.bias)) ||
      (L != PLANES && a.bias != nullptr && a.M > kGemvMaxM && a.xs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int units = a.M <= kGemvMaxM ? a.K / unit_rows(L, a.bk, a.g) : (a.K + TBK - 1) / TBK;
  if (a.split < 1 || a.split > units || a.split > kMaxSplit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = scale_is_bf16 ? launch_typed<L, __nv_bfloat16>(a, st)
                                      : launch_typed<L, float>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x (M, K) in natural order: f32 for M <= 8 (the GEMV route, which rounds
// it to bf16), bf16 above (the tile route); out (M, N) f32; scale/bias f32
// or bf16 (bias may be null); bk the layout's K tile. split: the number of
// K pieces, at most 8 (GEMV: at most K / unit rows; tile: at most
// ceil(K / 64)). Requires K % 32 == 0, bk % 32 == 0, K % bk == 0 and
// N % 16 == 0; x, q, scale and bias 16-byte aligned.

// q (K/2, N) u8 planes; scale/bias (K/g, N), g 16 or 32; zero the nibble
// zero point.
extern "C" int ggml_planes_w4a16(const void* x, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int K, int N, int bk,
                                 int g, int zero, int split, int scale_is_bf16, void* stream) {
  const Args a{x, (const uint8_t*)q, scale, bias, nullptr, (float*)out, M, K, N, bk, g, zero,
               split};
  return launch<PLANES>(a, scale_is_bf16, stream);
}

// q (K/2, N) u8 row pairs; scale/bias (K/32, N); xs (M, K/32) f32 on the
// tile route when there is a bias (the GEMV route sums x itself).
extern "C" int ggml_rowpair_w4a16(const void* x, const void* q, const void* scale,
                                  const void* bias, const void* xs, void* out, int M, int K,
                                  int N, int bk, int split, int scale_is_bf16, void* stream) {
  const Args a{x, (const uint8_t*)q, scale, bias, (const float*)xs, (float*)out, M, K, N, bk,
               32, 0, split};
  return launch<ROWPAIR>(a, scale_is_bf16, stream);
}

// q (K, N) int8 u-order rows; scale/bias (K/g, N), g 16 or 32; xs (M, K/g)
// as for the row-pair entry.
extern "C" int ggml_int8_rows_w8a16(const void* x, const void* q, const void* scale,
                                    const void* bias, const void* xs, void* out, int M, int K,
                                    int N, int bk, int g, int split, int scale_is_bf16,
                                    void* stream) {
  const Args a{x, (const uint8_t*)q, scale, bias, (const float*)xs, (float*)out, M, K, N, bk, g,
               0, split};
  return launch<INT8_ROWS>(a, scale_is_bf16, stream);
}
