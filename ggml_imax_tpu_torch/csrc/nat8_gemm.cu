// W8A16 products over nat8 int8 weights (prefill, and any product of more
// than one row).
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_nat8_w8a16_stk (the
// per-layer matmuls) and ::_kernel_nat8_w8a16 (one tensor).
//
// Computes out = bf16(x) @ w with f32 sums, where the weight is rounded
// exactly as the reference rounds it: w = bf16(bf16(q) * bf16(s)), one
// rounding of the product (the scale is cast to bf16 even when it is stored
// f32); plus, with a bias (Q5_0/1, Q5_K, ...), the exact f32 term xs . bias,
// xs the per-group sums of bf16(x). The (K, N) weight keeps its natural row
// order, one scale (and bias) row per g = 16 or 32 rows.
//
// Both tensor-core operands are bit-identical to the reference's. Two bytes
// of one column (two K rows) become the bf16x2 (q0, q1) with no conversion
// instruction: the bf16 trick of w4a16_gemm.cu, 0x4300 | v = 128 + v, holds
// only for v < 128 (bf16 has 7 fraction bits), so it is taken twice, on
// the low 7 bits (128 + (q & 127)) and on the sign bit (128 or 256), and
// one exact sub.bf16x2 of the two gives q. mul.rn.bf16x2 by the bf16 scale
// then rounds the exact product once, as the reference's f32 multiply and
// cast to bf16 do. Five instructions a pair: one prmt, two lop3, the
// subtraction and the product.
//
// Two routes behind the one C entry, chosen by M (ops/qmm.py::nat8_plan
// says the same), and `split`, the number of pieces K is cut into across
// blocks (at most 8; nat8_plan picks it). The split blocks of an output
// tile are one thread-block cluster: each keeps its partial sums in its
// shared memory, and the ranks share out the outputs, each summed over the
// ranks in K order through distributed shared memory. No workspace, no
// float atomics: the same bits on every run.
//
// Small-M route, M <= 8 (an Engine prefill bucket of 8 rows). Bound on the
// H100: bytes (K N weight bytes plus the scale and bias rows over
// 3.35 TB/s). The product is computed transposed, out^T = w^T x^T, with
// mma.sync m16n8k16, as in w4a16_gemm.cu: the weight is the 16-row A
// operand (16 columns of the output a tile) and x the 8-column B operand,
// so M <= 8 wastes no tensor-core rows and each weight is expanded once. A
// warp owns 128 columns: lane (r, t) loads 16 bytes (columns 16 r .. + 15)
// of byte rows 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-row chunk, its A
// fragments for 8 products (column 16 r + 2 j as A row r and 16 r + 2 j + 1
// as A row r + 8 in product j). So each weight byte is read once with
// 16-byte loads, straight into registers, and each scale once per group and
// column. A unit of K is one group (g rows, one scale row); the eight warps
// of a block take every eighth unit of the block's piece of K, the next
// unit's loads in flight while the current one is expanded and multiplied.
// x arrives as f32 and goes straight into the B fragments, rounded to
// bf16 in registers, and the bias term's group sums are taken there: no
// cast launch. Why mma.sync and not an FMA GEMV: the tensor cores take the
// 8 rows' multiply-adds, so the expansion (2.5 instructions a weight) is
// the only per-byte work. A block is 8 warps and fills an SM
// (over 128 registers a thread): ops/qmm.py::nat8_plan keeps the split
// blocks to one wave of 132. (Blocks of 4 warps, two an SM, were slower
// at GPT-2 XL's fc_w with per-32 scales on the H100.)
//
// Tile route, M > 8 (prefill). Bound: the tensor cores at M 512 (2 M K N
// flops), moving toward bytes at M 128 and below. As w4a16_gemm.cu's tile:
// a block owns a 128 x 256 output tile and fills an SM; warpgroup 0 copies,
// warpgroups 1 and 2 each multiply 64 of its rows by the 256 columns with
// wgmma m64n256k16. K goes in steps of 64 rows through a ring of 4 stages
// (3 with f32 scales and a bias) in dynamic shared memory, which the
// copying warpgroup fills by cp.async 2 steps ahead (1 with 3 stages):
// each stage holds the step's 128 x 64 bf16 x slice (in the 128-byte
// swizzle wgmma reads), its 64 int8 rows of 256 bytes (16-byte chunks
// swizzled by the 8-row group), its 2 or 4 scale rows and, with a bias,
// its bias rows and per-group x sums. The two multiplying warpgroups also
// expand the weight: while the tensor cores run step i, each of their 8
// warps expands 32 columns of step i + 1 (8 K rows x 8 columns a thread at
// a time: 8-byte loads, bf16x2 instructions, one 16-byte K-major store a
// column, the scale read once per group and column from the staged row)
// into the other of two swizzled weight tiles, then fence.proxy.async and
// a named barrier between the two warpgroups. With a bias, once a step's
// products are done, its bias term (x sums times bias rows, f32 FMAs,
// group by group) goes into the accumulators. The tile goes through shared
// memory to 16-byte stores of whole rows, masking ragged M and N; with
// split > 1 through the cluster sum.
//
// Why this shape (throwaway variants of this kernel timed on the H100 at
// GPT-2 XL's fc_w, M 512; not kept): with a producer warpgroup that both
// copies and expands, as in w4a16_gemm.cu, the copies, the expansion and
// the products added up instead of overlapping; moving the expansion
// beside the products was faster. No change of the copies helped: the
// weight loaded straight into registers (the loads' latency stalled the
// expansion), x or x and the weight by TMA (no faster), the weight by one
// bulk copy a row (slower); nor did fewer expansion instructions. Adding
// the bias term to one half of the accumulators while the other half's
// wgmma ran made ptxas serialize every wgmma (its warning C7514:
// accumulators of a wgmma in flight are touched), slower than adding it
// after the step's products.
//
// Ragged N: with N % 16 == 0 and 16-byte aligned weight, scale and bias
// rows every copy is 16 bytes; otherwise the loads go element by element,
// masked, into the same registers and stages (slow, but any N works).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmallMaxM = 8;   // ops/qmm.py _A16_SMALL_MAX_M
constexpr int kMaxSplit = 8;    // a portable cluster's blocks (_A16_MAX_SPLIT)
constexpr int kThreads = 256;   // the small-M route's block (one an SM)
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;      // the small-M route's columns a block

struct Args {
  const void* x;      // (M, K): f32 on the small-M route, bf16 on the tile route
  const int8_t* q;    // (K, N)
  const void* scale;  // (K / g, N), f32 or bf16
  const void* bias;   // as scale, or null
  const float* xs;    // (M, K / g) per-group sums of bf16(x): tile route with a bias
  float* out;         // (M, N)
  int M, K, N, g, split;
  int vec;            // N % 16 == 0, weight, scale and bias 16-byte aligned
};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// (q0, q1) * (s, s) as bf16x2, q0 the signed byte i of w0 (the lower K
// row), q1 byte i of w1: the same column in two K rows. One prmt puts the
// two bytes in the low bytes of the halves; then the bf16 bits
// 0x4300 | (q & 127) are exactly 128 + (q & 127), 0x4300 | (q & 128) are
// 128 or 256, and their difference is q, exact.
__device__ __forceinline__ uint32_t expand2(uint32_t w0, uint32_t w1, int i, uint32_t s2) {
  const uint32_t d = __byte_perm(w0, w1, (uint32_t)(i | ((4 + i) << 8)));
  const uint32_t low7 = (d & 0x007F007Fu) | 0x43004300u;
  const uint32_t sign = (d & 0x00800080u) | 0x43004300u;
  return as_u32(__hmul2(__hsub2(as_bf162(low7), as_bf162(sign)), as_bf162(s2)));
}
// (s, s) in bf16 from an f32 scale (round to nearest even) or a bf16 one
__device__ __forceinline__ uint32_t dup_scale(float s) { return as_u32(__float2bfloat162_rn(s)); }
__device__ __forceinline__ uint32_t dup_scale(const uint32_t* w, int i) {
  return __byte_perm(w[i / 2], 0u, (i % 2) ? 0x3232u : 0x1010u);
}

// 16 weight bytes at p, `valid` of them inside N: one 16-byte load when vec
// (then valid is >= 16 or <= 0), else byte loads
__device__ __forceinline__ uint4 load_bytes16(const int8_t* p, int valid, bool vec) {
  if (vec) return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) w[i / 4] |= (uint32_t)__ldg(b + i) << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of scale (or bias) values at p, `valid` of them inside N, loaded
// value by value
template <typename ST>
__device__ __forceinline__ uint4 load_vals16(const ST* p, int valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (sizeof(ST) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) w[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < valid)
        w[i / 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << (16 * (i % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store 4 outputs at columns col .. col + 3 of an output row, masked at N.
__device__ __forceinline__ void store4(float* row, int col, int N, float4 v) {
  if (N % 4 == 0 && col + 4 <= N) {
    *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < N) row[col + i] = e[i];
}

// D += A B, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 consecutive scale (or bias) values as loaded: 4 x 16 bytes of f32 or 2
// of bf16
template <typename ST>
struct Raw16 {
  uint4 v[sizeof(ST) == 4 ? 4 : 2];
  __device__ __forceinline__ void load(const ST* p, int valid, bool vec) {
    constexpr int per = 16 / (int)sizeof(ST);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(v) / 16); ++i)
      v[i] = vec ? (valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0))
                 : load_vals16(p + per * i, valid - per * i);
  }
  __device__ __forceinline__ const uint32_t* words() const {
    return reinterpret_cast<const uint32_t*>(v);
  }
  __device__ __forceinline__ uint32_t dup(int i) const {
    if (sizeof(ST) == 4) return dup_scale(__uint_as_float(words()[i]));
    return dup_scale(words(), i);
  }
  __device__ __forceinline__ float f32(int i) const {
    if (sizeof(ST) == 4) return __uint_as_float(words()[i]);
    return (i % 2) ? bf16_hi(words()[i / 2]) : bf16_lo(words()[i / 2]);
  }
};

// With split > 1 the split blocks of an output tile are one thread-block
// cluster, ranked in K order. After every block put its partial sums at
// part[0 .. count) of its shared memory (16 bytes an item), the ranks share
// the items: each item's sum over the ranks' parts is taken in rank order
// (its loads through distributed shared memory issued together), and
// store(i, sum) writes it.
template <typename F>
__device__ __forceinline__ void cluster_sum(const float4* part, int count, F&& store) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (count + ranks - 1) / ranks, i1 = min(count, (rank + 1) * per);
  for (int i = rank * per + (int)threadIdx.x; i < i1; i += blockDim.x) {
    float4 v[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      v[r] = r < ranks ? cluster.map_shared_rank(part, r)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplit; ++r) {
      sum.x += v[r].x;
      sum.y += v[r].y;
      sum.z += v[r].z;
      sum.w += v[r].w;
    }
    store(i, sum);
  }
  cluster.sync();  // the other ranks keep their shared memory until it is read
}

// ------------------------------------------------------------ small M

// One unit (group of G rows) of one lane as loaded: for each 16-row chunk
// ch, byte rows 2t, 2t + 1, 2t + 8, 2t + 9 at its 16 columns (w[4 ch ..]),
// and x of row r at the chunk's elements 2t, 2t + 1 (x[2 ch]) and 2t + 8,
// 2t + 9 (x[2 ch + 1]) as f32; the scale (and bias) row there.
template <typename ST, int G, bool kBias>
struct Unit {
  uint4 w[G / 4];
  Raw16<ST> s;
  Raw16<ST> b;   // kBias only
  float2 x[G / 8];
};

template <typename ST, int G, bool kBias>
__device__ __forceinline__ void load_unit(const Args& a, int u, int c, int r, int t,
                                          Unit<ST, G, kBias>& un) {
  const size_t N = (size_t)a.N;
  const int k0 = u * G, valid = a.N - c;
#pragma unroll
  for (int ch = 0; ch < G / 16; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 16 * ch + 2 * t + (i & 1) + 8 * (i >> 1);
      un.w[4 * ch + i] = load_bytes16(a.q + (size_t)k * N + c, valid, a.vec);
    }
  un.s.load(static_cast<const ST*>(a.scale) + (size_t)u * N + c, valid, a.vec);
  if (kBias) un.b.load(static_cast<const ST*>(a.bias) + (size_t)u * N + c, valid, a.vec);
  if (r >= a.M) {
#pragma unroll
    for (int i = 0; i < G / 8; ++i) un.x[i] = make_float2(0.f, 0.f);
  } else {
    const float* xp = static_cast<const float*>(a.x) + (size_t)r * a.K + k0 + 2 * t;
#pragma unroll
    for (int i = 0; i < G / 8; ++i) un.x[i] = __ldg(reinterpret_cast<const float2*>(xp + 8 * i));
  }
}

// acc[j]: x rows 2t, 2t + 1 of columns c + 2j ([0], [1]) and c + 2j + 1 ([2], [3])
template <typename ST, int G, bool kBias>
__device__ __forceinline__ void unit_mma(const Unit<ST, G, kBias>& un, int t,
                                         float (&acc)[8][4]) {
  uint32_t s2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s2[i] = un.s.dup(i);
  uint32_t xb[G / 8];
#pragma unroll
  for (int i = 0; i < G / 8; ++i) xb[i] = as_u32(__floats2bfloat162_rn(un.x[i].x, un.x[i].y));
#pragma unroll
  for (int ch = 0; ch < G / 16; ++ch) {
    uint32_t w[4][4];   // rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = un.w[4 * ch + i];
      w[i][0] = v.x;
      w[i][1] = v.y;
      w[i][2] = v.z;
      w[i][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int wi = j / 2, b = 2 * (j % 2);
      const uint32_t af[4] = {expand2(w[0][wi], w[1][wi], b, s2[2 * j]),
                              expand2(w[0][wi], w[1][wi], b + 1, s2[2 * j + 1]),
                              expand2(w[2][wi], w[3][wi], b, s2[2 * j]),
                              expand2(w[2][wi], w[3][wi], b + 1, s2[2 * j + 1])};
      mma(acc[j], af, xb[2 * ch], xb[2 * ch + 1]);
    }
  }
  if (kBias) {
    // the group's sum of bf16(x) for row r, then for rows 2t and 2t + 1
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < G / 8; ++i) sum += bf16_lo(xb[i]) + bf16_hi(xb[i]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float x0 = __shfl_sync(0xffffffffu, sum, 8 * t);
    const float x1 = __shfl_sync(0xffffffffu, sum, 8 * t + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = un.b.f32(2 * j), b1 = un.b.f32(2 * j + 1);
      acc[j][0] = fmaf(x0, b0, acc[j][0]);
      acc[j][1] = fmaf(x1, b0, acc[j][1]);
      acc[j][2] = fmaf(x0, b1, acc[j][2]);
      acc[j][3] = fmaf(x1, b1, acc[j][3]);
    }
  }
}

constexpr int kRedPitch = kCols + 4;   // f32

// grid (ceil(N / 128), split); block y takes the groups of 32-row units
// [y U / split, (y + 1) U / split) of U = K / 32 (nat8_plan's units), warp
// w every eighth group of them from the w-th.
template <typename ST, int G, bool kBias>
__global__ void __launch_bounds__(kThreads, 1) nat8_small_m(Args a) {
  __shared__ __align__(16) float red[kWarps][kSmallMaxM][kRedPitch];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, r = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols, c = n0 + 16 * r;
  const int U = a.K / 32;
  const int u0 = (int)((long long)blockIdx.y * U / a.split) * (32 / G);
  const int u1 = (int)((long long)(blockIdx.y + 1) * U / a.split) * (32 / G);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  Unit<ST, G, kBias> next;
  int u = u0 + warp;
  if (u < u1) load_unit(a, u, c, r, t, next);
#pragma unroll 1
  for (; u < u1; u += kWarps) {
    const Unit<ST, G, kBias> cur = next;
    if (u + kWarps < u1) load_unit(a, u + kWarps, c, r, t, next);
    unit_mma(cur, t, acc);
  }

  // the warps' partial sums in shared memory, then added in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(&red[warp][2 * t][16 * r + 2 * j]) = make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(&red[warp][2 * t + 1][16 * r + 2 * j]) =
        make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  const int m = threadIdx.x / 32, cc = 4 * (threadIdx.x % 32);
  float4 v = *reinterpret_cast<const float4*>(&red[0][m][cc]);
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 p = *reinterpret_cast<const float4*>(&red[w][m][cc]);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  auto store = [&](int i, float4 s) {
    const int mm = i / (kCols / 4);
    if (mm < a.M) store4(a.out + (size_t)mm * a.N, n0 + 4 * (i % (kCols / 4)), a.N, s);
  };
  if (a.split == 1) {
    store(threadIdx.x, v);
    return;
  }
  __syncthreads();   // every warp's row sums are read
  float4* part = reinterpret_cast<float4*>(&red[0][0][0]);
  part[threadIdx.x] = v;
  cluster_sum(part, kSmallMaxM * kCols / 4, store);
}

// ------------------------------------------------------------ tile

constexpr int TBM = 128, TBN = 256, TBK = 64;
// warpgroup 0 copies, warpgroups 1 and 2 expand the weight and multiply
constexpr int kProducer = 128, kTileThreads = 3 * 128;
constexpr int kMaxGroups = TBK / 16;            // scale rows a step (g 16)
constexpr int kXBytes = TBM * TBK * 2;          // x slice, 128-byte rows, swizzled
constexpr int kBBytes = TBN * TBK * 2;          // the expanded weight, K-major, swizzled
constexpr int kPartPitch = TBN + 4;             // f32 partial tile row
constexpr int kSmemMax = 232448;                // a block's dynamic shared memory on the H100
constexpr int kWBytes = TBK * TBN;              // int8 rows, 16-byte chunks swizzled

template <typename ST, bool kBias>
struct Tile {
  static constexpr int kSBytes = kMaxGroups * TBN * (int)sizeof(ST);   // scale (or bias) rows
  static constexpr int kGBytes = kBias ? TBM * kMaxGroups * 4 : 0;    // per-group x sums
  static constexpr int kStageBytes =
      (kXBytes + kWBytes + (kBias ? 2 : 1) * kSBytes + kGBytes + 1023) / 1024 * 1024;
  // the ring, two expanded tiles, and slack to align the base to 1024 bytes
  static constexpr int kStages = 4 * kStageBytes + 2 * kBBytes + 1024 <= kSmemMax ? 4 : 3;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kBBytes + 1024;
  static_assert(TBM * kPartPitch * 4 <= kStages * kStageBytes + 2 * kBBytes,
                "the partial tile reuses the ring and the expanded tiles");
};

template <typename ST, bool kBias>
struct Stage {
  unsigned char* x;   // [TBM][64] bf16, swizzled
  uint8_t* w;         // [TBK][TBN] bytes; chunk c of row k at c ^ (k / 8 % 8)
  uint8_t* s;         // [kMaxGroups][TBN] scale rows
  uint8_t* b;         // [kMaxGroups][TBN] bias rows
  float* xg;          // [TBM][kMaxGroups] per-group x sums
  __device__ __forceinline__ Stage(unsigned char* ring, int i) {
    x = ring + (size_t)i * Tile<ST, kBias>::kStageBytes;
    w = x + kXBytes;
    s = w + kWBytes;
    b = s + Tile<ST, kBias>::kSBytes;
    xg = reinterpret_cast<float*>(b + (kBias ? Tile<ST, kBias>::kSBytes : 0));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (0 fills zeros) of the `size`-byte chunk at src
template <int size>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(size), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Shared-memory writes of this thread (its cp.async copies once waited for,
// its stores) made visible to the wgmma that reads them after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Keep the compiler from moving accesses of the accumulators d[0 .. n)
// across a wgmma issue or wait.
template <int n>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major tile of 64-element (128-byte) rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart, the leading offset
// unused (1), the tile's base 1024-aligned.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define NAT8_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define NAT8_D64(i) NAT8_D8(i), NAT8_D8(i + 8), NAT8_D8(i + 16), NAT8_D8(i + 24), NAT8_D8(i + 32), \
    NAT8_D8(i + 40), NAT8_D8(i + 48), NAT8_D8(i + 56)

// d (64 x 256: this warpgroup's rows) += A B over one K slice of 16: A from
// da (64 rows of x), B from db (256 rows of the expanded weight), both
// K-major. d[4 j + e]: row 16 w + g (+ 8 for e >= 2), column 8 j + 2 t +
// e % 2, for warp w of the warpgroup.
__device__ __forceinline__ void wgmma256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : NAT8_D64(0), NAT8_D64(64)
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// 128-byte swizzle: 16-byte chunk c of row r of a tile sits at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Issue step st's copies into stage sg: rows past M and K, groups past K
// and the columns of a last tile past N are zero-filled. Without vec the
// weight, scale and bias rows are loaded value by value and stored.
template <typename ST, bool kBias>
__device__ __forceinline__ void load_stage(const Args& a, const Stage<ST, kBias>& sg, int st,
                                           int m0, int n0) {
  const int tid = threadIdx.x, k0 = st * TBK;
  const size_t N = (size_t)a.N;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
#pragma unroll
  for (int i = 0; i < TBM * TBK / 8 / kProducer; ++i) {
    const int ch = tid + i * kProducer, row = ch / (TBK / 8), part = ch % (TBK / 8);
    const int m = m0 + row, k = k0 + 8 * part;
    const bool in = m < a.M && k < a.K;
    cp_async<16>(sg.x + swz(row, part), in ? x + (size_t)m * a.K + k : x, in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < TBK * (TBN / 16) / kProducer; ++i) {
    const int ch = tid + i * kProducer, row = ch / (TBN / 16), c = ch % (TBN / 16);
    const int k = k0 + row, col = n0 + 16 * c;
    uint8_t* dst = sg.w + row * TBN + ((c ^ ((row >> 3) & 7)) << 4);
    const bool in = k < a.K && col < a.N;
    if (a.vec)
      cp_async<16>(dst, a.q + (in ? k * N + col : 0), in ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) =
          in ? load_bytes16(a.q + k * N + col, a.N - col, false) : make_uint4(0, 0, 0, 0);
  }
  constexpr int kRowChunks = TBN * (int)sizeof(ST) / 16;   // 16-byte chunks of a scale row
  constexpr int kPer = 16 / (int)sizeof(ST);               // values a chunk
  const int ngrp = TBK / a.g, grp0 = k0 / a.g, groups = a.K / a.g;
  for (int i = tid; i < ngrp * kRowChunks; i += kProducer) {
    const int r = i / kRowChunks, part = i % kRowChunks, col = n0 + kPer * part;
    const bool in = grp0 + r < groups && col < a.N;
    const size_t at = in ? (size_t)(grp0 + r) * N + col : 0;
    const int off = (r * TBN + kPer * part) * (int)sizeof(ST);
#pragma unroll
    for (int j = 0; j < (kBias ? 2 : 1); ++j) {
      const ST* src = static_cast<const ST*>(j ? a.bias : a.scale) + at;
      uint8_t* dst = (j ? sg.b : sg.s) + off;
      if (a.vec)
        cp_async<16>(dst, src, in ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(dst) = in ? load_vals16(src, a.N - col) : make_uint4(0, 0, 0, 0);
    }
  }
  if (kBias) {
    for (int i = tid; i < TBM * ngrp; i += kProducer) {
      const int row = i / ngrp, j = i % ngrp, m = m0 + row;
      const bool in = m < a.M && grp0 + j < groups;
      cp_async<4>(sg.xg + row * kMaxGroups + j, in ? a.xs + (size_t)m * groups + grp0 + j : a.xs,
                  in ? 4 : 0);
    }
  }
}

// Expand 32 columns from `base` of a staged step's int8 rows w into the
// K-major bf16 tile bt: lane (kg = lane % 8, c = lane / 8) takes columns
// base + 8 c .. + 7 and K rows 8 kg .. 8 kg + 7 (one group's scale row):
// eight 8-byte loads, 32 bf16x2 expansions, and one 16-byte store per
// column, none with more bank conflicts than its width needs.
template <typename ST>
__device__ __forceinline__ void expand_cols(const uint8_t* w, const uint8_t* s, int g,
                                            unsigned char* bt, int base) {
  const int lane = threadIdx.x % 32, kg = lane % 8, c = lane / 8;
  const int col0 = base + 8 * c;
  uint2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    v[r] = *reinterpret_cast<const uint2*>(w + (8 * kg + r) * TBN + (((col0 >> 4) ^ kg) << 4) +
                                           (col0 & 15));
  const int sr = g == 32 ? kg >> 2 : kg >> 1;
  const uint8_t* sp = s + (sr * TBN + col0) * sizeof(ST);
  uint32_t s2[8];
  if (sizeof(ST) == 4) {
    const float4 f0 = *reinterpret_cast<const float4*>(sp);
    const float4 f1 = *(reinterpret_cast<const float4*>(sp) + 1);
    const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) s2[j] = dup_scale(f[j]);
  } else {
    const uint4 h = *reinterpret_cast<const uint4*>(sp);
    const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) s2[j] = dup_scale(hw, j);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t e[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      e[p] = expand2(j < 4 ? v[2 * p].x : v[2 * p].y, j < 4 ? v[2 * p + 1].x : v[2 * p + 1].y, j % 4,
                     s2[j]);
    *reinterpret_cast<uint4*>(bt + swz(col0 + j, kg)) = make_uint4(e[0], e[1], e[2], e[3]);
  }
}

// acc += the bias term of a staged step: xs[row][grp] * bias[grp][col]
// over its ngrp groups, for this thread's rows r0, r0 + 8
template <typename ST>
__device__ __forceinline__ void stage_bias(const uint8_t* b, const float* xg, int ngrp, int r0,
                                           int t, float (&acc)[TBN / 2]) {
#pragma unroll
  for (int grp = 0; grp < kMaxGroups; ++grp) {
    if (grp >= ngrp) break;
    const float x0 = xg[r0 * kMaxGroups + grp], x1 = xg[(r0 + 8) * kMaxGroups + grp];
    const ST* bp = reinterpret_cast<const ST*>(b + grp * TBN * sizeof(ST));
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      float b0, b1;
      if (sizeof(ST) == 4) {
        const float2 v = *reinterpret_cast<const float2*>(bp + 8 * j + 2 * t);
        b0 = v.x;
        b1 = v.y;
      } else {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(bp + 8 * j + 2 * t);
        b0 = bf16_lo(v);
        b1 = bf16_hi(v);
      }
      acc[4 * j] = fmaf(x0, b0, acc[4 * j]);
      acc[4 * j + 1] = fmaf(x0, b1, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(x1, b0, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(x1, b1, acc[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// named barriers: kFull + b, step i's stage (b = i % 2) has landed; kEmpty
// + b, the step that used stage i % kStages is done with it; kPair, both
// consumer warpgroups are done with the previous step's products, so the
// tile they read is free; kExpanded, both have expanded their halves of
// the next step's tile
constexpr int kFull = 1, kEmpty = 3, kPair = 5, kExpanded = 6;

// grid (ceil(M / 128), ceil(N / 256), split); block z takes K steps
// [z S / split, (z + 1) S / split) of S = ceil(K / 64). Warpgroup 0 only
// copies, kStages - 2 steps ahead. Warpgroup 1 + h multiplies rows
// 64 h .. 64 h + 63 of the tile by its 256 columns and, while the tensor
// cores run step i, expands its half of step i + 1's weight into the
// other of the two weight tiles; with a bias, once step i's products are
// done, it adds step i's bias term to the accumulators.
template <typename ST, bool kBias>
__global__ void __launch_bounds__(kTileThreads, 1) nat8_tile(Args a) {
  constexpr int kStages = Tile<ST, kBias>::kStages;
  using Sg = Stage<ST, kBias>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const bt = ring + kStages * Tile<ST, kBias>::kStageBytes;   // two expanded tiles
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int steps = (a.K + TBK - 1) / TBK;
  const int s0 = (int)((long long)blockIdx.z * steps / a.split);
  const int n_st = (int)((long long)(blockIdx.z + 1) * steps / a.split) - s0;

  float acc[TBN / 2];   // columns 0 .. 127 in acc[0 .. 63], 128 .. 255 in acc[64 ..]
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;
  const int r0 = 64 * (wg - 1) + 16 * ((threadIdx.x % 128) / 32) + g;   // consumer's first row
  // a consumer warp's 32 columns of the expanded tile
  const int ecol = 32 * (threadIdx.x / 32 - 4);

  if (wg == 0) {
#pragma unroll
    for (int p = 0; p < kStages - 2; ++p) {
      if (p < n_st) load_stage<ST, kBias>(a, Sg(ring, p), s0 + p, m0, n0);
      cp_async_commit();
    }
#pragma unroll 1
    for (int i = 0; i < n_st; ++i) {
      if (i >= 2) bar_sync(kEmpty + i % 2, kTileThreads);   // step i - 2 is done
      const int nx = i + kStages - 2;                        // into step i - 2's stage
      if (nx < n_st) load_stage<ST, kBias>(a, Sg(ring, nx % kStages), s0 + nx, m0, n0);
      cp_async_commit();
      cp_async_wait<kStages - 2>();                          // this thread's copies of step i
      fence_proxy_async();
      bar_arrive(kFull + i % 2, kTileThreads);
    }
    cp_async_wait<0>();
  } else {
    const int ngrp = TBK / a.g;
    // step 0's tile
    bar_sync(kFull, kTileThreads);
    {
      const Sg sg(ring, 0);
      expand_cols<ST>(sg.w, sg.s, a.g, bt, ecol);
    }
    fence_proxy_async();
    bar_sync(kExpanded, 256);
#pragma unroll 1
    for (int i = 0; i < n_st; ++i) {
      const Sg cur(ring, i % kStages);
      const uint32_t xa = smem_addr(cur.x) + (wg - 1) * 64 * 128;
      const uint32_t wb = smem_addr(bt + (i % 2) * kBBytes);
      const bool more = i + 1 < n_st;
      // once both warpgroups' products of step i - 1 are done: free its stage
      // for the copies, and expand step i + 1 into the tile it read
      auto next_tile = [&]() {
        bar_sync(kPair, 256);
        if (i >= 1) bar_arrive(kEmpty + (i - 1) % 2, kTileThreads);
        bar_sync(kFull + (i + 1) % 2, kTileThreads);
        const Sg nx(ring, (i + 1) % kStages);
        expand_cols<ST>(nx.w, nx.s, a.g, bt + ((i + 1) % 2) * kBBytes, ecol);
        fence_proxy_async();
      };
      fence_regs<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) wgmma256(acc, desc128(xa + 32 * kk), desc128(wb + 32 * kk));
      wgmma_commit();
      if (more) {
        wgmma_wait<1>();   // step i - 1's products are done
        fence_regs<128>(acc);
        next_tile();
      }
      if (kBias) {
        // the bias term once the step's products are done: touching the
        // accumulators of a wgmma in flight would serialize every wgmma
        wgmma_wait<0>();
        fence_regs<128>(acc);
        stage_bias<ST>(cur.b, cur.xg, ngrp, r0, t, acc);
      }
      if (more) bar_sync(kExpanded, 256);
    }
    wgmma_wait<0>();
    fence_regs<128>(acc);
  }
  __syncthreads();   // every warpgroup is done with the ring and the tiles

  // the tile through shared memory, then 16-byte stores of whole rows (or
  // the cluster's sum of the split blocks' tiles)
  float* part = reinterpret_cast<float*>(ring);
  if (wg > 0) {
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      *reinterpret_cast<float2*>(part + r0 * kPartPitch + 8 * j + 2 * t) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (r0 + 8) * kPartPitch + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  auto store = [&](int i, float4 v) {
    const int row = i / (kPartPitch / 4), col = 4 * (i % (kPartPitch / 4)), m = m0 + row;
    if (col < TBN && m < a.M) store4(a.out + (size_t)m * a.N, n0 + col, a.N, v);
  };
  const float4* part4 = reinterpret_cast<const float4*>(part);
  if (a.split == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < TBM * kPartPitch / 4; i += kTileThreads) store(i, part4[i]);
    return;
  }
  cluster_sum(part4, TBM * kPartPitch / 4, store);
}

// Launch kern on grid (dynamic shared memory smem); with split > 1 the split
// blocks of each output tile form one cluster along `along` (1 y, 2 z).
template <typename... P>
cudaError_t launch_kernel(void (*kern)(P...), dim3 grid, int threads, int along, int smem,
                          const Args& a, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = along == 1 ? a.split : 1;
  attr.val.clusterDim.z = along == 2 ? a.split : 1;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

template <typename ST>
cudaError_t launch_typed(const Args& a, cudaStream_t st) {
  const bool bias = a.bias != nullptr;
  if (a.M <= kSmallMaxM) {
    const dim3 grid((a.N + kCols - 1) / kCols, a.split);
    if (a.g == 16)
      return bias ? launch_kernel(nat8_small_m<ST, 16, true>, grid, kThreads, 1, 0, a, st)
                  : launch_kernel(nat8_small_m<ST, 16, false>, grid, kThreads, 1, 0, a, st);
    return bias ? launch_kernel(nat8_small_m<ST, 32, true>, grid, kThreads, 1, 0, a, st)
                : launch_kernel(nat8_small_m<ST, 32, false>, grid, kThreads, 1, 0, a, st);
  }
  const dim3 grid((a.M + TBM - 1) / TBM, (a.N + TBN - 1) / TBN, a.split);
  return bias ? launch_kernel(nat8_tile<ST, true>, grid, kTileThreads, 2, Tile<ST, true>::kSmem, a, st)
              : launch_kernel(nat8_tile<ST, false>, grid, kTileThreads, 2, Tile<ST, false>::kSmem, a,
                              st);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x (M, K): f32 for M <= 8 (the small-M route, which rounds it to bf16),
// bf16 above (the tile route); q (K, N) int8 in natural row order;
// scale/bias (K/g, N) f32 or bf16 (bias may be null); xs (M, K/g) f32
// per-group sums of bf16(x), needed on the tile route with a bias; out
// (M, N) f32. split: the number of K pieces, at most 8 (small-M:
// at most K / 32; tile: at most ceil(K / 64)). Requires g in {16, 32},
// K % 32 == 0 and x 16-byte aligned; M and N are free.
extern "C" int ggml_nat8_gemm(const void* x, const void* q, const void* scale,
                              const void* bias, const void* xs, void* out, int M, int K,
                              int N, int g, int split, int scale_is_bf16, void* stream) {
  const bool small = M <= kSmallMaxM;
  const int units = small ? K / 32 : (K + TBK - 1) / TBK;
  if (M < 1 || N < 1 || K < 32 || K % 32 || (g != 16 && g != 32) || misaligned(x) ||
      (bias != nullptr && !small && xs == nullptr) || split < 1 || split > kMaxSplit ||
      split > units)
    return (int)cudaErrorInvalidValue;
  const int vec = N % 16 == 0 && !misaligned(q) && !misaligned(scale) &&
                  (bias == nullptr || !misaligned(bias));
  const Args a{x, (const int8_t*)q, scale, bias, (const float*)xs, (float*)out,
               M, K, N, g, split, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = scale_is_bf16 ? launch_typed<__nv_bfloat16>(a, st)
                                      : launch_typed<float>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
