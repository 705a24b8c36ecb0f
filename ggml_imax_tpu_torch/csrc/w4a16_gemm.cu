// W4A16 products over natpair int4 weights (prefill, and the serving
// ubatches of at least 2 rows).
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_natpair_w4a16_stk (the
// per-layer matmuls) and ::_kernel_natpair_w4a16 (the LM head).
//
// Computes out = bf16(x) @ w with f32 sums, where the weight is rounded
// exactly as the reference rounds it: w = bf16(bf16(q - 8) * bf16(s)), q - 8
// the signed nibble; plus, with a bias (Q4_1, Q4_K), the exact f32 term
// xs . bias, xs the per-32 sums of bf16(x). Byte row i of the (K/2, N)
// weight holds elements 2i (low nibble) and 2i + 1 (high nibble), each XOR 8,
// so a quant block is 16 consecutive byte rows and one byte is exactly the
// pair of K elements an mma.sync fragment register holds.
//
// Both tensor-core operands are bit-identical to the reference's. A byte
// becomes a bf16 pair without any f32 work: the bits 0x4300 | v are exactly
// 128 + v, so one prmt and one lop3 give (128 + q_lo, 128 + q_hi), an exact
// subtraction of 136 gives (q_lo - 8, q_hi - 8), and mul.rn.bf16x2 by the
// bf16 scale rounds the exact product once, as the reference's f32 multiply
// and cast to bf16 do.
//
// Two routes behind the one C entry, chosen by M (ops/qmm.py::natpair_plan
// says the same), and `split`, the number of pieces K is cut into across
// blocks (at most 8; natpair_plan picks it to fill the 132 SMs). The split
// blocks of an output tile are one thread-block cluster:
// each keeps its partial sums in its shared memory, and the ranks share out
// the outputs, each summed over the ranks in K order through distributed
// shared memory. No workspace, no float atomics: the same bits on every run.
//
// Small-M route, M <= 8 (serving's decode-only ubatches). Bound on the H100:
// bytes (K N / 2 weight bytes plus the scale rows over 3.35 TB/s). The
// product is computed transposed, out^T = w^T x^T, with mma.sync m16n8k16:
// the weight is the 16-row A operand (16 columns of the output a tile) and x
// the 8-column B operand, so M <= 8 wastes no tensor-core rows and each
// weight is expanded once. A warp owns 128 columns: lane (g, t) loads 16
// bytes (columns 16 g .. 16 g + 15) of byte rows t and t + 4 of each 8-row
// chunk, and those 32 bytes are its A fragments for 8 products, column
// 16 g + 2 j (A row g) and 16 g + 2 j + 1 (A row g + 8) in product j. So each
// weight byte is read once with 16-byte loads, straight into registers, and
// each scale once per quant block and column. A unit of K is one quant
// block; the eight warps of a block take every eighth unit, the next unit's
// weight, scale and x loads in flight while the current one is expanded and
// multiplied (a loop over units, not unrolled: fully unrolled units were
// instruction-fetch bound in csrc/permuted_gemm.cu). x arrives as f32 and is
// read once per block, each warp loading the x of its own units straight
// into its B fragments and rounding it to bf16 there: no cast launch. The
// warps' partial sums meet in shared memory in a fixed order.
//
// Tile route, M > 8 (prefill, mixed serving ubatches). Bound: the tensor
// cores at M 512 (2 M K N flops), moving toward bytes at M 128 and below. A
// block owns a 128 x 256 output tile and fills an SM: warpgroup 0 produces,
// warpgroups 1 and 2 each multiply 64 of its rows by all 256 columns with
// wgmma m64n256k16 (f32 sums in 128 registers a thread). K goes in steps of
// 64 rows (two quant blocks) through a ring of 4 stages (29 KB each) in
// dynamic shared memory, which the producer fills by cp.async two steps
// ahead: each stage holds the step's 128 x 64 bf16 x slice (in the 128-byte
// swizzle wgmma reads), its 32 packed byte rows, its two scale rows (and
// bias rows) and, with a bias, its per-group x sums. The producer expands
// each step's bytes with bf16x2 instructions into one of two K-major
// swizzled weight tiles (each thread 8 columns x 8 K rows at a time: 8-byte
// loads and 16-byte stores), issues fence.proxy.async and hands the tile to
// the consumers through named barriers, while they multiply the step
// before. The bias term is added step by step from the staged group sums
// (after the step's products retire). The tile goes through shared memory
// to 16-byte stores of whole rows, masking ragged M and N; with split > 1
// through the cluster sum. Why this shape (H100 readings): an x slice is
// read again from L2 by every block of its rows, so 256 columns a block
// halve that traffic against 128; mma.sync with the weight expanded
// straight into B fragments stopped near 300 TFLOP/s at M 512.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmallMaxM = 8;   // ops/qmm.py _NATPAIR_SMALL_MAX_M
constexpr int kMaxSplit = 8;    // a portable cluster's blocks (_NATPAIR_MAX_SPLIT)
constexpr int kThreads = 256;    // the small-M route's block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;       // the small-M route's columns a block

struct Args {
  const void* x;      // (M, K): f32 on the small-M route, bf16 on the tile route
  const uint8_t* q;   // (K / 2, N)
  const void* scale;  // (K / 32, N), f32 or bf16
  const void* bias;   // as scale, or null
  const float* xs;    // (M, K / 32) per-group sums of bf16(x): tile route with a bias
  float* out;         // (M, N)
  int M, K, N, split;
};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// (q_lo - 8, q_hi - 8) * (s, s) as bf16x2 for byte j of w (wh = w >> 4):
// the two K elements of one column.
__device__ __forceinline__ uint32_t expand(uint32_t w, uint32_t wh, int j, uint32_t s2) {
  const uint32_t d = __byte_perm(w, wh, (uint32_t)(j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)));
  const uint32_t v = (d & 0x000F000Fu) ^ 0x43084308u;   // (128 + q_lo, 128 + q_hi)
  // 0x4308 is 136 in bf16
  return as_u32(__hmul2(__hsub2(as_bf162(v), as_bf162(0x43084308u)), as_bf162(s2)));
}

// (s, s) in bf16 from an f32 scale (round to nearest even) or a bf16 one
__device__ __forceinline__ uint32_t dup_scale(float s) { return as_u32(__float2bfloat162_rn(s)); }
__device__ __forceinline__ uint32_t dup_scale(const uint32_t* w, int i) {
  return __byte_perm(w[i / 2], 0u, (i % 2) ? 0x3232u : 0x1010u);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

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
  __device__ __forceinline__ void load(const ST* p) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(v) / 16); ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
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

// One unit (quant block) of one lane as loaded: byte rows t, t + 4, t + 8,
// t + 12 at its 16 columns, the scale (and bias) row there, and x of row g
// at the unit's elements 2t, 2t + 1 of each 8-element quarter.
template <typename ST, bool kBias>
struct Unit {
  uint4 w[4];
  Raw16<ST> s;
  Raw16<ST> b;   // kBias only
  float2 x[4];
};

template <typename ST, bool kBias>
__device__ __forceinline__ void load_unit(const Args& a, int u, int c, int g, int t,
                                          Unit<ST, kBias>& r) {
  const size_t N = (size_t)a.N;
  const uint8_t* p = a.q + ((size_t)16 * u + t) * N + c;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.w[i] = __ldg(reinterpret_cast<const uint4*>(p + 4 * i * N));
  r.s.load(static_cast<const ST*>(a.scale) + (size_t)u * N + c);
  if (kBias) r.b.load(static_cast<const ST*>(a.bias) + (size_t)u * N + c);
  if (g < a.M) {
    const float* xp = static_cast<const float*>(a.x) + (size_t)g * a.K + 32 * u + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.x[i] = __ldg(reinterpret_cast<const float2*>(xp + 8 * i));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) r.x[i] = make_float2(0.f, 0.f);
  }
}

// acc[j]: rows 2t, 2t + 1 of columns c + 2j ([0], [1]) and c + 2j + 1 ([2], [3])
template <typename ST, bool kBias>
__device__ __forceinline__ void unit_mma(const Unit<ST, kBias>& r, int t, float (&acc)[8][4]) {
  uint32_t s2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s2[i] = r.s.dup(i);
  uint32_t xb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xb[i] = as_u32(__floats2bfloat162_rn(r.x[i].x, r.x[i].y));
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const uint32_t lo[4] = {r.w[2 * ch].x, r.w[2 * ch].y, r.w[2 * ch].z, r.w[2 * ch].w};
    const uint32_t hi[4] = {r.w[2 * ch + 1].x, r.w[2 * ch + 1].y, r.w[2 * ch + 1].z,
                            r.w[2 * ch + 1].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t wl = lo[j / 2], wh = hi[j / 2];
      const int b = 2 * (j % 2);
      const uint32_t af[4] = {expand(wl, wl >> 4, b, s2[2 * j]),
                              expand(wl, wl >> 4, b + 1, s2[2 * j + 1]),
                              expand(wh, wh >> 4, b, s2[2 * j]),
                              expand(wh, wh >> 4, b + 1, s2[2 * j + 1])};
      mma(acc[j], af, xb[2 * ch], xb[2 * ch + 1]);
    }
  }
  if (kBias) {
    // the unit's sum of bf16(x) for row g, then for rows 2t and 2t + 1
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += bf16_lo(xb[i]) + bf16_hi(xb[i]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float x0 = __shfl_sync(0xffffffffu, sum, 8 * t);
    const float x1 = __shfl_sync(0xffffffffu, sum, 8 * t + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = r.b.f32(2 * j), b1 = r.b.f32(2 * j + 1);
      acc[j][0] = fmaf(x0, b0, acc[j][0]);
      acc[j][1] = fmaf(x1, b0, acc[j][1]);
      acc[j][2] = fmaf(x0, b1, acc[j][2]);
      acc[j][3] = fmaf(x1, b1, acc[j][3]);
    }
  }
}

constexpr int kRedPitch = kCols + 4;   // f32

// grid (N / 128, split); block y takes units [y U / split, (y + 1) U / split)
// of U = K / 32, warp w every eighth of them from the w-th.
template <typename ST, bool kBias>
__global__ void __launch_bounds__(kThreads, kBias ? 1 : 2) w4a16_small_m(Args a) {
  __shared__ __align__(16) float red[kWarps][kSmallMaxM][kRedPitch];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols, c = n0 + 16 * g;
  const int U = a.K / 32;
  const int u0 = (int)((long long)blockIdx.y * U / a.split);
  const int u1 = (int)((long long)(blockIdx.y + 1) * U / a.split);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  Unit<ST, kBias> next;
  int u = u0 + warp;
  if (u < u1) load_unit(a, u, c, g, t, next);
#pragma unroll 1
  for (; u < u1; u += kWarps) {
    const Unit<ST, kBias> cur = next;
    if (u + kWarps < u1) load_unit(a, u + kWarps, c, g, t, next);
    unit_mma(cur, t, acc);
  }

  // the warps' partial sums in shared memory, then added in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(&red[warp][2 * t][16 * g + 2 * j]) = make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(&red[warp][2 * t + 1][16 * g + 2 * j]) =
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
    if (mm < a.M)
      *reinterpret_cast<float4*>(a.out + (size_t)mm * a.N + n0 + 4 * (i % (kCols / 4))) = s;
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

constexpr int TBM = 128, TBN = 256, TBK = 64, kStages = 4;
// warpgroup 0 loads and expands, warpgroups 1 and 2 multiply
constexpr int kProducer = 128, kTileThreads = 3 * 128;
constexpr int kXBytes = TBM * TBK * 2;          // x slice, 128-byte rows, swizzled
constexpr int kWBytes = (TBK / 2) * TBN;        // packed byte rows, 16-byte chunks swizzled
constexpr int kSBytes = (TBK / 32) * TBN * 4;   // f32 scale rows; bf16 uses half
constexpr int kGBytes = TBM * (TBK / 32) * 4;   // per-group x sums
constexpr int kStageBytes = kXBytes + kWBytes + 2 * kSBytes + kGBytes;   // 29 KB
constexpr int kBBytes = TBN * TBK * 2;          // the expanded weight, K-major, swizzled
constexpr int kPartPitch = TBN + 4;             // f32 partial tile row
// the ring, two expanded tiles, and slack to align the base to 1024 bytes
constexpr int kTileSmem = kStages * kStageBytes + 2 * kBBytes + 1024;
static_assert(kStageBytes % 1024 == 0 && kXBytes % 1024 == 0, "swizzled tiles stay 1024-aligned");
static_assert(TBM * kPartPitch * 4 <= kStages * kStageBytes + 2 * kBBytes,
              "the partial tile reuses the ring and the expanded tiles");

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

// Descriptor of a K-major tile of 64-element (128-byte) rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart, the leading offset
// unused (1), the tile's base 1024-aligned.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 256, this warpgroup's rows) += A B over one K slice of 16: A from
// da (64 rows of x), B from db (256 rows of the expanded weight), both
// K-major. d[4 j + e]: row 16 w + g (+ 8 for e >= 2), column 8 j + 2 t + e % 2
// for warp w of the warpgroup.
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da, uint64_t db) {
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// 128-byte swizzle: 16-byte chunk c of row r of a tile sits at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

struct Stage {
  unsigned char* x;   // [TBM][64] bf16, swizzled
  uint8_t* w;         // [TBK / 2][TBN] bytes; chunk c of byte row r at c ^ (r / 4 % 8)
  uint8_t* s;         // [2][TBN] scale rows
  uint8_t* b;         // [2][TBN] bias rows
  float* xg;          // [TBM][2] per-group x sums
  __device__ __forceinline__ Stage(unsigned char* ring, int i) {
    x = ring + (size_t)i * kStageBytes;
    w = x + kXBytes;
    s = w + kWBytes;
    b = s + kSBytes;
    xg = reinterpret_cast<float*>(b + kSBytes);
  }
};

// Issue step st's copies into stage `sg`: rows past M and K, groups past
// K and the columns of a last tile past N are zero-filled.
template <typename ST, bool kBias>
__device__ __forceinline__ void load_stage(const Args& a, const Stage& sg, int st, int m0, int n0) {
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
  for (int i = 0; i < (TBK / 2) * (TBN / 16) / kProducer; ++i) {
    const int ch = tid + i * kProducer, row = ch / (TBN / 16), c = ch % (TBN / 16);
    const int br = k0 / 2 + row;
    const bool in = br < a.K / 2 && n0 + 16 * c < a.N;
    cp_async<16>(sg.w + row * TBN + ((c ^ ((row >> 2) & 7)) << 4),
                 a.q + (in ? br * N + n0 + 16 * c : 0), in ? 16 : 0);
  }
  constexpr int kRowChunks = TBN * (int)sizeof(ST) / 16;   // 16-byte chunks of a scale row
  static_assert(2 * kRowChunks <= kProducer, "a scale chunk per thread");
  const int grp0 = k0 / 32;
  if (tid < 2 * kRowChunks) {
    const int r = tid / kRowChunks, part = tid % kRowChunks;
    const bool in = grp0 + r < a.K / 32 && n0 + 16 / (int)sizeof(ST) * part < a.N;
    const size_t at = in ? (size_t)(grp0 + r) * N + n0 : 0;
    cp_async<16>(sg.s + r * TBN * sizeof(ST) + 16 * part,
                 reinterpret_cast<const uint8_t*>(static_cast<const ST*>(a.scale) + at) + 16 * part,
                 in ? 16 : 0);
    if (kBias)
      cp_async<16>(sg.b + r * TBN * sizeof(ST) + 16 * part,
                   reinterpret_cast<const uint8_t*>(static_cast<const ST*>(a.bias) + at) + 16 * part,
                   in ? 16 : 0);
  }
  if (kBias) {
#pragma unroll
    for (int i = 0; i < TBM * 2 / kProducer; ++i) {
      const int row = (tid + i * kProducer) / 2, j = tid % 2, m = m0 + row;
      const bool in = m < a.M && grp0 + j < a.K / 32;
      cp_async<4>(sg.xg + 2 * row + j, in ? a.xs + (size_t)m * (a.K / 32) + grp0 + j : a.xs,
                  in ? 4 : 0);
    }
  }
}

// Expand 32 columns from `base` of a staged step's packed weight into the
// K-major bf16 tile bt: lane (kg = lane % 8, c = lane / 8) takes columns
// base + 8 c .. + 7 and K rows 8 kg .. 8 kg + 7 (byte rows 4 kg .. + 3, one
// quant block's scale row): four 8-byte loads, 32 bf16x2 expansions, and
// one 16-byte store per column, none with more bank conflicts than its
// width needs.
template <typename ST>
__device__ __forceinline__ void expand_cols(const Stage& sg, unsigned char* bt, int base) {
  const int lane = threadIdx.x % 32, kg = lane % 8, c = lane / 8;
  const int col0 = base + 8 * c;
  uint2 w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    w[r] = *reinterpret_cast<const uint2*>(sg.w + (4 * kg + r) * TBN + (((col0 >> 4) ^ kg) << 4) +
                                           (col0 & 15));
  const uint8_t* sp = sg.s + ((kg >> 2) * TBN + col0) * sizeof(ST);
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
    for (int r = 0; r < 4; ++r) {
      const uint32_t word = j < 4 ? w[r].x : w[r].y;
      e[r] = expand(word, word >> 4, j % 4, s2[j]);
    }
    *reinterpret_cast<uint4*>(bt + swz(col0 + j, kg)) = make_uint4(e[0], e[1], e[2], e[3]);
  }
}

// acc += the bias term of a staged step: xs[row][grp] * bias[grp][col] over
// its two groups, for this thread's rows r0, r0 + 8 and columns of acc
template <typename ST>
__device__ __forceinline__ void stage_bias(const Stage& sg, int r0, int t, float (&acc)[TBN / 2]) {
#pragma unroll
  for (int grp = 0; grp < TBK / 32; ++grp) {
    const float x0 = sg.xg[2 * r0 + grp], x1 = sg.xg[2 * (r0 + 8) + grp];
    const ST* bp = reinterpret_cast<const ST*>(sg.b + grp * TBN * sizeof(ST));
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
// named barriers: kFull + b, step i's tile b = i % 2 is expanded and its
// stage has landed; kEmpty + b, the products (and bias term) of the step
// that used tile b are done, so the tile and that step's stage are free;
// kLanded, every producer thread's copies of a step have landed
constexpr int kFull = 1, kEmpty = 3, kLanded = 5;

// grid (ceil(M / 128), ceil(N / 256), split); block z takes K steps
// [z S / split, (z + 1) S / split) of S = ceil(K / 64). Warpgroup 0 keeps
// the copies kStages - 2 steps ahead and expands each step into one of the
// two weight tiles; warpgroup 1 + h multiplies rows 64 h .. 64 h + 63 of the
// tile by all its 256 columns.
template <typename ST, bool kBias>
__global__ void __launch_bounds__(kTileThreads, 1) w4a16_tile(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* const bt = ring + kStages * kStageBytes;   // two expanded tiles
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int steps = (a.K + TBK - 1) / TBK;
  const int s0 = (int)((long long)blockIdx.z * steps / a.split);
  const int n_st = (int)((long long)(blockIdx.z + 1) * steps / a.split) - s0;

  float acc[TBN / 2];
#pragma unroll
  for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;
  const int r0 = 64 * (wg - 1) + 16 * ((threadIdx.x % 128) / 32) + g;   // consumer's first row

  if (wg == 0) {
#pragma unroll
    for (int p = 0; p < kStages - 2; ++p) {
      if (p < n_st) load_stage<ST, kBias>(a, Stage(ring, p), s0 + p, m0, n0);
      cp_async_commit();
    }
#pragma unroll 1
    for (int i = 0; i < n_st; ++i) {
      if (i >= 2) bar_sync(kEmpty + i % 2, kTileThreads);   // step i - 2 is done
      const int nx = i + kStages - 2;                        // into step i - 2's stage
      if (nx < n_st) load_stage<ST, kBias>(a, Stage(ring, nx % kStages), s0 + nx, m0, n0);
      cp_async_commit();
      cp_async_wait<kStages - 2>();                          // this thread's copies of step i
      bar_sync(kLanded, kProducer);                          // everyone's
      const Stage sg(ring, i % kStages);
      unsigned char* tile = bt + (i % 2) * kBBytes;
      expand_cols<ST>(sg, tile, 64 * (threadIdx.x / 32));
      expand_cols<ST>(sg, tile, 64 * (threadIdx.x / 32) + 32);
      fence_proxy_async();
      bar_arrive(kFull + i % 2, kTileThreads);
    }
    cp_async_wait<0>();
  } else {
#pragma unroll 1
    for (int i = 0; i < n_st; ++i) {
      bar_sync(kFull + i % 2, kTileThreads);
      const Stage cur(ring, i % kStages);
      const uint32_t xa = smem_addr(cur.x) + (wg - 1) * 64 * 128;
      const uint32_t wb = smem_addr(bt + (i % 2) * kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) wgmma256(acc, desc128(xa + 32 * kk), desc128(wb + 32 * kk));
      wgmma_commit();
      if (kBias) {
        wgmma_wait<0>();
        stage_bias<ST>(cur, r0, t, acc);
        if (i + 2 < n_st) bar_arrive(kEmpty + i % 2, kTileThreads);
      } else {
        wgmma_wait<1>();   // step i - 1's products are done
        if (i >= 1 && i + 1 < n_st) bar_arrive(kEmpty + (i - 1) % 2, kTileThreads);
      }
    }
    wgmma_wait<0>();
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
    if (col < TBN && m < a.M && n0 + col < a.N)
      *reinterpret_cast<float4*>(a.out + (size_t)m * a.N + n0 + col) = v;
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
    const dim3 grid(a.N / kCols, a.split);
    return bias ? launch_kernel(w4a16_small_m<ST, true>, grid, kThreads, 1, 0, a, st)
                : launch_kernel(w4a16_small_m<ST, false>, grid, kThreads, 1, 0, a, st);
  }
  const dim3 grid((a.M + TBM - 1) / TBM, (a.N + TBN - 1) / TBN, a.split);
  return bias ? launch_kernel(w4a16_tile<ST, true>, grid, kTileThreads, 2, kTileSmem, a, st)
              : launch_kernel(w4a16_tile<ST, false>, grid, kTileThreads, 2, kTileSmem, a, st);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x (M, K): f32 for M <= 8 (the small-M route, which rounds it to bf16),
// bf16 above (the tile route); q (K/2, N) u8 natpair; scale/bias (K/32, N)
// f32 or bf16 (bias may be null); xs (M, K/32) f32 per-32 sums of bf16(x),
// needed on the tile route with a bias; out (M, N) f32. split: the number
// of K pieces, at most 8 (small-M: at most K / 32; tile: at most
// ceil(K / 64)). Requires K % 32 == 0 and N % 128 == 0; x, q, scale and
// bias 16-byte aligned.
extern "C" int ggml_w4a16_gemm(const void* x, const void* q, const void* scale,
                               const void* bias, const void* xs, void* out, int M,
                               int K, int N, int split, int scale_is_bf16, void* stream) {
  const Args a{x, (const uint8_t*)q, scale, bias, (const float*)xs, (float*)out, M, K, N, split};
  const int units = M <= kSmallMaxM ? K / 32 : (K + TBK - 1) / TBK;
  if (M < 1 || K < 32 || K % 32 || N < kCols || N % kCols || misaligned(x) || misaligned(q) ||
      misaligned(scale) || (bias != nullptr && misaligned(bias)) ||
      (bias != nullptr && M > kSmallMaxM && xs == nullptr) || split < 1 ||
      split > kMaxSplit || split > units)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = scale_is_bf16 ? launch_typed<__nv_bfloat16>(a, st)
                                      : launch_typed<float>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
