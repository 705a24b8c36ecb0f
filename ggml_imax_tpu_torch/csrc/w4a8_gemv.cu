// W4A8 decode GEMV over natpair int4 weights.
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_natpair_w4a8_stk (the
// per-layer GEMVs) and ::_kernel_natpair_w4a8 (the LM head) — one kernel
// here, since the port keeps per-layer weights as separate tensors.
//
// Computes out[n] = sum_b z[b,n] * (dx[b] * s[b,n])  (+ xs[b] * bias[b,n])
// with z[b,n] the int32 dot of the Q8_0 activation block x8[b, 0:32] and the
// weight block's signed nibbles (q - 8): the vec_dot_q4_0_q8_0 math.
//
// Bound on the H100: bytes. At m = 1 every weight byte is used for two
// multiply-adds, far below the ~590 int8 ops/byte where the tensor cores
// would bind; the weight stream (K N / 2 bytes plus the scale rows) over
// 3.35 TB/s is the floor: 15.7 us at GPT-J's of_w (K 20480, N 4096).
//
// What the design does about it:
//
// - K split across a thread-block cluster. A block owns 128 columns, so
//   of_w has only 32 column blocks for 132 SMs. `split` (ops/qmm.py
//   ::w4a8_plan: the least divisor of K/32, at most 8, that gives every SM
//   a block) cuts K into that many pieces of whole quant blocks; the split
//   blocks of a column block are one cluster, rank y taking quant blocks
//   [y U / split, (y + 1) U / split) of U = K / 32. Each rank keeps its 128
//   partial sums in its shared memory, and the ranks share out the columns,
//   each summed over the ranks in rank (K) order through distributed shared
//   memory. No workspace, no float atomics, one launch a call, and the same
//   bits on every launch.
// - 16-byte weight loads, many in flight. The (K/2, N) natpair layout keeps
//   N contiguous. Lane l of a warp owns columns 16 (l % 8) .. + 15 and half
//   h = (l / 8) % 2 of a quant block (byte rows 8h .. 8h + 7), and the warp
//   works on two quant blocks at once (l / 16): 8 neighbouring lanes read
//   one whole 128-byte row segment, each lane 8 x 16 bytes a block. The
//   block's 8 warps take 16 quant blocks a step. A lane's next block (its 8
//   weight vectors, its 16 bytes of x8, its scale and bias vectors, dx and
//   xs) is loaded into a second register buffer before the current one is
//   used, so 32 KB a block are always in flight (64 KB an SM at two blocks
//   an SM; Little's law asks ~18 KB an SM at 3.35 TB/s and ~0.7 us). x8 is
//   read once a quant block and lane, with its weights: the 8 lanes of a
//   half read the same 16 bytes, one transaction.
// - Few instructions a weight byte. A 4 x 4 byte transpose (8 prmt) turns
//   four byte rows of four columns into four words, each the four rows of
//   one column. Over the unsigned nibbles u = v ^ 8 (v the stored nibble,
//   whose signed value is the weight q - 8) the low half dots as
//   sum x (u - 8) = dp4a((w ^ 0x08..) & 0x0F.., x_even) - 8 sum x_even, and
//   the high half as dp4a(w & 0xF0.., x_odd) / 16: the byte (v << 4) read as
//   int8 is 16 (q - 8). So a column's 16 z = 16 dp4a_lo + dp4a_hi, with
//   -128 sum x_even (once a half block) as the high sum's start. Per 4
//   weight bytes (8 weights): 2 prmt, 2 lop3, 2 dp4a, i.e. 1.5 integer
//   operations a byte; the two halves' z meet exactly by one shuffle, and
//   each lane then scales 8 columns (z16, the exchange, I2F, the scale
//   product and an FMA, one more FMA for a bias): ~0.6 more a byte.
// - Registers: two blocks an SM hold 128 a thread; the instance with f32
//   scales and a bias (16 more a lane for its two buffers) spills ~110
//   bytes a thread there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;               // a block's columns (ops/qmm.py _W4A8_COLS)
constexpr int kSlots = 2 * kWarps;       // quant blocks a block works on at once
constexpr int kMaxSplit = 8;             // a portable cluster's blocks

struct Args {
  const int8_t* x8;    // (K / 32, 32)
  const float* dx;     // (K / 32)
  const uint8_t* q;    // (K / 2, N)
  const void* scale;   // (K / 32, N), f32 or bf16
  const void* bias;    // as scale, or null
  const float* xs;     // (K / 32) dx * sum(x8), with a bias
  float* out;          // (N)
  int K, N, split;
};

// 8 consecutive scale (or bias) values as loaded: 2 x 16 bytes of f32 or 1
// of bf16
template <typename ST>
struct Raw8 {
  uint4 v[sizeof(ST) == 4 ? 2 : 1];
  __device__ __forceinline__ void load(const ST* p) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(v) / 16); ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ float f32(int i) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
    if (sizeof(ST) == 4) return __uint_as_float(w[i]);
    return __uint_as_float((i % 2) ? (w[i / 2] & 0xFFFF0000u) : (w[i / 2] << 16));
  }
};

// One half quant block of one lane as loaded: byte rows 8h .. 8h + 7 at its
// 16 columns, x8 elements 16h .. 16h + 15 of the block, the scale (and bias)
// of the 8 columns it finishes, dx and xs of the block.
template <typename ST, bool kBias>
struct Half {
  uint4 w[8];
  uint4 x;
  Raw8<ST> s;
  Raw8<ST> b;   // kBias only
  float d, xs;
};

// c: the lane's first column, h its half, u the quant block
template <typename ST, bool kBias>
__device__ __forceinline__ void load_half(const Args& a, int u, int c, int h, Half<ST, kBias>& r) {
  const size_t N = (size_t)a.N;
  const uint8_t* p = a.q + ((size_t)16 * u + 8 * h) * N + c;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __ldg(reinterpret_cast<const uint4*>(p + i * N));
  r.x = __ldg(reinterpret_cast<const uint4*>(a.x8 + (size_t)32 * u + 16 * h));
  const size_t si = (size_t)u * N + c + 8 * h;
  r.s.load(static_cast<const ST*>(a.scale) + si);
  if (kBias) {
    r.b.load(static_cast<const ST*>(a.bias) + si);
    r.xs = __ldg(a.xs + u);
  }
  r.d = __ldg(a.dx + u);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One half block of one lane into acc: the 8 columns c + 8h .. + 7 get
// z * (dx * s) (+ xs * bias), z summed over both halves (the partner lane
// l ^ 8 holds the other). `live`: the lane has a block this step (every
// lane of the warp takes part in the shuffle).
template <typename ST, bool kBias>
__device__ __forceinline__ void half_step(const Half<ST, kBias>& r, int h, bool live,
                                          float (&acc)[8]) {
  const uint32_t xw[4] = {r.x.x, r.x.y, r.x.z, r.x.w};
  // xw[j]: elements 4j .. 4j + 3 = (lo, hi) of byte rows 2j and 2j + 1;
  // row tile t (rows 4t .. 4t + 3) dots its low nibbles with the even
  // elements 8t, 8t + 2, .., its high ones with the odd
  uint32_t xe[2], xo[2];
  int sxe = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    xe[t] = __byte_perm(xw[2 * t], xw[2 * t + 1], 0x6420);
    xo[t] = __byte_perm(xw[2 * t], xw[2 * t + 1], 0x7531);
    sxe = __dp4a((int)xe[t], 0x01010101, sxe);
  }
  const float d16 = r.d * 0.0625f;   // z16 = 16 z, exact
  // pass p: words p and p + 2 (columns 4p .. 4p + 3 and 8 + 4p .. 8 + 4p + 3
  // of the lane's 16); half 0 finishes the first four, half 1 the others,
  // which are its scale values 4p .. 4p + 3 either way
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int zl[8], zh[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      zl[i] = 0;
      zh[i] = -128 * sxe;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = p + 2 * jj;
        const uint32_t A = word(r.w[4 * t], j), B = word(r.w[4 * t + 1], j);
        const uint32_t C = word(r.w[4 * t + 2], j), D = word(r.w[4 * t + 3], j);
        // 4 x 4 byte transpose: col[m] = rows 4t .. 4t + 3 of column 4j + m
        const uint32_t ab01 = __byte_perm(A, B, 0x5140), ab23 = __byte_perm(A, B, 0x7362);
        const uint32_t cd01 = __byte_perm(C, D, 0x5140), cd23 = __byte_perm(C, D, 0x7362);
        const uint32_t col[4] = {__byte_perm(ab01, cd01, 0x5410), __byte_perm(ab01, cd01, 0x7632),
                                 __byte_perm(ab23, cd23, 0x5410), __byte_perm(ab23, cd23, 0x7632)};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = 4 * jj + m;
          zl[i] = __dp4a((int)((col[m] ^ 0x08080808u) & 0x0F0F0F0Fu), (int)xe[t], zl[i]);
          zh[i] = __dp4a((int)(col[m] & 0xF0F0F0F0u), (int)xo[t], zh[i]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int first = 16 * zl[m] + zh[m], second = 16 * zl[4 + m] + zh[4 + m];
      const int z16 = (h ? second : first) + __shfl_xor_sync(0xffffffffu, h ? first : second, 8);
      if (live) {
        acc[4 * p + m] = fmaf((float)z16, d16 * r.s.f32(4 * p + m), acc[4 * p + m]);
        if (kBias) acc[4 * p + m] = fmaf(r.xs, r.b.f32(4 * p + m), acc[4 * p + m]);
      }
    }
  }
}

// The split blocks of a column block are one thread-block cluster, ranked in
// K order. After every block put its partial sums at part[0 .. count) of
// its shared memory, the ranks share the items: each item's sum over the
// ranks' parts is taken in rank order (its loads through distributed shared
// memory issued together), and store(i, sum) writes it.
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

// grid (N / 128, split); block y takes quant blocks [y U / split,
// (y + 1) U / split) of U = K / 32, warp w blocks u0 + 2w + 16 i (lanes 0-15)
// and u0 + 2w + 1 + 16 i (lanes 16-31).
template <typename ST, bool kBias>
__global__ void __launch_bounds__(kThreads, 2) w4a8_split_k(Args a) {
  __shared__ __align__(16) float red[kWarps][kCols];
  __shared__ __align__(16) float4 part[kCols / 4];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int h = (lane / 8) % 2, qw = lane / 16;
  const int cl = 16 * (lane % 8);          // the lane's first column in the block
  const int n0 = blockIdx.x * kCols;
  const int U = a.K / 32;
  const int u0 = (int)((long long)blockIdx.y * U / a.split);
  const int u1 = (int)((long long)(blockIdx.y + 1) * U / a.split);

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // two register buffers, ping-pong: the next block's loads are issued
  // before the current one is used; uw is the warp's first block this step
  Half<ST, kBias> ra, rb;
  int uw = u0 + 2 * warp;
  if (uw + qw < u1) load_half(a, uw + qw, n0 + cl, h, ra);
#pragma unroll 1
  while (uw < u1) {
    if (uw + kSlots + qw < u1) load_half(a, uw + kSlots + qw, n0 + cl, h, rb);
    half_step(ra, h, uw + qw < u1, acc);
    uw += kSlots;
    if (uw >= u1) break;
    if (uw + kSlots + qw < u1) load_half(a, uw + kSlots + qw, n0 + cl, h, ra);
    half_step(rb, h, uw + qw < u1, acc);
    uw += kSlots;
  }

  // the warp's two blocks (lanes l and l ^ 16 hold the same columns), then
  // the warps' sums in warp order
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  if (qw == 0) {
    float4* dst = reinterpret_cast<float4*>(&red[warp][cl + 8 * h]);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  auto store = [&](int i, float4 s) { reinterpret_cast<float4*>(a.out + n0)[i] = s; };
  if (threadIdx.x < kCols / 4) {
    float4 v = reinterpret_cast<const float4*>(&red[0][0])[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 p = reinterpret_cast<const float4*>(&red[w][0])[threadIdx.x];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (a.split == 1) store(threadIdx.x, v);
    else part[threadIdx.x] = v;
  }
  if (a.split > 1) cluster_sum(part, kCols / 4, store);
}

template <typename ST, bool kBias>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N / kCols, a.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = a.split;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, w4a8_split_k<ST, kBias>, a);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x8 (K/32, 32) int8, dx (K/32) f32, q (K/2, N) u8, scale/bias (K/32, N)
// f32 or bf16 (bias may be null), xs (K/32) f32 (with a bias), out (N) f32.
// split: the number of K pieces, 1 .. min(8, K / 32). Requires K % 32 == 0,
// N % 128 == 0, and x8, q, scale and bias 16-byte aligned.
extern "C" int ggml_w4a8_gemv(const void* x8, const void* dx, const void* q,
                              const void* scale, const void* bias, const void* xs,
                              void* out, int K, int N, int split, int scale_is_bf16,
                              void* stream) {
  const Args a{(const int8_t*)x8, (const float*)dx, (const uint8_t*)q, scale, bias,
               (const float*)xs, (float*)out, K, N, split};
  if (K < 32 || K % 32 || N < kCols || N % kCols || split < 1 || split > kMaxSplit ||
      split > K / 32 || misaligned(x8) || misaligned(q) || misaligned(scale) ||
      misaligned(out) || (bias != nullptr && (misaligned(bias) || xs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (scale_is_bf16)
    e = bias ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
  else
    e = bias ? launch<float, true>(a, st) : launch<float, false>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
