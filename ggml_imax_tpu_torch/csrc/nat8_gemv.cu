// W8A8 decode GEMV over nat8 int8 weights.
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_nat8_w8a8_stk (the
// per-layer GEMVs) and ::_kernel_nat8_w8a8 (one tensor) — one kernel here,
// since the port keeps per-layer weights as separate tensors.
//
// Computes out[n] = sum_b z[b,n] * (dx[b] * s[b,n])  (+ xs[b] * bias[b,n])
// with z[b,n] the exact int32 dot of the activation group x8[b, 0:g] and the
// weight rows q[b g:(b + 1) g, n] (ggml's vec_dot_q8_0_q8_0 math), g = 32 or
// 16 (the per-16 formats). Scales and bias are f32 or bf16, read as f32.
//
// Bound on the H100: bytes. At m = 1 each weight byte feeds two int8
// multiply-adds, far below the ~590 ops/byte where the tensor cores would
// bind: the weight stream (K N bytes plus the scale rows) over 3.35 TB/s is
// the floor, 3.4 us at GPT-2 XL's fc_w (K 1600, N 6400, g 32, f32 scales).
//
// What the design does about it:
//
// - K split across a thread-block cluster. A block owns 128 columns, so
//   fc_w has only 50 column blocks for 132 SMs. `split` (ops/qmm.py
//   ::nat8_gemv_plan: 1 when the column blocks fill the SMs, else the
//   largest split, at most 8, whose clusters the card runs in one wave; 4 at
//   fc_w, where clusters of 5 need a second wave) cuts K into that many
//   pieces of whole 32-row units (one g-32 group, or two g-16 groups); the
//   split blocks of a column block are one cluster, rank y taking units
//   [y U / split, (y + 1) U / split) of U = K / 32. The ranks share out the
//   128 columns: each stores its partial sums into the owner's shared
//   memory by st.async, counted on the owner's mbarrier, and the owner adds
//   them in rank (K) order once its bytes have landed. No cluster barrier
//   after the sums (a barrier there cost ~1 us on the H100), no workspace,
//   no float atomics, one launch a call, and the same bits on every launch.
// - Every load of a block in flight before its first use. The (K, N) layout
//   keeps N contiguous. A warp takes one unit at a time (units u0 + w,
//   u0 + w + 8, .. for warp w): lane l owns columns 16 (l % 8) .. + 15 and
//   byte rows 8 r .. 8 r + 7 of the unit, r = l / 8, so 8 neighbouring lanes
//   read one whole 128-byte row segment and a warp 512 bytes an
//   instruction. A lane's next unit (its 8 x 16 weight bytes, its 8 bytes
//   of x8, its scale vector, dx and xs of its group into registers, its bias
//   vector by cp.async into its slot of shared memory) is requested before
//   the current one is used, so at fc_w (12 or 13 units a rank, at most two
//   a warp) every byte of a block is requested at once. The lane's x8 bytes
//   are its rows' activations in dot order: no shuffle builds them.
// - One exact integer dot a group, then one scale. A 4 x 4 byte transpose
//   (8 prmt) turns four byte rows of four columns into four words, each the
//   four rows of one column, for one dp4a against the lane's x8 word: per 16
//   weight bytes 8 prmt and 4 dp4a. The four row phases of a column (lanes
//   l, l ^ 8, l ^ 16, l ^ 24) then meet exactly, by a reduce-scatter of int32
//   (xor 8, then xor 16 at g 32): each lane holds whole-group z for 4 columns
//   (g 32), or for 8 columns of one of the unit's two groups (g 16, where
//   rows 8 r .. 8 r + 7 lie in group r / 2), and does acc = fma(z, dx s, acc)
//   (+ fma(xs, bias, acc)) with s and bias read as one vector of exactly
//   those columns. So every weight byte, scale and bias value is read once,
//   and no group is scaled in two parts.
// - The ends: g 16's two group lanes add their sums (one shuffle); the 8
//   warps' sums go through shared memory and are added in warp order.
// - Registers: two blocks an SM hold 128 a thread (__launch_bounds__); the
//   two units in flight take 38-44 of them (the bias waits in shared
//   memory: in registers, two units of f32 bias at g 16 spilled).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;               // a block's columns (ops/qmm.py _NAT8_GEMV_COLS)
constexpr int kUnit = 32;                // rows a warp takes at a time
constexpr int kMaxSplit = 8;             // a portable cluster's blocks

struct Args {
  const int8_t* x8;    // (K / g, g)
  const float* dx;     // (K / g)
  const int8_t* q;     // (K, N)
  const void* scale;   // (K / g, N), f32 or bf16
  const void* bias;    // as scale, or null
  const float* xs;     // (K / g) dx * sum(x8), with a bias
  float* out;          // (N)
  int K, N, split;
};

// The scale (or bias) values of the columns a lane finishes in one unit: 4
// at g 32, 8 at g 16, as loaded (8 to 32 bytes)
template <typename ST, int G>
struct Vals {
  static constexpr int kN = G == 32 ? 4 : 8;
  static constexpr int kWords = kN * (int)sizeof(ST) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const ST* p) {
    if constexpr (kWords == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ float f32(int i) const {
    if constexpr (sizeof(ST) == 4) return __uint_as_float(w[i]);
    else return __uint_as_float((i % 2) ? (w[i / 2] & 0xFFFF0000u) : (w[i / 2] << 16));
  }
};

// One unit of one lane as loaded into registers: byte rows 8r .. 8r + 7 at
// its 16 columns, x8 elements 8r .. 8r + 7 of the unit, the scale values of
// the columns it finishes, dx and xs of their group. Its bias values go to
// the lane's slot of shared memory by cp.async (two units of f32 bias at
// g 16 would not fit beside the rest in 128 registers).
template <typename ST, int G, bool kBias>
struct Unit {
  uint4 w[8];
  uint2 x;
  Vals<ST, G> s;
  float d, xs;
};

// a lane's bias slot: the bytes of one Vals (8 to 32)
template <typename ST, int G>
struct BiasSlot {
  uint32_t w[Vals<ST, G>::kWords];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of one lane's bias values (8, 16 or 32 bytes) into its slot, in
// the thread's current group
template <typename ST, int G>
__device__ __forceinline__ void stage_bias(BiasSlot<ST, G>& dst, const ST* src) {
  constexpr int kBytes = Vals<ST, G>::kWords * 4;
  if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst.w)), "l"(src)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst.w + 4 * i)),
                   "l"(reinterpret_cast<const char*>(src) + 16 * i)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// all but the thread's latest group have landed
__device__ __forceinline__ void cp_wait_but_latest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The cluster barrier in halves: an arrival that orders no memory, and the
// wait (once every rank has arrived, every rank has started)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// an mbarrier of one arrival: init (made visible to the cluster), the
// arrival that expects `bytes` of remote stores, the wait for its phase 0
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}
// v into rank r's copy of *slot, counted (16 bytes) on rank r's copy of *bar
__device__ __forceinline__ void store_remote(float4* slot, uint64_t* bar, int r, float4 v) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_u32(slot)), "r"(r));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(r));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

// The lane's first finished column in the block: of its 16, the half r % 2
// (the xor-8 step) and at g 32 the quarter r / 2 of that (the xor-16 step)
template <int G>
__device__ __forceinline__ int finished_col(int lane) {
  const int r = lane / 8;
  return 16 * (lane % 8) + 8 * (r % 2) + (G == 32 ? 4 * (r / 2) : 0);
}

template <typename ST, int G, bool kBias>
__device__ __forceinline__ void load_unit(const Args& a, int u, int n0, int lane,
                                          Unit<ST, G, kBias>& t, BiasSlot<ST, G>& bias) {
  const size_t N = (size_t)a.N;
  const int r = lane / 8;
  const int8_t* p = a.q + ((size_t)kUnit * u + 8 * r) * N + n0 + 16 * (lane % 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) t.w[i] = __ldg(reinterpret_cast<const uint4*>(p + i * N));
  t.x = __ldg(reinterpret_cast<const uint2*>(a.x8 + (size_t)kUnit * u + 8 * r));
  const int b = G == 32 ? u : 2 * u + r / 2;       // the lane's group
  const size_t si = (size_t)b * N + n0 + finished_col<G>(lane);
  t.s.load(static_cast<const ST*>(a.scale) + si);
  if (kBias) {
    stage_bias(bias, static_cast<const ST*>(a.bias) + si);
    t.xs = __ldg(a.xs + b);
  }
  t.d = __ldg(a.dx + b);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One unit of one lane into acc (the whole warp takes part: the shuffles);
// its bias values are in `bias` once all but the latest cp.async group land
template <typename ST, int G, bool kBias>
__device__ __forceinline__ void unit_step(const Unit<ST, G, kBias>& t, const BiasSlot<ST, G>& bias,
                                          int lane, float (&acc)[Vals<ST, G>::kN]) {
  // z[c]: this lane's 8 rows of its column c; word j of row vector i holds
  // columns 4j .. 4j + 3 of row 8r + i
  int z[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) z[c] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t A = word(t.w[4 * h], j), B = word(t.w[4 * h + 1], j);
      const uint32_t C = word(t.w[4 * h + 2], j), D = word(t.w[4 * h + 3], j);
      // 4 x 4 byte transpose: col[m] = rows 8r + 4h .. + 3 of column 4j + m,
      // in the byte order of the x8 word of those rows
      const uint32_t ab01 = __byte_perm(A, B, 0x5140), ab23 = __byte_perm(A, B, 0x7362);
      const uint32_t cd01 = __byte_perm(C, D, 0x5140), cd23 = __byte_perm(C, D, 0x7362);
      const uint32_t col[4] = {__byte_perm(ab01, cd01, 0x5410), __byte_perm(ab01, cd01, 0x7632),
                               __byte_perm(ab23, cd23, 0x5410), __byte_perm(ab23, cd23, 0x7632)};
      const int xw = (int)(h ? t.x.y : t.x.x);
#pragma unroll
      for (int m = 0; m < 4; ++m) z[4 * j + m] = __dp4a((int)col[m], xw, z[4 * j + m]);
    }
  }
  // reduce-scatter over the row phases: lane r keeps columns 8 (r % 2) ..
  // + 7 of its 16 (with the xor-8 partner's rows), at g 32 then columns
  // 4 (r / 2) .. + 3 of those (with the xor-16 partner's)
  const int r = lane / 8;
  int y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int keep = (r % 2) ? z[8 + i] : z[i], send = (r % 2) ? z[i] : z[8 + i];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  if constexpr (G == 32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int keep = (r / 2) ? y[4 + i] : y[i], send = (r / 2) ? y[i] : y[4 + i];
      y[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  Vals<ST, G> b;
  if (kBias) {
    cp_wait_but_latest();
#pragma unroll
    for (int i = 0; i < Vals<ST, G>::kWords; ++i) b.w[i] = bias.w[i];
  }
#pragma unroll
  for (int i = 0; i < Vals<ST, G>::kN; ++i) {
    acc[i] = fmaf((float)y[i], t.d * t.s.f32(i), acc[i]);
    if (kBias) acc[i] = fmaf(t.xs, b.f32(i), acc[i]);
  }
}

// The split blocks of a column block are one thread-block cluster, ranked in
// K order, and each rank owns a share of the 32 float4 items of the 128
// columns. Every rank stores its partial sum of an item into the owner's
// parts[its rank] by st.async, counted on the owner's mbarrier; each owner
// waits for its items' bytes alone (no cluster barrier after the sums) and
// adds the parts in rank order. A block leaves only once every byte bound
// for it has landed, and the cluster wait before the stores makes sure
// every rank has started and set up its mbarrier.
__device__ __forceinline__ void cluster_sum(float4 (&parts)[kMaxSplit][kCols / 4], uint64_t* bar,
                                            float4 v, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (kCols / 4 + ranks - 1) / ranks;
  const int i0 = rank * per, mine = min(kCols / 4, i0 + per) - i0;
  const int i = threadIdx.x;
  cluster_wait();
  if (i == 0) mbar_expect(bar, 16 * ranks * mine);
  if (i < kCols / 4) store_remote(&parts[rank][i], bar, i / per, v);
  if (i >= i0 && i < i0 + mine) {
    mbar_wait(bar);
    float4 sum = parts[0][i];
    for (int r = 1; r < ranks; ++r) {
      const float4 p = parts[r][i];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    reinterpret_cast<float4*>(out)[i] = sum;
  }
}

// grid (N / 128, split); block y takes units [y U / split, (y + 1) U /
// split) of U = K / 32, warp w units u0 + w, u0 + w + 8, ..
template <typename ST, int G, bool kBias>
__global__ void __launch_bounds__(kThreads, 2) nat8_gemv_kernel(Args a) {
  __shared__ __align__(16) float red[kWarps][kCols];
  __shared__ __align__(16) float4 parts[kMaxSplit][kCols / 4];
  __shared__ __align__(8) uint64_t bar;
  // each lane's bias slots, one a unit buffer (kBias only)
  __shared__ __align__(16) BiasSlot<ST, G> bias[kBias ? 2 : 1][kThreads];
  constexpr int kN = Vals<ST, G>::kN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kCols;
  const int U = a.K / kUnit;
  const int u0 = (int)((long long)blockIdx.y * U / a.split);
  const int u1 = (int)((long long)(blockIdx.y + 1) * U / a.split);
  if (a.split > 1) {                   // waited for before the ranks' stores
    if (threadIdx.x == 0) mbar_init(&bar);
    cluster_arrive_relaxed();
  }

  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;

  // two unit buffers, ping-pong: the next unit's loads are issued before
  // the current one is used. A cp.async group is committed after each load,
  // taken or not, so the current unit's bias has landed once all but the
  // latest group have.
  Unit<ST, G, kBias> ua, ub;
  BiasSlot<ST, G>& ba = bias[0][threadIdx.x];
  BiasSlot<ST, G>& bb = bias[kBias ? 1 : 0][threadIdx.x];
  int u = u0 + warp;
  if (u < u1) load_unit(a, u, n0, lane, ua, ba);
  if (kBias) cp_commit();
#pragma unroll 1
  while (u < u1) {
    if (u + kWarps < u1) load_unit(a, u + kWarps, n0, lane, ub, bb);
    if (kBias) cp_commit();
    unit_step(ua, ba, lane, acc);
    u += kWarps;
    if (u >= u1) break;
    if (u + kWarps < u1) load_unit(a, u + kWarps, n0, lane, ua, ba);
    if (kBias) cp_commit();
    unit_step(ub, bb, lane, acc);
    u += kWarps;
  }

  // g 16: lanes l and l ^ 16 finished the same columns for the two groups
  // of each unit; then the warps' sums in warp order
  if constexpr (G == 16) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (G == 32 || lane < 16) {
    float4* dst = reinterpret_cast<float4*>(&red[warp][finished_col<G>(lane)]);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < kCols / 4) {
    v = reinterpret_cast<const float4*>(&red[0][0])[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 p = reinterpret_cast<const float4*>(&red[w][0])[threadIdx.x];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (a.split == 1) reinterpret_cast<float4*>(a.out + n0)[threadIdx.x] = v;
  }
  if (a.split > 1) cluster_sum(parts, &bar, v, a.out + n0);
}

template <typename ST, int G, bool kBias>
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
  return cudaLaunchKernelEx(&cfg, nat8_gemv_kernel<ST, G, kBias>, a);
}

template <typename ST, int G>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  return a.bias ? launch<ST, G, true>(a, st) : launch<ST, G, false>(a, st);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x8 (K/g, g) int8, dx (K/g) f32, q (K, N) int8, scale/bias (K/g, N) f32 or
// bf16 (bias may be null), xs (K/g) f32 (with a bias), out (N) f32.
// split: the number of K pieces, 1 .. min(8, K / 32). Requires g in {16,
// 32}, K % 32 == 0, N % 128 == 0, and x8, q, scale, bias and out 16-byte
// aligned.
extern "C" int ggml_nat8_gemv(const void* x8, const void* dx, const void* q,
                              const void* scale, const void* bias, const void* xs,
                              void* out, int K, int N, int g, int split,
                              int scale_is_bf16, void* stream) {
  const Args a{(const int8_t*)x8, (const float*)dx, (const int8_t*)q, scale, bias,
               (const float*)xs, (float*)out, K, N, split};
  if ((g != 16 && g != 32) || K < kUnit || K % kUnit || N < kCols || N % kCols ||
      split < 1 || split > kMaxSplit || split > K / kUnit || misaligned(x8) ||
      misaligned(q) || misaligned(scale) || misaligned(out) ||
      (bias != nullptr && (misaligned(bias) || xs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (scale_is_bf16)
    e = g == 32 ? launch_g<__nv_bfloat16, 32>(a, st) : launch_g<__nv_bfloat16, 16>(a, st);
  else
    e = g == 32 ? launch_g<float, 32>(a, st) : launch_g<float, 16>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
