// Flash-attention forward (prefill, mixed serving ubatches, training).
//
// Replaces: ggml_imax_tpu/ops/flash_attention.py::_kernel (through _flash /
// flash_attention).
//
// Computes, per batch row b, query head h (kv head h / (Hq/Hkv)) and query i:
//   s_j = (bf16(q_i) . bf16(k_j)) * scale, softcapped c*tanh(s/c) if c > 0,
//   s_j = max(s_j + slope_h * mask[i, j], NEG);  online softmax over the keys,
//   P rounded to bf16 before P.V, the row sums l in f32;
//   out_i = acc / max(l, 1e-30);  lse_i = m + log(max(l, 1e-30)) if asked.
// The reference pads the keys to tk = padded_keys(Tk) (ops/flash_attention.py)
// with k = v = 0 and mask NEG, so each padded key scores sneg = max(NEG *
// slope_h, NEG) and l gains (tk - Tk) exp(sneg - m): nothing in a row with a
// visible key, the divisor tk in a row with none. This kernel adds that term.
//
// Bound on the H100: at the main paths' shapes (GPT-2 XL prefill 512 x 1024
// keys, 25 heads of 64; GPT-J 512 x 512, 16 of 256; a mixed serving ubatch,
// 128 rows over 2048 cells; training B 8, T 512, 12 of 64) the bytes the
// computed tiles need (q, their k/v rows, the mask of the mixed tiles, out)
// take longer at 3.35 TB/s than their 4 D flops per (i, j) pair at 989
// TFLOP/s: bytes (chip_smoke.py computes both).
//
// Tile skipping. ops/flash_backward.backward_tile_map classes each 64 x 64
// tile of the mask (all NEG / all 0 / mixed) once a forward. A block reads
// its query tile's row of the map first and walks only the key tiles it must
// score: an all-NEG tile is skipped when NEG * slope_h < -1e32, a mixed tile's
// mask is staged by cp.async with its keys, an all-0 tile reads no mask. A
// skipped key scores sneg exactly (any |s| < 1e24 rounds away), so in a
// row with a visible key (m > -1e30) its p = exp(sneg - m) is 0 exactly and
// the skip changes no bit. After the walk each row takes its final max m2 =
// max(m, sneg) (when any key was skipped or padded) and beta = exp(sneg -
// m2): 0 in a row with a visible key, 1 in a row with none. Where some valid
// row has beta > 0, the block walks its skipped tiles once more, V alone,
// with P = bf16(beta) in every key (acc += P V, l += beta n): a row with no
// visible key gets the reference's uniform average without its skipped
// tiles being scored (the 21 such rows of a mixed serving ubatch cost one
// pass over V). The padded keys add beta (tk - Tk) to l.
//
// Register route (FlashAttention-2's structure on mma.sync m16n8k16, bf16
// operands, f32 sums, operands through ldmatrix): a block owns 64 query
// rows of one head. Per key tile S = Q K^T lands in accumulator fragments,
// the online softmax runs on them in registers (the row max and sum across
// a quad by shuffles), P is rounded into bf16 A fragments in place (the
// m16n8 accumulator layout is the m16n8k16 A layout) and O += P V
// accumulates in registers: P and O never touch shared memory, and Q is
// held in registers. Widths are compile-time (D in {64, 128, 256}; a smaller
// D runs the next width with zero columns). D <= 128: each of 4 warps owns
// 16 rows and all of D. D 256: O would be 128 f32 a thread for 16 rows (the
// first build, one warp to 16 rows, spilled at 255 registers), so D is
// split across a warp pair: 8 warps, each 16 rows and 128 columns of Q and
// O; the pair adds its two halves of S through shared memory (8 KB a pair,
// in the room Q's tile had; one 64-thread barrier a tile), and both run
// the same softmax on the same sums. (A D 64 variant with 32 rows a warp,
// half the ldmatrix traffic, measured slower: on the H100 this kernel is
// bound by issue and latency, not by shared-memory bandwidth.)
// K, V and a mixed tile's mask are double-buffered by cp.async: the next
// tile's copies are in flight during the current tile's products, one
// __syncthreads a tile; the first tile of a block's keys is loaded while it
// reads the map. The last query tiles start first (a causal mask gives them
// the most key tiles).
//
// Split key range. When the grid has at most a quarter as many blocks as
// the card has SMs (a mixed serving ubatch: 2 query tiles x 16 heads),
// `split` blocks (2-8, one thread-block cluster) share each query tile, as
// many as keep the grid within half the SMs (a larger split measured
// slower): rank r walks the key tiles kt with kt % split == r (scored and
// skipped alike, so the grouping is the same with and without skipping).
// The ranks exchange their row maxima through distributed shared memory,
// each rescales its partial sums to the final max, walks its own skipped
// tiles if needed, and rank r sums rows [64 r / split, 64 (r + 1) / split)
// over the ranks in rank order. Every sum is taken in a fixed order (no
// atomics): the same bits on every run.
#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kTile = 64;       // a block's query rows and a step's keys: the map's tile
constexpr int kMaxSplit = 8;    // the blocks of a portable cluster
constexpr uint8_t kTileZero = 0, kTileMixed = 1, kTileNeg = 2;
typedef __nv_bfloat16 bf16;

struct Args {
  const bf16 *q, *k, *v;        // (B, Tq, Hq, D), (B, Tk, Hkv, D) x2
  const float *mask, *slopes;   // (B, Tq, Tk) >= NEG or null; (Hq) or null
  const uint8_t* tiles;         // (B, ceil(Tq/64), ceil(Tk/64)) classes, or null
  float *out, *lse;             // (B, Tq, Hq, D); (B, Hq, Tq) or null
  int Tq, Tk, Hq, Hkv, D, split;
  float scale, softcap;
};

// The reference's padded key count, round_up(Tk, min(512, round_up(Tk, 128)))
// (ops/flash_attention.py padded_keys)
__host__ __device__ inline int padded_keys(int Tk) {
  const int r = (Tk + 127) / 128 * 128, bk = r < 512 ? r : 512;
  return (Tk + bk - 1) / bk * bk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// ldmatrix offsets (elements) in a tile of row stride ld, for lane: a 16 x
// 16 A fragment at (r0, c0), and, read with .trans at the same addresses,
// the B fragments of n-blocks [c0, c0 + 16) at k [r0, r0 + 16) of a [k][n]
// tile (P V with V stored by keys);
__device__ __forceinline__ int a_off(int ld, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// the B fragments of n-blocks [n0, n0 + 16) at k [c0, c0 + 16) of an [n][k]
// tile (S = Q K^T with K stored by keys).
__device__ __forceinline__ int bt_off(int ld, int n0, int c0, int lane) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// exp(x) as 2^(x log2 e) on the MUFU unit, results below 2^-126 flushed to 0
// (exp(0) = 1 and exp(-inf) = 0 exactly)
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// rows [r0, r0 + 64) of a (T, rowstride) bf16 matrix, columns [0, kD) -> a
// tile of row stride kD + 8 by cp.async (NT threads), zero past T and past D
template <int kD, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t rowstride, int r0,
                                          int T, int D) {
  constexpr int chunks = kD / 8;
  static_assert(kTile * chunks % NT == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < kTile * chunks / NT; ++i) {
    const int c = threadIdx.x + i * NT, r = c / chunks, part = c % chunks;
    const bool ok = r0 + r < T && part * 8 < D;
    cp16(dst + r * (kD + 8) + part * 8, ok ? src + (size_t)(r0 + r) * rowstride + part * 8 : src,
         ok);
  }
}
// the mask of queries [q0, q0 + 64) and keys [k0, k0 + 64) of batch row b
// -> a tile of row stride ld by cp.async, w floats a copy (4 when Tk % 4 ==
// 0, else 1), zero past the edges
template <int w, int NT>
__device__ __forceinline__ void copy_mask(float* dst, int ld, const Args& a, int b, int q0,
                                          int k0) {
  constexpr int per = kTile / w;
  const float* src = a.mask + (size_t)b * a.Tq * a.Tk;
#pragma unroll 4
  for (int c = threadIdx.x; c < kTile * per; c += NT) {
    const int r = c / per, col = c % per * w;
    const bool ok = q0 + r < a.Tq && k0 + col < a.Tk;
    const float* from = ok ? src + (size_t)(q0 + r) * a.Tk + k0 + col : src;
    if constexpr (w == 4) cp16(dst + r * ld + col, from, ok);
    else cp4(dst + r * ld + col, from, ok);
  }
}

template <int kD>
struct Shape {
  // D <= 128: 4 warps, warp w rows 16 w, all of D. D 256 (kCols): 8
  // warps, warp w rows 16 (w % 4) and columns 128 (w / 4) of Q and O; its
  // pair w ^ 4 holds the other columns, and the two add their partial
  // S = Q K^T each tile.
  static constexpr bool kCols = kD > 128;
  static constexpr int NT = kCols ? 256 : 128, DW = kCols ? kD / 2 : kD;
  static constexpr int LD = kD + 8, MLD = kTile + 8, LDO = kD + 4;
  // Q (64 rows; with kCols, once Q is in registers, the pairs' partial
  // scores, 8 warps x 16 x 64 f32); two stages of K and V (64 rows each);
  // two stages of a mixed tile's mask (64 x 64 f32); each row's m and l (64
  // f32 each); then the lists of list_bytes. After the walks the stages
  // hold a rank's partial O (64 x LDO f32) for the other ranks of its
  // cluster.
  static constexpr size_t stage = sizeof(bf16) * 2 * kTile * LD;
  static constexpr size_t kv = sizeof(bf16) * kTile * LD;
  static_assert(!kCols || sizeof(float) * 8 * 16 * kTile <= kv, "the scores fit in Q's room");
  static constexpr size_t mask = kv + 2 * stage;
  static constexpr size_t rows = mask + sizeof(float) * 2 * kTile * MLD;
  static constexpr size_t lists = rows + sizeof(float) * 2 * kTile;
  static_assert(kv % 16 == 0 && mask % 16 == 0 && lists % 16 == 0, "16-byte aligned regions");
  static_assert(sizeof(float) * kTile * LDO <= 2 * stage, "a partial O fits in the stages");
};

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }
// A class byte for each key tile, then this rank's scored and skipped key
// tiles (uint16 each).
__host__ __device__ constexpr int list_bytes(int nkt) {
  return round16(nkt) + 2 * round16(2 * nkt);
}

// One key step of the online softmax on a warp's 16 rows (this thread's rows
// g and g + 8): sc holds the unscaled products (element i of n-block j: row
// g + 8 (i / 2), key 8 j + 2 t + i % 2), mterm(hr, j, e) the mask term
// (kMasked; an all-0 tile has none: max(s + 0, NEG) is s). With kEdge, keys
// at or past kvalid (from column 2 t) score -inf, so p = 0. P is rounded
// into the bf16 A fragments pa; l gains the unrounded row sums; acc is
// rescaled to the new row max (not at all where no row max of the warp
// moved: the factor is 1 exactly).
template <bool kCap, bool kMasked, bool kEdge, int DB, typename M>
__device__ __forceinline__ void softmax_step(float (&sc)[8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[DB][4], uint32_t (&pa)[4][4],
                                             int kvalid, float scale, float cap, M mterm) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = sc[j][i] * scale;
      if constexpr (kCap) s = cap * tanhf(s / cap);
      if constexpr (kMasked) s = fmaxf(s + mterm(i >> 1, j, i & 1), kNeg);
      if constexpr (kEdge) s = 8 * j + (i & 1) < kvalid ? s : -INFINITY;
      sc[j][i] = s;
    }
  }
  float alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[hr], mx);
    alpha[hr] = exp_ftz(m[hr] - mn);
    m[hr] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float p0 = exp_ftz(sc[j][2 * hr] - m[hr]), p1 = exp_ftz(sc[j][2 * hr + 1] - m[hr]);
      rs[hr] += p0 + p1;
      pa[j / 2][(j & 1) * 2 + hr] = pack_bf16(p0, p1);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + rs[hr];
  if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// softmax_step with the edge checks only in a tile that ends past Tk (edge,
// the same in every thread)
template <bool kCap, bool kMasked, int DB, typename M>
__device__ __forceinline__ void softmax_tile(float (&sc)[8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[DB][4], uint32_t (&pa)[4][4],
                                             bool edge, int kvalid, float scale, float cap,
                                             M mterm) {
  if (edge)
    softmax_step<kCap, kMasked, true>(sc, m, l, acc, pa, kvalid, scale, cap, mterm);
  else
    softmax_step<kCap, kMasked, false>(sc, m, l, acc, pa, kvalid, scale, cap, mterm);
}

// acc += P V for a warp's 16 rows and its DW columns from c0: pa the bf16
// A fragments of P (16 x 64 keys), Vs a V tile (64 keys x kD, row stride
// kD + 8) in shared memory
template <int kD, int DW>
__device__ __forceinline__ void pv(float (&acc)[DW / 8][4], const uint32_t (&pa)[4][4],
                                   const bf16* Vs, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dn = 0; dn < DW / 16; ++dn) {
      uint32_t bv[4];
      ldsm4_t(bv, Vs + a_off(kD + 8, kk * 16, c0 + dn * 16, lane));
      mma(acc[2 * dn], pa[kk], bv[0], bv[1]);
      mma(acc[2 * dn + 1], pa[kk], bv[2], bv[3]);
    }
  }
}

// a 64-thread barrier of a warp pair
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// grid (split * Hq, B, ceil(Tq / 64)), clusters of split blocks along x:
// rank blockIdx.x % split of query tile gridDim.z - 1 - blockIdx.z of head
// blockIdx.x / split.
template <int kD, bool kCap>
__global__ void __launch_bounds__(Shape<kD>::NT) flash_fwd_kernel(Args a) {
  using S = Shape<kD>;
  constexpr bool kCols = S::kCols;
  constexpr int NT = S::NT, DW = S::DW, LD = S::LD, MLD = S::MLD, LDO = S::LDO;
  constexpr int DS = DW / 16, DB = DW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int counts[3];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* stages = reinterpret_cast<bf16*>(smem + S::kv);  // stage st: K, then V kTile * LD after
  float* masks = reinterpret_cast<float*>(smem + S::mask);
  float* cm = reinterpret_cast<float*>(smem + S::rows);   // each row's m after the walk
  float* cl = cm + kTile;                                 // each row's l in the final frame
  const int nkt = (a.Tk + kTile - 1) / kTile;
  uint8_t* flags = smem + S::lists;
  uint16_t* live = reinterpret_cast<uint16_t*>(smem + S::lists + round16(nkt));
  uint16_t* skip = live + round16(2 * nkt) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, c0 = kCols ? (warp >> 2) * DW : 0;   // rows 16 rg, columns c0
  const int split = a.split, rank = blockIdx.x % split, h = blockIdx.x / split, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int D = a.D, hk = h / (a.Hq / a.Hkv);
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;
  const float sneg = fmaxf(kNeg * slope, kNeg);   // a masked key's score, and a padded key's
  const bool can_skip = a.mask != nullptr && kNeg * slope < -1e32f;

  // K (if scored), V and, with_mask, the mask of key tile kt into stage st
  auto load = [&](int kt, int st, bool scored, bool with_mask) {
    bf16* Ks = stages + st * 2 * kTile * LD;
    if (scored) copy_rows<kD, NT>(Ks, a.k + kbase, kstride, kt * kTile, a.Tk, D);
    copy_rows<kD, NT>(Ks + kTile * LD, a.v + kbase, kstride, kt * kTile, a.Tk, D);
    if (with_mask) {
      float* ms = masks + st * kTile * MLD;
      if ((a.Tk & 3) == 0) copy_mask<4, NT>(ms, MLD, a, b, q0, kt * kTile);
      else copy_mask<1, NT>(ms, MLD, a, b, q0, kt * kTile);
    }
    cp_commit();
  };
  copy_rows<kD, NT>(Qs, a.q + (size_t)b * a.Tq * qstride + (size_t)h * D, qstride, q0, a.Tq, D);
  // this rank's first key tile (a causal mask's first scored one), loaded
  // while the map is read
  load(rank, 0, true, a.mask != nullptr);
  // warp 0 reads the map's row: each tile's class, this rank's scored and
  // skipped tiles in key order, and the keys every rank skips
  if (warp == 0) {
    const size_t row = ((size_t)b * ((a.Tq + kTile - 1) / kTile) + q0 / kTile) * nkt;
    int nlive = 0, nskip = 0, keys = 0;
    for (int c = 0; c < nkt; c += 32) {
      const int kt = c + lane;
      const bool in = kt < nkt;
      int cls = kTileZero;
      if (in && a.mask != nullptr) cls = a.tiles != nullptr ? a.tiles[row + kt] : kTileMixed;
      const bool skipped = in && can_skip && cls == kTileNeg, mine = in && kt % split == rank;
      const unsigned lb = __ballot_sync(0xffffffffu, mine && !skipped);
      const unsigned sb = __ballot_sync(0xffffffffu, mine && skipped);
      const unsigned below = (1u << lane) - 1u;
      if (mine && !skipped) live[nlive + __popc(lb & below)] = (uint16_t)kt;
      if (mine && skipped) skip[nskip + __popc(sb & below)] = (uint16_t)kt;
      if (in) flags[kt] = (uint8_t)cls;
      if (skipped) keys += min(kTile, a.Tk - kt * kTile);
      nlive += __popc(lb);
      nskip += __popc(sb);
    }
    for (int o = 16; o > 0; o >>= 1) keys += __shfl_xor_sync(0xffffffffu, keys, o);
    if (lane == 0) {
      counts[0] = nlive;
      counts[1] = nskip;
      counts[2] = keys;
    }
  }
  __syncthreads();
  const int nlive = counts[0], nskip = counts[1];
  const int npad = padded_keys(a.Tk) - a.Tk;
  const bool extra = counts[2] + npad > 0;   // keys left out of the walk, all scoring sneg
  auto mixed = [&](int i) { return i < nlive && flags[live[i]] == kTileMixed; };
  if (nlive > 0 && live[0] != rank) {   // the guess missed: its copies land first
    cp_wait_all();
    load(live[0], 0, true, mixed(0));
  }
  cp_wait_all();
  __syncthreads();
  uint32_t qf[DS][4];
#pragma unroll
  for (int ks = 0; ks < DS; ++ks) ldsm4(qf[ks], Qs + a_off(LD, rg * 16, c0 + ks * 16, lane));
  // with kCols each warp's partial scores go where Q was: every warp has
  // its Q fragments first
  if constexpr (kCols) __syncthreads();
  float4* xs = reinterpret_cast<float4*>(smem);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // the scored tiles
  for (int i = 0, st = 0; i < nlive; ++i, st ^= 1) {
    if (i + 1 < nlive) load(live[i + 1], st ^ 1, true, mixed(i + 1));
    const int kt = live[i];
    const bf16* Ks = stages + st * 2 * kTile * LD;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldsm4(bk, Ks + bt_off(LD, jp * 16, c0 + ks * 16, lane));
        mma(sc[2 * jp], qf[ks], bk[0], bk[1]);
        mma(sc[2 * jp + 1], qf[ks], bk[2], bk[3]);
      }
    }
    if constexpr (kCols) {
      // each warp of a pair holds the products over its half of D: the two
      // add them (a + b == b + a, so both hold the same scores)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xs[(warp * 8 + j) * 32 + lane] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      pair_sync(1 + rg);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 o = xs[((warp ^ 4) * 8 + j) * 32 + lane];
        sc[j][0] += o.x;
        sc[j][1] += o.y;
        sc[j][2] += o.z;
        sc[j][3] += o.w;
      }
    }
    uint32_t pa[4][4];
    // kvalid: the valid keys of the tile from this thread's column 2 t
    const int cls = flags[kt], kvalid = a.Tk - kt * kTile - 2 * t;
    const bool edge = (kt + 1) * kTile > a.Tk;
    if (cls == kTileZero) {
      softmax_tile<kCap, false>(sc, m, l, acc, pa, edge, kvalid, a.scale, a.softcap,
                                [](int, int, int) { return 0.f; });
    } else if (cls == kTileNeg) {
      const float mneg = kNeg * slope;
      softmax_tile<kCap, true>(sc, m, l, acc, pa, edge, kvalid, a.scale, a.softcap,
                               [=](int, int, int) { return mneg; });
    } else {
      const float* ms = masks + st * kTile * MLD + (rg * 16 + g) * MLD + 2 * t;
      softmax_tile<kCap, true>(
          sc, m, l, acc, pa, edge, kvalid, a.scale, a.softcap,
          [=](int hr, int j, int e) { return ms[8 * hr * MLD + 8 * j + e] * slope; });
    }
    pv<kD, DW>(acc, pa, Ks + kTile * LD, c0, lane);
    cp_wait_all();
    __syncthreads();
  }

  // each row's final max m2 (every rank's), this rank's sums rescaled to it
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rl0 = rg * 16 + g;          // this thread's rows rl0, rl0 + 8 of the tile
  const bool lead = c0 == 0 && t == 0;  // writes its rows' m, l and lse
  if (split > 1) {
    if (lead) {
      cm[rl0] = m[0];
      cm[rl0 + 8] = m[1];
    }
    cluster.sync();
  }
  float m2[2], beta[2];
  bool need = false;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = rl0 + 8 * hr;
    float mf = m[hr];
    for (int r = 0; r < (split > 1 ? split : 0); ++r)
      mf = fmaxf(mf, cluster.map_shared_rank(cm, r)[rl]);
    m2[hr] = extra ? fmaxf(mf, sneg) : mf;
    const float f = exp_ftz(m[hr] - m2[hr]);
    l[hr] *= f;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      acc[j][2 * hr] *= f;
      acc[j][2 * hr + 1] *= f;
    }
    beta[hr] = extra ? exp_ftz(sneg - m2[hr]) : 0.f;
    need |= q0 + rl < a.Tq && beta[hr] > 0.f;
  }

  // this rank's skipped tiles, V alone with P = bf16(beta), where a valid
  // row has no visible key
  if (__syncthreads_or(need && nskip > 0)) {
    uint32_t pb[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pb[kk][e] = pack_bf16(beta[e & 1], beta[e & 1]);
    }
    load(skip[0], 0, false, false);
    cp_wait_all();
    __syncthreads();
    for (int i = 0, st = 0; i < nskip; ++i, st ^= 1) {
      if (i + 1 < nskip) load(skip[i + 1], st ^ 1, false, false);
      pv<kD, DW>(acc, pb, stages + st * 2 * kTile * LD + kTile * LD, c0, lane);
      const float n = (float)min(kTile, a.Tk - skip[i] * kTile);
      l[0] += beta[0] * n;
      l[1] += beta[1] * n;
      cp_wait_all();
      __syncthreads();
    }
  }

  if (split == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + rl0 + 8 * hr;
      if (qi >= a.Tq) continue;
      const float lt = fmaxf(l[hr] + beta[hr] * (float)npad, 1e-30f);
      float* o = a.out + (((size_t)b * a.Tq + qi) * a.Hq + h) * D + c0;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        const int d = 8 * j + 2 * t;
        if (c0 + d < D)
          *reinterpret_cast<float2*>(o + d) =
              make_float2(acc[j][2 * hr] / lt, acc[j][2 * hr + 1] / lt);
      }
      if (a.lse != nullptr && lead) a.lse[((size_t)b * a.Hq + h) * a.Tq + qi] = m2[hr] + logf(lt);
    }
    return;
  }

  // split: this rank's partial O and l to shared memory (the walks ended
  // with a barrier, so the stages are free), then rank r sums its rows
  // over the ranks in rank order
  float* co = reinterpret_cast<float*>(smem + S::kv);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rl = rl0 + 8 * hr;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<float2*>(co + rl * LDO + c0 + 8 * j + 2 * t) =
          make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
    if (lead) cl[rl] = l[hr];
  }
  cluster.sync();
  const int per = kTile / split, r0 = rank * per;
  for (int e = threadIdx.x; e < per * (kD / 4); e += NT) {
    const int rl = r0 + e / (kD / 4), d = e % (kD / 4) * 4, qi = q0 + rl;
    if (qi >= a.Tq || d >= D) continue;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f, mf = kNeg;
    for (int r = 0; r < split; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(co, r) +
                                                         rl * LDO + d);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
      lsum += cluster.map_shared_rank(cl, r)[rl];
      mf = fmaxf(mf, cluster.map_shared_rank(cm, r)[rl]);
    }
    const float mm = extra ? fmaxf(mf, sneg) : mf;
    const float lt = fmaxf(lsum + (extra ? exp_ftz(sneg - mm) * (float)npad : 0.f), 1e-30f);
    *reinterpret_cast<float4*>(a.out + (((size_t)b * a.Tq + qi) * a.Hq + h) * D + d) =
        make_float4(o.x / lt, o.y / lt, o.z / lt, o.w / lt);
    if (a.lse != nullptr && d == 0) a.lse[((size_t)b * a.Hq + h) * a.Tq + qi] = mm + logf(lt);
  }
  cluster.sync();   // the other ranks keep their shared memory until it is read
}

// The blocks that share a query tile: the largest power of two (at most 8,
// at most the key tiles) that keeps the grid within half the card's SMs.
int split_for(long blocks, int nkt) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int split = 1;
  while (split < kMaxSplit && blocks * split * 4 <= sms && split * 2 <= nkt) split *= 2;
  return split;
}

template <int kD, bool kCap>
int launch(const Args& a, int B, cudaStream_t stream) {
  void (*kern)(Args) = flash_fwd_kernel<kD, kCap>;
  const int nkt = (a.Tk + kTile - 1) / kTile, nq = (a.Tq + kTile - 1) / kTile;
  const size_t smem = Shape<kD>::lists + list_bytes(nkt);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.split * a.Hq, B, nq);
  if (a.split == 1) {
    kern<<<grid, Shape<kD>::NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Shape<kD>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int kD>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  return a.softcap > 0.f ? launch<kD, true>(a, B, stream) : launch<kD, false>(a, B, stream);
}

}  // namespace

// q (B, Tq, Hq, D), k/v (B, Tk, Hkv, D) bf16, 16-byte aligned; mask (B, Tq,
// Tk) f32, clamped to >= NEG by the caller, 16-byte aligned, or null; slopes
// (Hq) f32 or null; tiles (B, ceil(Tq/64), ceil(Tk/64)) uint8, the map of
// ggml_flash_backward_tiles of the mask (null: every tile mixed); out (B, Tq,
// Hq, D) f32; lse (B, Hq, Tq) f32 or null. Requires D % 16 == 0, D <= 256
// and Hq % Hkv == 0.
extern "C" int ggml_flash_attention(const void* q, const void* k, const void* v,
                                    const void* mask, const void* slopes, const void* tiles,
                                    void* out, void* lse, int B, int Tq, int Tk, int Hq, int Hkv,
                                    int D, float scale, float softcap, void* stream) {
  if (D % 16 != 0 || D > 256 || D <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tk <= 0 || Tq <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.mask = (const float*)mask;
  a.slopes = (const float*)slopes;
  a.tiles = (const uint8_t*)tiles;
  a.out = (float*)out;
  a.lse = (float*)lse;
  a.Tq = Tq;
  a.Tk = Tk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.scale = scale;
  a.softcap = softcap;
  const int nkt = (Tk + kTile - 1) / kTile;
  a.split = split_for((long)B * Hq * ((Tq + kTile - 1) / kTile), nkt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_d<64>(a, B, s);
  if (D <= 128) return launch_d<128>(a, B, s);
  return launch_d<256>(a, B, s);
}
