// Flash-attention backward: the dQ kernel, the dK/dV kernel and the tile map
// they share.
//
// Replaces: ggml_imax_tpu/ops/flash_backward.py::_kernel_dq and ::_kernel_dkv
// (through flash_attention_bwd, the custom VJP of flash_attention).
//
// Both rebuild, tile by tile, what the forward computed (csrc/
// flash_attention.cu), from its per-row lse = m + log(l), so no (Tq, Tk)
// matrix reaches device memory. For batch row b, query head h (kv head
// h / (Hq/Hkv)), query i and key j:
//   s = (bf16(q_i) . bf16(k_j)) * scale;  t = tanh(s / c), s_e = c*t if c > 0
//   s_e = max(s_e + slope_h * mask[i, j], NEG)
//   p = exp(s_e - lse_i);  dp = bf16(dO_i) . bf16(v_j);  ds = p (dp - D_i)
//   ds *= 1 - t^2 with a softcap
//   dQ_i  = scale * sum_j bf16(ds) k_j          (dQ kernel)
//   dV_j  = sum_{h in group, i} bf16(p) dO_i    (dK/dV kernel)
//   dK_j  = scale * sum_{h in group, i} bf16(ds) q_i
// with D_i = rowsum(dO_i * O_i) computed by the caller. Keys past Tk and
// queries past Tq add nothing (p = ds = 0 there, whatever lse holds).
//
// Bound on the H100: at GPT-2 117M training (B 8, T 512, 12 heads, D 64,
// causal) 36 of the 64 tile pairs are computed, so the dQ kernel does
// 6*B*H*T^2*D*36/64 = 5.4 GFLOP (~5.5 us at 989 TFLOP/s) and dK/dV 7.2
// (~7.3 us), over 39 MB and 52 MB of q/k/v/dO, lse/D_i, the mask of the 8
// mixed tiles of each batch row, and the outputs (~11.7 and ~15.5 us at
// 3.35 TB/s): both bound by bytes.
//
// Tile map (ggml_flash_backward_tiles). One pass over the prepared mask m3
// (B, Tq, Tk), already clamped at NEG, writes for each 64 x 64 tile (b,
// query tile, key tile) one class: all NEG, all 0 or mixed. Both kernels
// read the map: they read no mask in an all-0 tile (the mask term is 0) nor
// in an all-NEG tile (it is NEG * slope_h), only in a mixed one, and they
// skip an all-NEG tile, loads included, when the skip is exact. It is exact
// when every valid query row of the tile has lse > -1e30 and NEG * slope_h
// < -1e32: each score is then max(s_e + NEG * slope_h, NEG) - lse < -1e32 +
// 2e30 for any |s_e| < 1e30 (a score that large overflows the forward's
// exp sums first), so p = exp(...) is 0 exactly, ds = p (dp - D_i)(1 - t^2)
// is 0 exactly, and the tile adds exact zeros to every sum. A row with no
// visible key fails the guard: its lse is about NEG * slope_h + log(Tk)
// (its forward's uniform P), so its p is not 0 and the tile is computed.
// The guard looks at the query rows a block walks at once: 64 (the dQ
// kernel; dK/dV at D 64 and D 256), 32 (dK/dV at D 128, whose query steps
// are 32 rows: it may compute one half of such a tile and skip the other).
// The map is a property of the mask, not a causal assumption: a sliding
// window or a cell mask skips its own empty tiles. Without a mask every tile
// is all 0 (no map); a mask comes with its map.
//
// Register route, D <= 128 (GPT-2's 64; D < 64 runs the 64 instance with the
// columns past D zero, D in (64, 128) the 128 one): FlashAttention-2's
// structure on mma.sync m16n8k16 (bf16, f32 sums), operands through
// ldmatrix, blocks of 4 warps.
//  - dK/dV block: 64 keys of one kv head, 16 a warp; K and V are copied once
//    (at D 64 into A fragments in registers). It walks the query tiles of
//    every q head of its GQA group (the group sum happens in the block, in
//    a fixed order): per tile S^T = K Q^T and dP^T = V dO^T land in
//    accumulator fragments, P^T and dS^T are formed there (lse and D_i
//    broadcast along the columns), rounded to bf16 A fragments in registers
//    (the m16n8 accumulator layout is the m16n8k16 A layout), then dV +=
//    P^T dO and dK += dS^T Q with Q and dO as B through ldmatrix.trans. dK
//    and dV stay in registers (64 f32 a thread at D 64).
//  - dQ block: 64 query rows of one head, 16 a warp, Q and dO at D 64 in
//    registers; per key tile S = Q K^T and dP = dO V^T in fragments, dS in
//    registers, dQ += dS K with K through ldmatrix.trans.
//  - No score, P or dS tile touches shared memory. The streamed tiles (Q,
//    dO, lse, D_i for dK/dV; K, V for dQ; a mixed tile's mask, 64 x 64 f32)
//    are double-buffered with cp.async: the next live tile's copy is in
//    flight during the current tile's products; one __syncthreads a tile.
//  - Each block first writes every step's class (or "skipped") to shared
//    memory, its map and lse loads in flight together, so the walk reads
//    no device memory to find its next tile.
//  - The element-wise step is straight-line code: the tile's class picks
//    one of three copies of it, an invalid score (past Tq or Tk) takes
//    exp(-inf) = 0 instead of a branch, and softcap is a template flag.
//  - Blocks start in grid order, tile index slowest, so under a causal mask
//    the tiles with the most work go first and the light ones fill the tail.
//  - D 64: tiles of 64; D 128: the streamed tile is 32 rows and the A
//    operands are read from shared memory at each use (K, V, Q and dO
//    fragments would not fit beside the 128 f32 of dK and dV). Two blocks
//    fit on an SM at D 64 and at D 128 (-Xptxas -v for the H100: dQ 232-236
//    and dK/dV 244 registers a thread at D 64, 204-206 and 250 at D 128, so
//    two 128-thread blocks; 88-92 KB of shared memory a block). Three or
//    four blocks an SM (A operands from shared memory, registers capped at
//    168 or 128) measured no faster.
//
// Shared-memory route, D > 128 (GPT-J's 256; on no path that trains): the
// register route's dK and dV would need 256 f32 a thread, so these blocks of
// 8 warps keep the first port's nvcuda::wmma design: products stored as f32
// tiles in shared memory, synchronous 16-byte tile loads, key tiles of 32
// (dQ: ~190 KB; dK/dV: ~196 KB). It reads the same tile map, skips the same
// tiles and starts its blocks in the same order.
//
// Every sum is taken by one block in a fixed order (no atomics): the same
// bits on every run.
#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr float kNeg = -0.7f * FLT_MAX;
constexpr int kTile = 64;                        // the map's query and key tile
constexpr uint8_t kTileZero = 0, kTileMixed = 1, kTileNeg = 2;
typedef __nv_bfloat16 bf16;

struct Args {
  const bf16 *q, *k, *v, *dout;      // (B, Tq, Hq, D), (B, Tk, Hkv, D) x2, (B, Tq, Hq, D)
  const float *lse, *di;             // (B, Hq, Tq)
  const float *mask, *slopes;        // (B, Tq, Tk) >= NEG or null; (Hq) or null
  const uint8_t* tiles;              // (B, ceil(Tq/64), ceil(Tk/64)) classes or null
  float *dq, *dk, *dv;               // (B, Tq, Hq, D); (B, Tk, Hkv, D) x2
  int Tq, Tk, Hq, Hkv, D;
  float scale, softcap;
};

// ---------------------------------------------------------------- tile map

// grid (ceil(Tk/64), ceil(Tq/64), B): the class of one tile of the mask.
// Each thread's loads are all in flight at once (16 floats: four float4
// when Tk % 4 == 0).
__global__ void __launch_bounds__(256) flash_bwd_tiles_kernel(const float* mask, uint8_t* tiles,
                                                              int Tq, int Tk) {
  constexpr int kPer = kTile * kTile / 256;
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int nr = min(kTile, Tq - qt * kTile), nc = min(kTile, Tk - kt * kTile);
  const float* base = mask + ((size_t)b * Tq + qt * kTile) * Tk + kt * kTile;
  bool not_neg = false, not_zero = false;
  if ((Tk & 3) == 0) {
    float4 v[kPer / 4];
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int e = threadIdx.x + i * 256, r = e / (kTile / 4), c = e % (kTile / 4) * 4;
      v[i] = r < nr && c < nc ? *reinterpret_cast<const float4*>(base + (size_t)r * Tk + c)
                              : make_float4(kNeg, kNeg, kNeg, kNeg);
    }
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int e = threadIdx.x + i * 256, c = e % (kTile / 4) * 4;
      if (e / (kTile / 4) < nr && c < nc) {
        not_neg |= v[i].x != kNeg || v[i].y != kNeg || v[i].z != kNeg || v[i].w != kNeg;
        not_zero |= v[i].x != 0.f || v[i].y != 0.f || v[i].z != 0.f || v[i].w != 0.f;
      }
    }
  } else {
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * 256, r = e / kTile, c = e % kTile;
      v[i] = r < nr && c < nc ? base[(size_t)r * Tk + c] : kNeg;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * 256;
      if (e / kTile < nr && e % kTile < nc) {
        not_neg |= v[i] != kNeg;
        not_zero |= v[i] != 0.f;
      }
    }
  }
  not_neg = __syncthreads_or(not_neg);
  not_zero = __syncthreads_or(not_zero);
  if (threadIdx.x == 0)
    tiles[((size_t)b * gridDim.y + qt) * gridDim.x + kt] =
        !not_neg ? kTileNeg : !not_zero ? kTileZero : kTileMixed;
}

// The class of the map tile holding (query q0, key k0).
__device__ __forceinline__ int tile_class(const Args& a, int b, int q0, int k0) {
  if (a.mask == nullptr) return kTileZero;
  const int nqt = (a.Tq + kTile - 1) / kTile, nkt = (a.Tk + kTile - 1) / kTile;
  return a.tiles[((size_t)b * nqt + q0 / kTile) * nkt + k0 / kTile];
}

// Whether query rows [q0, q0 + n) of head h may skip an all-NEG tile (the
// guard above). Every warp reads the same values, so the answer is the same
// in every thread of the block.
__device__ bool may_skip(const Args& a, int b, int h, int q0, int n) {
  const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;
  bool ok = a.mask != nullptr && slope * kNeg < -1e32f;
  const float* lse = a.lse + ((size_t)b * a.Hq + h) * a.Tq;
  for (int r = threadIdx.x & 31; r < n; r += 32)
    if (q0 + r < a.Tq) ok &= lse[q0 + r] > -1e30f;
  return __all_sync(0xffffffffu, ok);
}

// The mask term slope * mask[qi, kj] of a tile of class cls (read only in a
// mixed tile; NEG past the edges, where p and ds are zeroed anyway).
__device__ __forceinline__ float mask_term(const Args& a, int cls, int b, int qi, int kj,
                                           float slope) {
  if (cls == kTileZero) return 0.f;
  if (cls == kTileNeg) return kNeg * slope;
  return (qi < a.Tq && kj < a.Tk ? a.mask[((size_t)b * a.Tq + qi) * a.Tk + kj] : kNeg) * slope;
}

// exp(x) as 2^(x log2 e) on the MUFU unit, results below 2^-126 flushed to 0
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// p and ds of one score from its product sv (unscaled), dp, the row's lse
// and D_i and the mask term mb; an invalid score (past Tq or Tk) gives p =
// exp(-inf) = 0 and ds = 0 (its dp and D_i are finite), with no branch.
template <bool kCap>
__device__ __forceinline__ void p_ds_one(float sv, float dpv, float lse, float di, float mb,
                                         float scale, float cap, bool valid, float& p,
                                         float& ds) {
  const float s = sv * scale;
  float t = 0.f, se = s;
  if constexpr (kCap) {
    t = tanhf(s / cap);
    se = cap * t;
  }
  se = fmaxf(se + mb, kNeg);
  p = exp_ftz(valid ? se - lse : -INFINITY);
  ds = p * (dpv - di);
  if constexpr (kCap) ds *= 1.f - t * t;
}

// ------------------------------------------------------- register route

constexpr int kThreads = 128;   // 4 warps, 16 rows (dQ: queries; dK/dV: keys) each
constexpr uint8_t kStepSkipped = 3;

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
// tile;
__device__ __forceinline__ int a_off(int ld, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// the B fragments of n-blocks [n0, n0 + 16) at k [c0, c0 + 16) of an [n][k]
// tile (S = X Y^T with Y stored by rows).
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

// rows [r0, r0 + n) of a (T, rowstride) bf16 matrix, columns [0, kD) -> a
// tile of row stride kD + 8 by cp.async, zero past T and past D
template <int kD, int n>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t rowstride, int r0,
                                          int T, int D) {
  constexpr int chunks = kD / 8;
  static_assert(n * chunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < n * chunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c / chunks, part = c % chunks;
    const bool ok = r0 + r < T && part * 8 < D;
    cp16(dst + r * (kD + 8) + part * 8, ok ? src + (size_t)(r0 + r) * rowstride + part * 8 : src,
         ok);
  }
}
// src[i0, i0 + n) f32 -> dst by cp.async, zero past T
template <int n>
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int i0, int T) {
  const int i = threadIdx.x;
  if (i < n) cp4(dst + i, i0 + i < T ? src + i0 + i : src, i0 + i < T);
}
// the mask of queries [q0, q0 + nq) and keys [k0, k0 + nk) of batch row b
// -> a tile of row stride ld by cp.async, w floats a copy (4 when Tk % 4 ==
// 0, else 1), zero past the edges
template <int nq, int nk, int w>
__device__ __forceinline__ void copy_mask(float* dst, int ld, const Args& a, int b, int q0,
                                          int k0) {
  constexpr int per = nk / w;
  const float* src = a.mask + (size_t)b * a.Tq * a.Tk;
#pragma unroll 4
  for (int c = threadIdx.x; c < nq * per; c += kThreads) {
    const int r = c / per, col = c % per * w;
    const bool ok = q0 + r < a.Tq && k0 + col < a.Tk;
    const float* from = ok ? src + (size_t)(q0 + r) * a.Tk + k0 + col : src;
    if constexpr (w == 4) cp16(dst + r * ld + col, from, ok);
    else cp4(dst + r * ld + col, from, ok);
  }
}
template <int nq, int nk>
__device__ __forceinline__ void copy_mask(float* dst, int ld, const Args& a, int b, int q0,
                                          int k0) {
  if ((a.Tk & 3) == 0) copy_mask<nq, nk, 4>(dst, ld, a, b, q0, k0);
  else copy_mask<nq, nk, 1>(dst, ld, a, b, q0, k0);
}

template <int kD, int BS>
struct DqShape {
  static constexpr int LD = kD + 8, MLD = BS + 8;
  // Q and dO (64 rows); two stages of K and V (BS rows each); two stages of
  // a mixed tile's mask (64 x BS f32); then one flag a key step
  static constexpr size_t mask = sizeof(bf16) * (2 * 64 * LD + 2 * 2 * BS * LD);
  static constexpr size_t flags = mask + sizeof(float) * 2 * 64 * MLD;
  static_assert(mask % 16 == 0 && flags % 16 == 0, "regions stay 16-byte aligned");
};

// dS of a warp's 16 query rows x BS keys, rounded to bf16 A fragments:
// element e of n-block j is row g + 8 (e / 2), key 8 j + 2 t + e % 2; mterm
// gives the mask term of (e / 2, j, e % 2). Rows past Tq (rowv) and keys at
// or past kvalid (from column 2 t) give 0.
template <bool kCap, int NB, typename M>
__device__ __forceinline__ void form_ds(const float (&sc)[NB][4], const float (&dp)[NB][4],
                                        uint32_t (&dsa)[NB / 2][4], const float (&lse)[2],
                                        const float (&di)[2], const bool (&rowv)[2], int kvalid,
                                        float scale, float cap, M mterm) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float ds2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p;
        p_ds_one<kCap>(sc[j][2 * hr + e], dp[j][2 * hr + e], lse[hr], di[hr], mterm(hr, j, e),
                       scale, cap, rowv[hr] && 8 * j + e < kvalid, p, ds2[e]);
      }
      dsa[j / 2][(j & 1) * 2 + hr] = pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// grid (Hq, B, ceil(Tq / 64)): dQ of 64 query rows of head h. Blocks start
// in grid order, so the last query tiles go first: under a causal mask they
// have the most live key tiles, and the light ones fill the tail.
template <int kD, int BS, bool kAReg, bool kCap>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(Args a) {
  using Shape = DqShape<kD, BS>;
  constexpr int LD = Shape::LD, MLD = Shape::MLD, NB = BS / 8, DS = kD / 16, DB = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + 64 * LD;
  bf16* stages = dOs + 64 * LD;     // stage st: K at stages + st * 2 * BS * LD, V BS * LD after
  float* masks = reinterpret_cast<float*>(smem + Shape::mask);
  uint8_t* flags = smem + Shape::flags;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64, h = blockIdx.x, b = blockIdx.y;
  const int D = a.D, hk = h / (a.Hq / a.Hkv);
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;
  const int nsteps = (a.Tk + BS - 1) / BS;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;

  copy_rows<kD, 64>(Qs, a.q + qbase, qstride, q0, a.Tq, D);
  copy_rows<kD, 64>(dOs, a.dout + qbase, qstride, q0, a.Tq, D);
  cp_commit();
  // each key step's class, or kStepSkipped (the class loads and the guard's
  // lse loads in flight together)
  const int cls0 = threadIdx.x < nsteps ? tile_class(a, b, q0, threadIdx.x * BS) : 0;
  const bool skippable = may_skip(a, b, h, q0, 64);
  for (int s = threadIdx.x; s < nsteps; s += kThreads) {
    const int cls = s == threadIdx.x ? cls0 : tile_class(a, b, q0, s * BS);
    flags[s] = skippable && cls == kTileNeg ? kStepSkipped : cls;
  }
  __syncthreads();
  auto live = [&](int s) {       // the first key step >= s that is computed
    while (s < nsteps && flags[s] == kStepSkipped) ++s;
    return s;
  };
  auto load = [&](int s, int st) {
    bf16* Ks = stages + st * 2 * BS * LD;
    copy_rows<kD, BS>(Ks, a.k + kbase, kstride, s * BS, a.Tk, D);
    copy_rows<kD, BS>(Ks + BS * LD, a.v + kbase, kstride, s * BS, a.Tk, D);
    if (flags[s] == kTileMixed) copy_mask<64, BS>(masks + st * 64 * MLD, MLD, a, b, q0, s * BS);
    cp_commit();
  };
  int s = live(0);
  if (s < nsteps) load(s, 0);
  const int r0 = q0 + warp * 16 + g;          // this thread's rows r0, r0 + 8
  float lse_r[2], di_r[2];
  bool rowv[2];
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = ((size_t)b * a.Hq + h) * a.Tq + r0 + 8 * hr;
    rowv[hr] = r0 + 8 * hr < a.Tq;
    lse_r[hr] = rowv[hr] ? a.lse[row] : 0.f;
    di_r[hr] = rowv[hr] ? a.di[row] : 0.f;
  }
  cp_wait_all();
  __syncthreads();
  uint32_t qf[kAReg ? DS : 1][4], of[kAReg ? DS : 1][4];
  if constexpr (kAReg) {
#pragma unroll
    for (int ks = 0; ks < DS; ++ks) {
      ldsm4(qf[ks], Qs + a_off(LD, warp * 16, ks * 16, lane));
      ldsm4(of[ks], dOs + a_off(LD, warp * 16, ks * 16, lane));
    }
  }
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int st = 0; s < nsteps; st ^= 1) {
    const int sn = live(s + 1);
    if (sn < nsteps) load(sn, st ^ 1);
    const bf16* Ks = stages + st * 2 * BS * LD;
    const bf16* Vs = Ks + BS * LD;
    // S = Q K^T, dP = dO V^T: 16 queries x BS keys a warp (columns past D
    // are zero in every tile)
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DS; ++ks) {
      uint32_t aq[4], ao[4];
      if constexpr (kAReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qf[ks][i], ao[i] = of[ks][i];
      } else {
        ldsm4(aq, Qs + a_off(LD, warp * 16, ks * 16, lane));
        ldsm4(ao, dOs + a_off(LD, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        uint32_t bk[4], bv[4];
        ldsm4(bk, Ks + bt_off(LD, jp * 16, ks * 16, lane));
        ldsm4(bv, Vs + bt_off(LD, jp * 16, ks * 16, lane));
        mma(sc[2 * jp], aq, bk[0], bk[1]);
        mma(sc[2 * jp + 1], aq, bk[2], bk[3]);
        mma(dp[2 * jp], ao, bv[0], bv[1]);
        mma(dp[2 * jp + 1], ao, bv[2], bv[3]);
      }
    }
    uint32_t dsa[NB / 2][4];
    const int cls = flags[s], kvalid = a.Tk - s * BS - 2 * t;
    if (cls == kTileZero) {
      form_ds<kCap>(sc, dp, dsa, lse_r, di_r, rowv, kvalid, a.scale, a.softcap,
                    [](int, int, int) { return 0.f; });
    } else if (cls == kTileNeg) {
      const float mneg = kNeg * slope;
      form_ds<kCap>(sc, dp, dsa, lse_r, di_r, rowv, kvalid, a.scale, a.softcap,
                    [=](int, int, int) { return mneg; });
    } else {
      const float* ms = masks + st * 64 * MLD + (warp * 16 + g) * MLD + 2 * t;
      form_ds<kCap>(sc, dp, dsa, lse_r, di_r, rowv, kvalid, a.scale, a.softcap,
                    [=](int hr, int j, int e) { return ms[8 * hr * MLD + 8 * j + e] * slope; });
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DB / 2; ++dn) {
        uint32_t bk[4];
        ldsm4_t(bk, Ks + a_off(LD, kk * 16, dn * 16, lane));
        mma(acc[2 * dn], dsa[kk], bk[0], bk[1]);
        mma(acc[2 * dn + 1], dsa[kk], bk[2], bk[3]);
      }
    }
    cp_wait_all();
    __syncthreads();
    s = sn;
  }
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    const int d = 8 * j + 2 * t;
    for (int hr = 0; hr < 2; ++hr) {
      if (d < D && rowv[hr])
        *reinterpret_cast<float2*>(a.dq + ((size_t)b * a.Tq + r0 + 8 * hr) * qstride +
                                   (size_t)h * D + d) =
            make_float2(acc[j][2 * hr] * a.scale, acc[j][2 * hr + 1] * a.scale);
    }
  }
}

template <int kD, int BS>
struct DkvShape {
  static constexpr int LD = kD + 8, MLD = 64 + 4;
  // one stage: Q and dO (BS rows), lse and D_i (BS f32), a mixed tile's
  // mask (BS x 64 f32)
  static constexpr size_t stage = sizeof(bf16) * 2 * BS * LD + sizeof(float) * (2 * BS + BS * MLD);
  // K and V (64 rows), then two stages, then one flag a step
  static constexpr size_t flags = sizeof(bf16) * 2 * 64 * LD + 2 * stage;
  static_assert(stage % 16 == 0 && flags % 16 == 0, "regions stay 16-byte aligned");
};

// P^T and dS^T of a warp's 16 keys x BS queries, rounded to bf16 A
// fragments: element e of n-block j is key g + 8 (e / 2), query 8 j + 2 t +
// e % 2, whose lse and D_i are ls[8 j + 2 t + e % 2], ls[BS + ...]; mterm
// gives the mask term of (e / 2, j, e % 2). Keys past Tk (keyv) and queries
// at or past qvalid (from column 2 t) give 0.
template <bool kCap, int NB, typename M>
__device__ __forceinline__ void form_p_ds(const float (&sc)[NB][4], const float (&dp)[NB][4],
                                          uint32_t (&pa)[NB / 2][4], uint32_t (&da)[NB / 2][4],
                                          const float* ls, const bool (&keyv)[2], int qvalid,
                                          int t, float scale, float cap, M mterm) {
  constexpr int BS = NB * 8;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(ls + BS + 8 * j + 2 * t);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float p2[2], ds2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        p_ds_one<kCap>(sc[j][2 * hr + e], dp[j][2 * hr + e], e ? l2.y : l2.x, e ? d2.y : d2.x,
                       mterm(hr, j, e), scale, cap, keyv[hr] && 8 * j + e < qvalid, p2[e],
                       ds2[e]);
      pa[j / 2][(j & 1) * 2 + hr] = pack_bf16(p2[0], p2[1]);
      da[j / 2][(j & 1) * 2 + hr] = pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// grid (Hkv, B, ceil(Tk / 64)): dK and dV of keys [k0, k0 + 64) of kv head
// hk, summed over the query tiles of every q head of its group. The first
// key tiles go first (under a causal mask they have the most live query
// tiles).
template <int kD, int BS, bool kAReg, bool kCap>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_kernel(Args a) {
  using Shape = DkvShape<kD, BS>;
  constexpr int LD = Shape::LD, MLD = Shape::MLD, NB = BS / 8, DS = kD / 16, DB = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LD;
  unsigned char* stages = smem + sizeof(bf16) * 2 * 64 * LD;
  uint8_t* flags = smem + Shape::flags;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.z * 64, hk = blockIdx.x, b = blockIdx.y;
  const int D = a.D, rep = a.Hq / a.Hkv;
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;
  const int nqs = (a.Tq + BS - 1) / BS, nsteps = rep * nqs;   // step s: head hk*rep + s/nqs

  copy_rows<kD, 64>(Ks, a.k + kbase, kstride, k0, a.Tk, D);
  copy_rows<kD, 64>(Vs, a.v + kbase, kstride, k0, a.Tk, D);
  cp_commit();
  // each step's class, or kStepSkipped: a warp a step, its class and the
  // guard's lse loads in flight together
#pragma unroll 2
  for (int s = warp; s < nsteps; s += kThreads / 32) {
    const int h = hk * rep + s / nqs, q0 = s % nqs * BS;
    const int cls = tile_class(a, b, q0, k0);
    if (may_skip(a, b, h, q0, BS) && cls == kTileNeg) {
      if (lane == 0) flags[s] = kStepSkipped;
    } else if (lane == 0) {
      flags[s] = cls;
    }
  }
  __syncthreads();
  auto live = [&](int s) {       // the first step >= s that is computed
    while (s < nsteps && flags[s] == kStepSkipped) ++s;
    return s;
  };
  auto stage_q = [&](int st) { return reinterpret_cast<bf16*>(stages + st * Shape::stage); };
  auto load = [&](int s, int st) {
    const int h = hk * rep + s / nqs, q0 = s % nqs * BS;
    bf16* Qs = stage_q(st);
    float* ls = reinterpret_cast<float*>(Qs + 2 * BS * LD);
    const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
    const size_t row = ((size_t)b * a.Hq + h) * a.Tq;
    copy_rows<kD, BS>(Qs, a.q + qbase, qstride, q0, a.Tq, D);
    copy_rows<kD, BS>(Qs + BS * LD, a.dout + qbase, qstride, q0, a.Tq, D);
    copy_floats<BS>(ls, a.lse + row, q0, a.Tq);
    copy_floats<BS>(ls + BS, a.di + row, q0, a.Tq);
    if (flags[s] == kTileMixed) copy_mask<BS, 64>(ls + 2 * BS, MLD, a, b, q0, k0);
    cp_commit();
  };
  int s = live(0);
  if (s < nsteps) load(s, 0);
  cp_wait_all();
  __syncthreads();
  uint32_t kf[kAReg ? DS : 1][4], vf[kAReg ? DS : 1][4];
  if constexpr (kAReg) {
#pragma unroll
    for (int ks = 0; ks < DS; ++ks) {
      ldsm4(kf[ks], Ks + a_off(LD, warp * 16, ks * 16, lane));
      ldsm4(vf[ks], Vs + a_off(LD, warp * 16, ks * 16, lane));
    }
  }
  const int kj0 = k0 + warp * 16 + g;         // this thread's keys kj0, kj0 + 8
  const bool keyv[2] = {kj0 < a.Tk, kj0 + 8 < a.Tk};
  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

  for (int st = 0; s < nsteps; st ^= 1) {
    const int sn = live(s + 1);
    if (sn < nsteps) load(sn, st ^ 1);
    const int h = hk * rep + s / nqs, q0 = s % nqs * BS;
    const bf16* Qs = stage_q(st);
    const bf16* dOs = Qs + BS * LD;
    const float* ls = reinterpret_cast<const float*>(Qs + 2 * BS * LD);
    // S^T = K Q^T, dP^T = V dO^T: 16 keys x BS queries a warp
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DS; ++ks) {
      uint32_t ak[4], av[4];
      if constexpr (kAReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[i] = kf[ks][i], av[i] = vf[ks][i];
      } else {
        ldsm4(ak, Ks + a_off(LD, warp * 16, ks * 16, lane));
        ldsm4(av, Vs + a_off(LD, warp * 16, ks * 16, lane));
      }
#pragma unroll
      for (int jp = 0; jp < NB / 2; ++jp) {
        uint32_t bq[4], bo[4];
        ldsm4(bq, Qs + bt_off(LD, jp * 16, ks * 16, lane));
        ldsm4(bo, dOs + bt_off(LD, jp * 16, ks * 16, lane));
        mma(sc[2 * jp], ak, bq[0], bq[1]);
        mma(sc[2 * jp + 1], ak, bq[2], bq[3]);
        mma(dp[2 * jp], av, bo[0], bo[1]);
        mma(dp[2 * jp + 1], av, bo[2], bo[3]);
      }
    }
    uint32_t pa[NB / 2][4], da[NB / 2][4];
    const int cls = flags[s], qvalid = a.Tq - q0 - 2 * t;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;
    if (cls == kTileZero) {
      form_p_ds<kCap>(sc, dp, pa, da, ls, keyv, qvalid, t, a.scale, a.softcap,
                      [](int, int, int) { return 0.f; });
    } else if (cls == kTileNeg) {
      const float mneg = kNeg * slope;
      form_p_ds<kCap>(sc, dp, pa, da, ls, keyv, qvalid, t, a.scale, a.softcap,
                      [=](int, int, int) { return mneg; });
    } else {             // the mask tile: row = query, column = key
      const float* ms = ls + 2 * BS + 2 * t * MLD + warp * 16 + g;
      form_p_ds<kCap>(sc, dp, pa, da, ls, keyv, qvalid, t, a.scale, a.softcap,
                      [=](int hr, int j, int e) { return ms[(8 * j + e) * MLD + 8 * hr] * slope; });
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DB / 2; ++dn) {
        uint32_t bo[4], bq[4];
        ldsm4_t(bo, dOs + a_off(LD, kk * 16, dn * 16, lane));
        ldsm4_t(bq, Qs + a_off(LD, kk * 16, dn * 16, lane));
        mma(dv[2 * dn], pa[kk], bo[0], bo[1]);
        mma(dv[2 * dn + 1], pa[kk], bo[2], bo[3]);
        mma(dk[2 * dn], da[kk], bq[0], bq[1]);
        mma(dk[2 * dn + 1], da[kk], bq[2], bq[3]);
      }
    }
    cp_wait_all();
    __syncthreads();
    s = sn;
  }
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    const int d = 8 * j + 2 * t;
    for (int hr = 0; hr < 2; ++hr) {
      if (d < D && keyv[hr]) {
        const size_t o = ((size_t)b * a.Tk + kj0 + 8 * hr) * kstride + (size_t)hk * D + d;
        *reinterpret_cast<float2*>(a.dk + o) =
            make_float2(dk[j][2 * hr] * a.scale, dk[j][2 * hr + 1] * a.scale);
        *reinterpret_cast<float2*>(a.dv + o) = make_float2(dv[j][2 * hr], dv[j][2 * hr + 1]);
      }
    }
  }
}

// -------------------------------------------------- shared-memory route

constexpr int kWideThreads = 256, kWideWarps = kWideThreads / 32;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// rows [r0, r0 + n) of a (T, rowstride) bf16 matrix -> tile (zero past T)
__device__ void load_rows(bf16* dst, int ld, const bf16* src, size_t rowstride, int r0,
                          int n, int T, int D) {
  const int chunks = D / 8;
  for (int c = threadIdx.x; c < n * chunks; c += kWideThreads) {
    const int r = c / chunks, part = c % chunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * rowstride + part * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + part * 8) = val;
  }
}

// C (M x N f32, row-major, ldc) = [C +] A (M x K) . B (K x N), A and B bf16 in
// the given wmma layouts; the 16x16 tiles of C are dealt to the warps in turn.
// A row-major: A(r, c) = A[r * lda + c]; col-major: A[c * lda + r]; so too B.
template <typename LA, typename LB>
__device__ void warp_gemm(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb,
                          int M, int N, int K, bool accumulate) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
  const int warp = threadIdx.x / 32, tn = N / 16;
  for (int t = warp; t < (M / 16) * tn; t += kWideWarps) {
    const int i = t / tn * 16, j = t % tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    if (accumulate) wmma::load_matrix_sync(cf, C + i * ldc + j, ldc, wmma::mem_row_major);
    else wmma::fill_fragment(cf, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
      wmma::load_matrix_sync(af, a_row ? A + i * lda + kk : A + kk * lda + i, lda);
      wmma::load_matrix_sync(bfr, b_row ? B + kk * ldb + j : B + j * ldb + kk, ldb);
      wmma::mma_sync(cf, af, bfr, cf);
    }
    wmma::store_matrix_sync(C + i * ldc + j, cf, ldc, wmma::mem_row_major);
  }
}

// The shared tile math of both wide kernels: from S = Q K^T (Ss) and dP =
// dO V^T (dPs) of query rows [q0, q0 + BQ) and keys [k0, k0 + BK) in a map
// tile of class cls, write bf16(ds) to dSs and, if Ps is given, bf16(p) to
// Ps. Invalid rows and keys give 0.
template <int BQ, int BK>
__device__ void p_ds(const Args& a, int b, int h, int q0, int k0, int cls, const float* Ss,
                     const float* dPs, const float* lse_s, const float* di_s, bf16* dSs,
                     bf16* Ps) {
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;
  for (int e = threadIdx.x; e < BQ * BK; e += kWideThreads) {
    const int r = e / BK, c = e % BK, qi = q0 + r, kj = k0 + c;
    float p = 0.f, ds = 0.f;
    if (qi < a.Tq && kj < a.Tk) {
      const float mb = mask_term(a, cls, b, qi, kj, slope);
      if (a.softcap > 0.f)
        p_ds_one<true>(Ss[r * LDS + c], dPs[r * LDS + c], lse_s[r], di_s[r], mb, a.scale,
                       a.softcap, true, p, ds);
      else
        p_ds_one<false>(Ss[r * LDS + c], dPs[r * LDS + c], lse_s[r], di_s[r], mb, a.scale,
                        a.softcap, true, p, ds);
    }
    dSs[r * LDB + c] = __float2bfloat16_rn(ds);
    if (Ps != nullptr) Ps[r * LDB + c] = __float2bfloat16_rn(p);
  }
}

// Shared-memory layouts: bf16 tiles of D + 8 columns, f32 score tiles of
// BK + 4, bf16 probability tiles of BK + 8, f32 accumulators of D + 4; each
// region starts on a 128-byte boundary.
struct Bump {
  size_t total = 0;
  __host__ __device__ size_t add(size_t bytes) {
    const size_t at = total;
    total += align128(bytes);
    return at;
  }
};

template <int BQ, int BK>
struct WideDqLayout {
  size_t q, dout, k, v, s, dp, ds, acc, total;
  __host__ __device__ explicit WideDqLayout(int D) {
    Bump m;
    q = m.add(sizeof(bf16) * BQ * (D + 8));
    dout = m.add(sizeof(bf16) * BQ * (D + 8));
    k = m.add(sizeof(bf16) * BK * (D + 8));
    v = m.add(sizeof(bf16) * BK * (D + 8));
    s = m.add(sizeof(float) * BQ * (BK + 4));
    dp = m.add(sizeof(float) * BQ * (BK + 4));
    ds = m.add(sizeof(bf16) * BQ * (BK + 8));
    acc = m.add(sizeof(float) * BQ * (D + 4));
    total = m.total;
  }
};

// grid (Hq, B, ceil(Tq / BQ)): dQ of query rows [q0, q0 + BQ) of head h,
// the last query tiles first (as the register route's).
template <int BQ, int BK>
__global__ void __launch_bounds__(kWideThreads) flash_bwd_wide_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, lda = D + 4;
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const WideDqLayout<BQ, BK> L(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __shared__ float lse_s[BQ], di_s[BQ];

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;
  const bool skippable = may_skip(a, b, h, q0, BQ);

  load_rows(Qs, ld, a.q + qbase, qstride, q0, BQ, a.Tq, D);
  load_rows(dOs, ld, a.dout + qbase, qstride, q0, BQ, a.Tq, D);
  for (int r = threadIdx.x; r < BQ; r += kWideThreads) {
    const int qi = q0 + r;
    const size_t row = ((size_t)b * a.Hq + h) * a.Tq + qi;
    lse_s[r] = qi < a.Tq ? a.lse[row] : 0.f;
    di_s[r] = qi < a.Tq ? a.di[row] : 0.f;
  }
  for (int e = threadIdx.x; e < BQ * lda; e += kWideThreads) acc[e] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    const int cls = tile_class(a, b, q0, k0);
    if (skippable && cls == kTileNeg) continue;
    __syncthreads();   // the previous tile fully consumed
    load_rows(Ks, ld, a.k + kbase, kstride, k0, BK, a.Tk, D);
    load_rows(Vs, ld, a.v + kbase, kstride, k0, BK, a.Tk, D);
    __syncthreads();
    warp_gemm<wmma::row_major, wmma::col_major>(Ss, LDS, Qs, ld, Ks, ld, BQ, BK, D, false);
    warp_gemm<wmma::row_major, wmma::col_major>(dPs, LDS, dOs, ld, Vs, ld, BQ, BK, D, false);
    __syncthreads();
    p_ds<BQ, BK>(a, b, h, q0, k0, cls, Ss, dPs, lse_s, di_s, dSs, nullptr);
    __syncthreads();
    warp_gemm<wmma::row_major, wmma::row_major>(acc, lda, dSs, LDB, Ks, ld, BQ, D, BK, true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * D; e += kWideThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    if (qi < a.Tq) a.dq[((size_t)b * a.Tq + qi) * qstride + (size_t)h * D + d] = acc[r * lda + d] * a.scale;
  }
}

template <int BQ, int BK>
struct WideDkvLayout {
  size_t k, v, q, dout, s, dp, p, ds, dk, dv, total;
  __host__ __device__ explicit WideDkvLayout(int D) {
    Bump m;
    k = m.add(sizeof(bf16) * BK * (D + 8));
    v = m.add(sizeof(bf16) * BK * (D + 8));
    q = m.add(sizeof(bf16) * BQ * (D + 8));
    dout = m.add(sizeof(bf16) * BQ * (D + 8));
    s = m.add(sizeof(float) * BQ * (BK + 4));
    dp = m.add(sizeof(float) * BQ * (BK + 4));
    p = m.add(sizeof(bf16) * BQ * (BK + 8));
    ds = m.add(sizeof(bf16) * BQ * (BK + 8));
    dk = m.add(sizeof(float) * BK * (D + 4));
    dv = m.add(sizeof(float) * BK * (D + 4));
    total = m.total;
  }
};

// grid (Hkv, B, ceil(Tk / BK)): dK and dV of keys [k0, k0 + BK) of kv head
// hk, summed over the query tiles of every q head of its group.
template <int BQ, int BK>
__global__ void __launch_bounds__(kWideThreads) flash_bwd_wide_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, lda = D + 4;
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const WideDkvLayout<BQ, BK> L(D);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L.ds);
  float* dKs = reinterpret_cast<float*>(smem + L.dk);
  float* dVs = reinterpret_cast<float*>(smem + L.dv);
  __shared__ float lse_s[BQ], di_s[BQ];

  const int k0 = blockIdx.z * BK, hk = blockIdx.x, b = blockIdx.y;
  const int rep = a.Hq / a.Hkv;
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;

  load_rows(Ks, ld, a.k + kbase, kstride, k0, BK, a.Tk, D);
  load_rows(Vs, ld, a.v + kbase, kstride, k0, BK, a.Tk, D);
  for (int e = threadIdx.x; e < BK * lda; e += kWideThreads) dKs[e] = dVs[e] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
    for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
      const int cls = tile_class(a, b, q0, k0);
      if (cls == kTileNeg && may_skip(a, b, h, q0, BQ)) continue;
      __syncthreads();   // the previous query tile fully consumed
      load_rows(Qs, ld, a.q + qbase, qstride, q0, BQ, a.Tq, D);
      load_rows(dOs, ld, a.dout + qbase, qstride, q0, BQ, a.Tq, D);
      for (int r = threadIdx.x; r < BQ; r += kWideThreads) {
        const int qi = q0 + r;
        const size_t row = ((size_t)b * a.Hq + h) * a.Tq + qi;
        lse_s[r] = qi < a.Tq ? a.lse[row] : 0.f;
        di_s[r] = qi < a.Tq ? a.di[row] : 0.f;
      }
      __syncthreads();
      warp_gemm<wmma::row_major, wmma::col_major>(Ss, LDS, Qs, ld, Ks, ld, BQ, BK, D, false);
      warp_gemm<wmma::row_major, wmma::col_major>(dPs, LDS, dOs, ld, Vs, ld, BQ, BK, D, false);
      __syncthreads();
      p_ds<BQ, BK>(a, b, h, q0, k0, cls, Ss, dPs, lse_s, di_s, dSs, Ps);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: P^T (BK x BQ) is P read column-major
      warp_gemm<wmma::col_major, wmma::row_major>(dVs, lda, Ps, LDB, dOs, ld, BK, D, BQ, true);
      warp_gemm<wmma::col_major, wmma::row_major>(dKs, lda, dSs, LDB, Qs, ld, BK, D, BQ, true);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BK * D; e += kWideThreads) {
    const int r = e / D, d = e % D, kj = k0 + r;
    if (kj < a.Tk) {
      const size_t o = ((size_t)b * a.Tk + kj) * kstride + (size_t)hk * D + d;
      a.dk[o] = dKs[r * lda + d] * a.scale;
      a.dv[o] = dVs[r * lda + d];
    }
  }
}

// ---------------------------------------------------------------- launches

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* mask, const void* slopes,
               const void* tiles, void* dq, void* dk, void* dv, int Tq, int Tk, int Hq, int Hkv,
               int D, float scale, float softcap) {
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.di = (const float*)di;
  a.mask = (const float*)mask;
  a.slopes = (const float*)slopes;
  a.tiles = (const uint8_t*)tiles;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.Tq = Tq;
  a.Tk = Tk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

int launch(void (*kernel)(Args), dim3 grid, int threads, size_t smem, const Args& a,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

template <int kD, int BS, bool kAReg>
int launch_dq(const Args& a, int B, cudaStream_t s) {
  const dim3 grid(a.Hq, B, (a.Tq + 63) / 64);
  const size_t smem = DqShape<kD, BS>::flags + align16((a.Tk + BS - 1) / BS);
  return a.softcap > 0.f
             ? launch(flash_bwd_dq_kernel<kD, BS, kAReg, true>, grid, kThreads, smem, a, s)
             : launch(flash_bwd_dq_kernel<kD, BS, kAReg, false>, grid, kThreads, smem, a, s);
}

template <int kD, int BS, bool kAReg>
int launch_dkv(const Args& a, int B, cudaStream_t s) {
  const dim3 grid(a.Hkv, B, (a.Tk + 63) / 64);
  const size_t steps = (size_t)a.Hq / a.Hkv * ((a.Tq + BS - 1) / BS);
  const size_t smem = DkvShape<kD, BS>::flags + align16(steps);
  return a.softcap > 0.f
             ? launch(flash_bwd_dkv_kernel<kD, BS, kAReg, true>, grid, kThreads, smem, a, s)
             : launch(flash_bwd_dkv_kernel<kD, BS, kAReg, false>, grid, kThreads, smem, a, s);
}

}  // namespace

// q, dout (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D) bf16, 16-byte aligned; lse,
// di (B, Hq, Tq) f32; mask (B, Tq, Tk) f32 >= NEG, 16-byte aligned, or null;
// slopes (Hq) f32 or null; tiles the map of ggml_flash_backward_tiles of
// the mask (null without one); dq (B, Tq, Hq, D) f32. Requires D % 16 == 0, D <= 256 and
// Hq % Hkv == 0.
extern "C" int ggml_flash_backward_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      const void* mask, const void* slopes, const void* tiles,
                                      void* dq, int B, int Tq, int Tk, int Hq, int Hkv, int D,
                                      float scale, float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, mask, slopes, tiles, dq, nullptr, nullptr, Tq,
                           Tk, Hq, Hkv, D, scale, softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_dq<64, 64, true>(a, B, s);
  if (D <= 128) return launch_dq<128, 32, false>(a, B, s);
  return launch(flash_bwd_wide_dq_kernel<64, 32>, dim3(Hq, B, (Tq + 63) / 64), kWideThreads,
                WideDqLayout<64, 32>(D).total, a, s);
}

// The same inputs; dk, dv (B, Tk, Hkv, D) f32, summed over each GQA group.
extern "C" int ggml_flash_backward_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* di,
                                       const void* mask, const void* slopes, const void* tiles,
                                       void* dk, void* dv, int B, int Tq, int Tk, int Hq, int Hkv,
                                       int D, float scale, float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, mask, slopes, tiles, nullptr, dk, dv, Tq, Tk,
                           Hq, Hkv, D, scale, softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_dkv<64, 64, true>(a, B, s);
  if (D <= 128) return launch_dkv<128, 32, false>(a, B, s);
  return launch(flash_bwd_wide_dkv_kernel<64, 32>, dim3(Hkv, B, (Tk + 31) / 32), kWideThreads,
                WideDkvLayout<64, 32>(D).total, a, s);
}

// mask (B, Tq, Tk) f32 >= NEG, 16-byte aligned -> tiles (B, ceil(Tq/64),
// ceil(Tk/64)) uint8: 2 where every entry is NEG, 0 where every entry is 0,
// 1 otherwise.
extern "C" int ggml_flash_backward_tiles(const void* mask, void* tiles, int B, int Tq, int Tk,
                                         void* stream) {
  const dim3 grid((Tk + kTile - 1) / kTile, (Tq + kTile - 1) / kTile, B);
  flash_bwd_tiles_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)mask, (uint8_t*)tiles, Tq, Tk);
  return (int)cudaGetLastError();
}
