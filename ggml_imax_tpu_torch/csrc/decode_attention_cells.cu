// Read-only single-token attention for NB query rows of distinct sequences
// over the shared cell arena of continuous batching (one layer).
//
// Replaces: ggml_imax_tpu/ops/decode_attention.py::_kernel_cellsb (reached
// through decode_attention_cells / _decode_attn(cells=True)).
//
// The arena has batch 1 and holds every sequence's cells; row n's mask
// (NB, T) says which cells it sees (models.common.cells_attention_mask).
// The rows' fresh K/V are already in the arena (update_kv_cells).
//
// Computes, for query row n and head h (kv head h / (Hq/Hkv)), with NEG =
// -0.7 * FLT_MAX:
//   s[t] = max(dot(bf16(q), k[t]) * scale + mask[n, t], NEG)
//   an online softmax over 64-key chunks, p rounded to bf16 against the
//   running max, acc rescaled in f32 (as _kernel_cellsb), the ranks' (m, l,
//   acc) merged in rank order, out = acc / max(l, 1e-30).
// A pad row (every cell masked) scores NEG everywhere and so gets the mean
// of V over exactly T keys; keys past T in a partial last chunk score -inf.
// A q8_0 arena (int8, one f32 scale per 32 elements along D) is read as f32
// products rounded to bf16.
//
// Bound on the H100: bytes. Each K/V element of the layer is read once and
// feeds every query row of its kv head: at the serving ubatch (NB 8, 16
// heads of 256, T 2048) 18.9 MB of q8_0, 5.7 us at 3.35 TB/s, ~14 FLOP a
// byte; 33.6 MB of bf16, 10.1 us.
//
// Design: one launch, no workspace, no second pass (the loop of
// csrc/decode_attention_update.cu's cells mode, without its write).
// - Grid (S, Hkv, 1), S blocks a cluster along x; S from ops/
//   decode_attention.py decode_plan(1, Hkv, T) (8 at the serving shape: 128
//   blocks). Rank r owns keys [r ceil(T/S), ..) of one kv head; a block
//   holds all R = NB * g_rep query rows of that head, 16 at a time (the
//   mma's M; padded), so each K/V byte is read once a call (past 16 rows, a
//   slice too large to stay in shared memory is read again, from L2, for
//   each further 16 rows).
// - Two blocks an SM: 128 registers a thread and at most half an SM's
//   shared memory, so the 16 clusters of 8 of the serving shape run at once
//   (at one block an SM the last ran in a second wave).
// - Bytes in flight: the rank streams its keys in 64-key chunks through a
//   ring of as many stages as fit, each filled by tensor-memory-access
//   copies issued by lane 0 of a few warps and counted on the stage's
//   mbarrier: 64-key x 128-byte boxes of K and V (128-byte swizzled), the
//   q8_0 scales, and the chunk's mask columns for the rows (by cp.async
//   where a box would not start 16-byte aligned: an unaligned box start is
//   an illegal instruction). The queries go first, as 16-byte loads all
//   issued before any shared-memory store.
// - Tensor cores (mma.sync m16n8k16, bf16 in, f32 out). S = Q K^T: warp w
//   takes 8 keys of the chunk over all of D, its K fragments read straight
//   from the ring, 16 bytes a lane (the dot's d order is permuted alike in Q
//   and K, so a lane's 16 bytes are one key's consecutive elements; Q's
//   tile holds that order for ldmatrix); q8_0 bytes become f32 exactly by a
//   byte permute, times the scale, rounded to bf16. P V: warp w takes output
//   columns [w D/8, (w+1) D/8); P, rounded to bf16 from the S fragments,
//   passes through a 2 KB swizzled tile to every warp's A fragments
//   (ldmatrix); bf16 V by ldmatrix.trans, q8_0 V straight from its bytes (a
//   lane's 4 consecutive bytes of a key feed its column of the 4 n-tiles),
//   so no bf16 copy of V exists.
// - The ranks merge (m, l, acc) through distributed shared memory in rank
//   order, each writing its acc for output dimension d into the rank that
//   writes d: two launches on the same inputs give equal bits.
#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;         // keys a ring stage
constexpr int kTile = 16;          // query rows a pass (the mma's M)
constexpr int kMaxSplit = 8;       // a portable cluster's blocks (decode_plan's S)
constexpr int kMaxStages = 8;
constexpr int kBox = 128;          // bytes of a K/V box row (the 128-byte swizzle's span)
// shared memory a block takes: half an SM's (two blocks an SM), or a whole
// SM's where one stage does not fit in half
constexpr int kSmemBlock = 113 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr float kNeg = -0.7f * FLT_MAX;

struct Args {
  CUtensorMap tk, tv;      // the arena slice's K and V, boxes of 64 rows x kBox bytes
  CUtensorMap tks, tvs;    // q8_0: its scales, boxes of 64 rows x D/32
  CUtensorMap tm;          // the mask, boxes of mslots rows x 64 keys (mask_tma)
  const float* q;          // (NB, Hq, D)
  const uint8_t *k, *v;    // the layer's (1, T, Hkv*D) arena slice, bf16 or int8
  const float *ks, *vs;    // (1, T, Hkv*D/32) f32 (q8_0), else null
  const float* mask;       // (NB, T) f32 >= NEG
  float* out;              // (NB, Hq, D)
  int NB, Hq, Hkv, T, split, chunk, stages, mslots;
  int mask_tma;            // the mask by tensor copies (16-byte aligned boxes), else cp.async
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp4z(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}
// a ring stage's mbarrier: init, an arrival that expects `bytes` of
// tensor copies, a 2-D tensor copy global -> shared counted on it, and the
// wait for a phase's completion
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the tensor map's descriptor into the copy engine's cache ahead of use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the cluster barrier in halves: an arrival that orders no memory (every
// rank has started), a releasing arrival, and the acquiring wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the 4 int8 values of a 32-bit word times the scale s, rounded to bf16,
// as two bf16 pairs (values 0-1 in lo, 2-3 in hi). No conversion unit:
// each byte, its sign bit flipped, becomes the low byte of 2^23's mantissa
// (exactly 2^23 + 128 + v), less 2^23 + 128.
__device__ __forceinline__ void q8x4(uint32_t u, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t f = u ^ 0x80808080u;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = (__uint_as_float(__byte_perm(f, 0x4B000000u, 0x7650 + j)) - 8388736.f) * s;
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(x[2], x[3]);
  lo = *reinterpret_cast<const uint32_t*>(&p0);
  hi = *reinterpret_cast<const uint32_t*>(&p1);
}

template <int kD, bool kQ8>
struct Shape {
  static constexpr int EB = kQ8 ? 1 : 2;       // bytes an element
  static constexpr int RB = kD * EB;           // bytes of one head's row
  static constexpr int NSC = kD / 32;          // q8_0 scales of one head's row
  static constexpr int VPT = 16 / EB;          // K values a lane's 16 bytes hold
  static constexpr int KPG = VPT / 4;          // mma k-steps those 16 bytes feed
  static constexpr int NT = kD / 64;           // n-tiles of a warp's P V columns
  // a stage: K and V each RB / kBox boxes of 64 rows x kBox bytes, 16-byte
  // piece p of row r at p ^ (r & 7); the q8_0 scales (64 rows x NSC each);
  // the mask columns (mslots rows x 64); rounded to the swizzle's 1 KB
  static constexpr int BOX = kChunk * kBox;
  static constexpr int KV = 2 * (RB / kBox) * BOX + (kQ8 ? 2 * kChunk * NSC * 4 : 0);
  static constexpr int QT = kTile * kD * 2;              // the rows' queries, bf16
  static constexpr int PT = kTile * kChunk * 2;          // P, bf16
  // floats: red_m, red_l (kWarps x kTile); m, max(l, 1e-30) (kTile each); rank
  // weights (kTile x kMaxSplit); the maxima and l the ranks push here
  // (kMaxSplit x kTile each); then their acc (split x nrow x ndm)
  static constexpr int SMALL = 2 * kWarps * kTile + 2 * kTile + 3 * kMaxSplit * kTile;
  __host__ __device__ static size_t stage(int mslots) {
    return ((size_t)KV + (size_t)mslots * kChunk * 4 + 1023) / 1024 * 1024;
  }
  // the stages' mbarriers, then the parts that do not depend on the ring's
  // depth; the ranks' acc for nrow rows
  __host__ __device__ static size_t fixed(int split, int nrow) {
    const int ndm = (kD + split - 1) / split;
    return 8 * kMaxStages + QT + PT + 4 * ((size_t)SMALL + (size_t)split * nrow * ndm);
  }
};

// byte offset of 16-byte piece p of row r in a stage's K or V (128-byte
// swizzle within each box)
__device__ __forceinline__ int box_at(int r, int p) {
  return (p >> 3) * (kChunk * kBox) + r * kBox + (((p & 7) ^ (r & 7)) << 4);
}

// Q's tile holds each k-step's 16 elements in mma k order, so that
// ldmatrix gives the A fragments: k-step kk of lane quad c4 covers d0..d0+3,
// d0 = 4 VPT (kk / KPG) + VPT c4 + 4 (kk % KPG), at k 2 c4, 2 c4 + 1, 2 c4 +
// 8, 2 c4 + 9, as K's 16-byte lane loads give them. The byte offset of
// element d of row r, its 16-byte piece swizzled by r & 7.
template <int kD, bool kQ8>
__device__ __forceinline__ int q_at(int r, int d) {
  using Sh = Shape<kD, kQ8>;
  const int kk = d / (4 * Sh::VPT) * Sh::KPG + d % Sh::VPT / 4;
  const int c = d % (4 * Sh::VPT) / Sh::VPT, w4 = d % 4;
  const int pos = kk * 16 + 2 * c + (w4 & 1) + (w4 >> 1) * 8;
  return r * kD * 2 + (((pos >> 3) ^ (r & 7)) << 4) + (pos & 7) * 2;
}

template <int kD, bool kQ8>
__global__ void __launch_bounds__(kThreads, 2) cells_kernel(const __grid_constant__ Args a) {
  using Sh = Shape<kD, kQ8>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int S = a.split, rank = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, c4 = lane & 3;
  cg::cluster_group cluster = cg::this_cluster();
  // every rank has started before any writes into its shared memory: the
  // arrival now, the wait once this rank's keys are done
  if (S > 1) cluster_arrive_relaxed();

  const int g_rep = a.Hq / a.Hkv, R = a.NB * g_rep;
  const int nrow = min(R, kTile);  // rows of the ranks' pushed acc
  const size_t stb = Sh::stage(a.mslots);
  // the ring at the first 1 KB boundary (the swizzle's period); the same
  // offset in every block of the cluster
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)a.stages * stb);  // kMaxStages
  uint8_t* qt = reinterpret_cast<uint8_t*>(bars + kMaxStages);
  uint8_t* pt = qt + Sh::QT;
  float* red_m = reinterpret_cast<float*>(pt + Sh::PT);  // kWarps x kTile
  float* red_l = red_m + kWarps * kTile;
  float* mrun = red_l + kWarps * kTile;  // each row's max (the rank's)
  float* rden = mrun + kTile;            // each row's max(l, 1e-30)
  float* wr = rden + kTile;              // kTile x kMaxSplit: e^(m_r - M)
  float* inm = wr + kTile * kMaxSplit;   // kMaxSplit x kTile
  float* inl = inm + kMaxSplit * kTile;
  float* inacc = inl + kMaxSplit * kTile;  // split x nrow x ndm

  const int lo = min(rank * a.chunk, a.T), nk = min(a.chunk, a.T - lo);
  const int nch = (nk + kChunk - 1) / kChunk;
  const bool resident = nch <= a.stages;  // the whole slice stays in the ring
  const int ndm = (kD + S - 1) / S;

  // Chunk c into its stage: lane 0 of warp i issues its i-th tensor copy
  // (K's and V's boxes and the q8_0 scales where kv, the mask columns of
  // rows nf.. where mask_tma; the stage is free: every warp has passed a
  // barrier since its last read), warp 0 first arming the stage's mbarrier
  // for all of them (the phase cannot complete before that arrival). With
  // no mask_tma every thread copies its share of the mask columns by
  // cp.async instead. One cp.async group a chunk either way. Stage s's fills
  // complete its mbarrier's phases in turn: bit s of `parity` is the parity
  // of its next fill, of `pending` whether a fill is unwaited. Every thread
  // keeps the two alike.
  if (tid == 32) {
    prefetch_map(&a.tk);
    prefetch_map(&a.tv);
    if (kQ8) {
      prefetch_map(&a.tks);
      prefetch_map(&a.tvs);
    }
    if (a.mask_tma) prefetch_map(&a.tm);
    for (int i = 0; i < kMaxStages; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  uint32_t parity = 0, pending = 0;
  auto issue = [&](int c, bool kv, int nf, int nl) {
    const int sidx = c % a.stages;
    uint8_t* st = ring + (size_t)sidx * stb;
    constexpr int nbox = Sh::RB / kBox, xb = kBox / Sh::EB, nkv = 2 * nbox + (kQ8 ? 2 : 0);
    const int nops = (kv ? nkv : 0) + a.mask_tma;
    if (nops > 0) {
      if (lane == 0) {
        uint64_t* bar = bars + sidx;
        const int y = lo + c * kChunk;
        if (w == 0) mbar_expect(bar, (kv ? Sh::KV : 0) + a.mask_tma * a.mslots * kChunk * 4);
        for (int o = w; o < nops; o += kWarps) {
          if (!kv || o == nkv)
            tma_load(st + Sh::KV, &a.tm, y, nf, bar);
          else if (o < 2 * nbox)
            tma_load(st + o * Sh::BOX, o < nbox ? &a.tk : &a.tv, hk * kD + (o % nbox) * xb, y, bar);
          else
            tma_load(st + 2 * nbox * Sh::BOX + (o - 2 * nbox) * kChunk * Sh::NSC * 4,
                     o == 2 * nbox ? &a.tks : &a.tvs, hk * Sh::NSC, y, bar);
        }
      }
      pending |= 1u << sidx;
    }
    if (!a.mask_tma) {
      float* mst = reinterpret_cast<float*>(st + Sh::KV);
      const int t0 = c * kChunk;
      for (int e = tid; e < a.mslots * kChunk; e += kThreads) {
        const int sl = e / kChunk, i = e % kChunk;
        const bool ok = nf + sl <= nl && t0 + i < nk;
        cp4z(mst + e, ok ? a.mask + (size_t)(nf + sl) * a.T + lo + t0 + i : a.mask, ok);
      }
    }
    cp_commit();
  };

  for (int r0 = 0; r0 < R; r0 += kTile) {
    const int nr = min(kTile, R - r0);
    const int nf = r0 / g_rep, nl = (r0 + nr - 1) / g_rep;
    if (r0 > 0) __syncthreads();  // the previous pass is done with the ring, Q and P
    // The pass's queries first, while the memory system is quiet (16-byte
    // loads, all before the first store: a shared-memory store may alias a
    // later load, which then waits for it); then the stages (the ring's K/V
    // on the first pass or every pass where the slice does not stay)
    const int pro = min(nch, a.stages);
    constexpr int kQ4 = kTile * kD / 4 / kThreads;  // 16-byte query loads a thread
    float4 qv[kQ4];
#pragma unroll
    for (int i = 0; i < kQ4; ++i) {
      const int e = tid + i * kThreads, r = e / (kD / 4), rr = r0 + r;
      qv[i] = r < nr ? *reinterpret_cast<const float4*>(
                           a.q + ((size_t)(rr / g_rep) * a.Hq + hk * g_rep + rr % g_rep) * kD +
                           e % (kD / 4) * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (r0 == 0) __syncthreads();  // the mbarriers are initialized
    for (int c = 0; c < pro; ++c) issue(c, r0 == 0 || !resident, nf, nl);
    // the pass's queries to shared memory, bf16, zero past the last row
#pragma unroll
    for (int i = 0; i < kQ4; ++i) {
      const int e = tid + i * kThreads, r = e / (kD / 4), d = e % (kD / 4) * 4;
      const float x[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<__nv_bfloat16*>(qt + q_at<kD, kQ8>(r, d + j)) = __float2bfloat16_rn(x[j]);
    }
    // this lane's rows g and g + 8: their mask slot
    int slot[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      slot[h] = r < nr ? (r0 + r) / g_rep - nf : 0;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[Sh::NT][4];
#pragma unroll
    for (int i = 0; i < Sh::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    for (int c = 0; c < nch; ++c) {
      const int sidx = c % a.stages;
      const uint8_t* st = ring + (size_t)sidx * stb;
      const uint8_t* kst = st;
      const uint8_t* vst = st + (Sh::RB / kBox) * Sh::BOX;
      const float* kss = reinterpret_cast<const float*>(st + 2 * (Sh::RB / kBox) * Sh::BOX);
      const float* vss = kss + kChunk * Sh::NSC;
      const float* mst = reinterpret_cast<const float*>(st + Sh::KV);
      if (pending >> sidx & 1) {
        mbar_wait(bars + sidx, parity >> sidx & 1);
        parity ^= 1u << sidx;
        pending &= ~(1u << sidx);
      }
      cp_wait(min(a.stages - 1, nch - 1 - c));
      __syncthreads();  // the stage's copies and (first chunk) the queries

      // S = Q K^T for the warp's 8 keys, two chains of k-steps. Lane g
      // loads key 8w + kperm(g), kperm = 0, 4, 1, 5, 2, 6, 3, 7, so that the
      // two keys of an 8-lane phase sit in the two halves of the swizzle's
      // 128 bytes; column n of the result is key 8w + kperm(n).
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const int key = 8 * w + (g >> 1) + 4 * (g & 1);
#pragma unroll
      for (int j = 0; j < kD / (4 * Sh::VPT); ++j) {
        const uint4 u = *reinterpret_cast<const uint4*>(kst + box_at(key, 4 * j + c4));
        uint32_t b[2 * Sh::KPG];
        if constexpr (kQ8) {
          const float s = kss[key * Sh::NSC + 2 * j + c4 / 2];
          q8x4(u.x, s, b[0], b[1]);
          q8x4(u.y, s, b[2], b[3]);
          q8x4(u.z, s, b[4], b[5]);
          q8x4(u.w, s, b[6], b[7]);
        } else {
          b[0] = u.x;
          b[1] = u.y;
          b[2] = u.z;
          b[3] = u.w;
        }
#pragma unroll
        for (int s2 = 0; s2 < Sh::KPG; ++s2) {
          const int kk = j * Sh::KPG + s2;
          uint32_t qa[4];
          ldsm_x4(qa, qt + ((lane >> 3) & 1) * 8 * kD * 2 + (lane & 7) * kD * 2 +
                          (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
          mma_bf16(s2 & 1 ? s1 : s0, qa, b[2 * s2], b[2 * s2 + 1]);
        }
      }
      // scores of (row g, columns 2c4, 2c4 + 1: keys 8w + c4, 8w + c4 + 4)
      // and (row g + 8, the same)
      float sc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, kc = 8 * w + c4 + 4 * (i & 1), t = c * kChunk + kc;
        const float v = fmaxf((s0[i] + s1[i]) * a.scale + mst[slot[h] * kChunk + kc], kNeg);
        sc[i] = t < nk ? v : -INFINITY;  // past the slice: no part
      }
      float mx[2] = {fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])};
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], o));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], o));
      }
      if (c4 == 0) {
        red_m[w * kTile + g] = mx[0];
        red_m[w * kTile + g + 8] = mx[1];
      }
      __syncthreads();

      // the chunk's max over the warps, the running max, p against it
      float al[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mc = red_m[g + 8 * h];
        for (int i = 1; i < kWarps; ++i) mc = fmaxf(mc, red_m[i * kTile + g + 8 * h]);
        const float mn = fmaxf(m[h], mc);
        al[h] = expf(m[h] - mn);
        m[h] = mn;
      }
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = expf(sc[i] - m[i >> 1]);
      l[0] = l[0] * al[0] + (p[0] + p[1]);
      l[1] = l[1] * al[1] + (p[2] + p[3]);
      // P row r's 16-byte piece j (keys 8j..8j+7) at j ^ (r & 7)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i >> 1);
        *reinterpret_cast<__nv_bfloat16*>(pt + r * 128 + ((w ^ (r & 7)) << 4) +
                                          (c4 + 4 * (i & 1)) * 2) = __float2bfloat16_rn(p[i]);
      }
#pragma unroll
      for (int i = 0; i < Sh::NT; ++i) {
        acc[i][0] *= al[0];
        acc[i][1] *= al[0];
        acc[i][2] *= al[1];
        acc[i][3] *= al[1];
      }
      __syncthreads();

      // P V for the warp's columns [w D/8, (w+1) D/8): A from P; B from V,
      // bf16 by ldmatrix.trans (n-tile i column n: d = w D/8 + 8 i + n),
      // q8_0 from the ring's bytes (n-tile i column n: d = w D/8 + NT n + i,
      // so a lane's NT bytes of a key feed its column of every n-tile)
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t pa[4];
        const int prow = (mi & 1) * 8 + rr;
        ldsm_x4(pa, pt + prow * 128 + (((2 * ks + (mi >> 1)) ^ rr) * 16));
        if constexpr (kQ8) {
          const int col = w * (kD / 8) + Sh::NT * g;  // the lane's first column
          uint32_t u[4];
          float sv[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int vk = 16 * ks + 2 * c4 + (h & 1) + (h >> 1) * 8;
            const uint8_t* pv = vst + box_at(vk, col >> 4) + (col & 15);
            u[h] = Sh::NT == 4 ? *reinterpret_cast<const uint32_t*>(pv)
                               : *reinterpret_cast<const uint16_t*>(pv);
            u[h] ^= 0x80808080u;
            sv[h] = vss[vk * Sh::NSC + col / 32];
          }
#pragma unroll
          for (int i = 0; i < Sh::NT; ++i) {
            float x[4];
#pragma unroll
            for (int h = 0; h < 4; ++h)
              x[h] = (__uint_as_float(__byte_perm(u[h], 0x4B000000u, 0x7650 + i)) - 8388736.f) * sv[h];
            const __nv_bfloat162 b0 = __floats2bfloat162_rn(x[0], x[1]);
            const __nv_bfloat162 b1 = __floats2bfloat162_rn(x[2], x[3]);
            mma_bf16(acc[i], pa, *reinterpret_cast<const uint32_t*>(&b0),
                     *reinterpret_cast<const uint32_t*>(&b1));
          }
        } else {
          const int vk = 16 * ks + (mi & 1) * 8 + rr;
#pragma unroll
          for (int np = 0; np < Sh::NT / 2; ++np) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vst + box_at(vk, w * (kD / 64) + 2 * np + (mi >> 1)));
            mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
            mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
          }
        }
      }
      if (c + a.stages < nch) {  // refill this stage once every warp is done with it
        __syncthreads();
        issue(c + a.stages, true, nf, nl);
      }
    }

    // the rank's l for each row (the lane quad's, then the warps' in order)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
    }
    if (c4 == 0) {
      red_l[w * kTile + g] = l[0];
      red_l[w * kTile + g + 8] = l[1];
      if (w == 0) {
        mrun[g] = m[0];
        mrun[g + 8] = m[1];
      }
    }
    __syncthreads();
    // every rank has started (first pass) or has read its inbox (later ones)
    if (S > 1) cluster_wait();

    // acc of output dimension d into the rank that writes d: rank r writes
    // [r D / S, (r + 1) D / S). Accumulator element j of n-tile i holds row
    // g + 8 (j >> 1), column n = 2 c4 + (j & 1): d = w D/8 + 8 i + n (bf16),
    // w D/8 + NT n + i (q8_0). Where S divides D into multiples of 4, the
    // stores go out as vectors of consecutive d: (j, j + 1) for bf16, the
    // NT n-tiles for q8_0.
    if (kD % (4 * S) == 0) {
      const int span = kD / S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = g + 8 * (j >> 1), n = 2 * c4 + (j & 1);
        if (row >= nr) continue;
        if constexpr (kQ8) {
          const int d = w * (kD / 8) + Sh::NT * n, r = d / span;
          float* dst = (S > 1 ? cluster.map_shared_rank(inacc, r) : inacc) +
                       (rank * nrow + row) * ndm + d - r * span;
          if constexpr (Sh::NT == 4)
            *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          else
            *reinterpret_cast<float2*>(dst) = make_float2(acc[0][j], acc[1][j]);
        } else {
          if (j & 1) continue;
#pragma unroll
          for (int i = 0; i < Sh::NT; ++i) {
            const int d = w * (kD / 8) + 8 * i + n, r = d / span;
            float* dst = (S > 1 ? cluster.map_shared_rank(inacc, r) : inacc) +
                         (rank * nrow + row) * ndm + d - r * span;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j], acc[i][j + 1]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < Sh::NT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = g + 8 * (j >> 1), n = 2 * c4 + (j & 1);
          const int d = w * (kD / 8) + (kQ8 ? Sh::NT * n + i : 8 * i + n);
          if (row >= nr) continue;
          const int r = ((d + 1) * S + kD - 1) / kD - 1;
          float* dst = S > 1 ? cluster.map_shared_rank(inacc, r) : inacc;
          dst[(rank * nrow + row) * ndm + d - r * kD / S] = acc[i][j];
        }
      }
    }
    if (tid < S * kTile && tid % kTile < nr) {
      const int r = tid / kTile, row = tid % kTile;
      float ls = 0.f;
      for (int i = 0; i < kWarps; ++i) ls += red_l[i * kTile + row];
      (S > 1 ? cluster.map_shared_rank(inm, r) : inm)[rank * kTile + row] = mrun[row];
      (S > 1 ? cluster.map_shared_rank(inl, r) : inl)[rank * kTile + row] = ls;
    }
    if (S > 1)
      cluster.sync();
    else
      __syncthreads();

    // this rank's output dimensions: the ranks merged in rank order
    const int d0 = rank * kD / S, nd = (rank + 1) * kD / S - d0;
    for (int row = w; row < nr; row += kWarps) {  // a warp a row, lane r: rank r
      const float mr = lane < S ? inm[lane * kTile + row] : -INFINITY;
      float M = mr;
#pragma unroll
      for (int o = 1; o < kMaxSplit; o <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
      const float e = lane < S ? expf(mr - M) : 0.f;
      float L = lane < S ? e * inl[lane * kTile + row] : 0.f;
#pragma unroll
      for (int o = 1; o < kMaxSplit; o <<= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
      if (lane < S) wr[row * kMaxSplit + lane] = e;
      if (lane == 0) rden[row] = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int e = tid; e < nr * nd; e += kThreads) {
      const int row = e / nd, dd = e % nd, rr = r0 + row;
      float A = 0.f;
      for (int r = 0; r < S; ++r) A += wr[row * kMaxSplit + r] * inacc[(r * nrow + row) * ndm + dd];
      const int n = rr / g_rep, h = hk * g_rep + rr % g_rep;
      a.out[((size_t)n * a.Hq + h) * kD + d0 + dd] = A / rden[row];
    }
    // the next pass's pushes wait for this rank to have read its inbox
    if (S > 1 && r0 + kTile < R) cluster_arrive();
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against the driver library)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major map of `base`, boxes of box_rows rows x box_cols;
// out of range reads as zeros
bool encode(CUtensorMap* m, const void* base, CUtensorMapDataType type, int esize, uint64_t cols,
            uint64_t rows, uint32_t box_cols, bool swizzle, uint32_t box_rows = kChunk) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, bool kQ8>
int launch(Args& a, cudaStream_t stream) {
  using Sh = Shape<kD, kQ8>;
  void (*kern)(Args) = cells_kernel<kD, kQ8>;
  const uint64_t rows = (uint64_t)a.T, cols = (uint64_t)a.Hkv * kD;
  const CUtensorMapDataType et = kQ8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&a.tk, a.k, et, Sh::EB, cols, rows, kBox / Sh::EB, true) ||
      !encode(&a.tv, a.v, et, Sh::EB, cols, rows, kBox / Sh::EB, true) ||
      (kQ8 && (!encode(&a.tks, a.ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cols / 32, rows,
                       Sh::NSC, false) ||
               !encode(&a.tvs, a.vs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cols / 32, rows,
                       Sh::NSC, false))))
    return (int)cudaErrorInvalidValue;
  if (a.mask_tma && !encode(&a.tm, a.mask, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.T, a.NB, kChunk,
                            false, a.mslots))
    return (int)cudaErrorInvalidValue;
  const int R = a.NB * (a.Hq / a.Hkv);
  const size_t fixed = 1024 + Sh::fixed(a.split, R < kTile ? R : kTile);
  const size_t stb = Sh::stage(a.mslots);
  const int nch = (a.chunk + kChunk - 1) / kChunk;
  const size_t budget = fixed + stb <= (size_t)kSmemBlock ? kSmemBlock : kSmemMax;
  if (fixed + stb > budget) return (int)cudaErrorInvalidValue;
  int stages = (int)((budget - fixed) / stb);
  stages = stages < nch ? stages : nch;
  a.stages = stages < kMaxStages ? stages : kMaxStages;
  const size_t smem = fixed + (size_t)a.stages * stb;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.split, a.Hkv, 1);
  if (a.split == 1) {
    kern<<<grid, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// q (NB, Hq, D) f32; k/v the layer's (1, T, Hkv*D) arena slice, bf16
// (ks = vs = null) or int8 with ks/vs (1, T, Hkv*D/32) f32; mask (NB, T)
// f32; out (NB, Hq, D) f32; split: the cluster's blocks (decode_plan).
// Requires D 128 or 256, Hq % Hkv == 0, 1 <= split <= 8, and q/k/v/ks/vs
// 16-byte aligned.
extern "C" int ggml_decode_attention_cells(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, const void* mask,
                                           void* out, int NB, int Hq, int Hkv, int D, int T,
                                           int split, float scale, void* stream) {
  const bool q8 = ks != nullptr;
  if ((D != 128 && D != 256) || NB <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || split < 1 ||
      split > kMaxSplit || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (q8 && (vs == nullptr || !aligned16(ks) || !aligned16(vs))))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.NB = NB;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.split = split;
  a.chunk = (T + split - 1) / split;
  a.stages = 0;
  a.mslots = NB < kTile ? NB : kTile;
  // a box's first key 16-byte aligned: every slice's and chunk's start a
  // multiple of 4 keys
  a.mask_tma = T % 4 == 0 && a.chunk % 4 == 0 && aligned16(mask);
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return q8 ? launch<128, true>(a, s) : launch<128, false>(a, s);
  return q8 ? launch<256, true>(a, s) : launch<256, false>(a, s);
}
