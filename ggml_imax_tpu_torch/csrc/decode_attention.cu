// Single-token (decode) attention over one layer of the flat KV arena.
//
// Replaces: ggml_imax_tpu/ops/decode_attention.py::_kernel (non-cells mode,
// reached through decode_attention_stacked).
//
// Computes, for each batch row b and query head h (kv head h / (Hq/Hkv)):
//   s[t] = max(dot(bf16(q), bf16(k[t])) * scale + mask[b, t], NEG)
//   p[t] = exp(s[t] - max(s))      l = sum(p)
//   out  = sum_t bf16(p[t]) * bf16(v[t]) / max(l, 1e-30)
// with NEG = -0.7 * FLT_MAX. For the q8_0 arena, k/v are int8 with one f32
// scale per 32 elements along D and are dequantized in f32 and rounded to
// bf16 before use, as the reference does. A row whose keys are all masked
// scores NEG on every key: p = 1 everywhere, the mean of V.
//
// Bound on the H100: bytes. The arena's K and V rows of one layer (2 bytes
// an element in bf16, 1 + 1/8 in q8_0) are read once; each element feeds
// g_rep <= 8 multiply-adds in the scores and as many in P V, 1-8 FMAs a
// byte, far under the ~295 bf16 FLOP a byte where the tensor cores would
// become the limit. So no tensor cores: the CUDA cores keep pace with the
// memory, and the design is about having enough bytes in flight. At GPT-J's
// decode shape (B 1, 16 heads of 256, T 512) that is 8.4 MB in bf16 (4.7
// MB in q8_0), 2.5 (1.4) us at 3.35 TB/s.
//
// Design: one launch a call, no workspace, no second pass.
// - Split-KV over a thread-block cluster. Grid (S, Hkv * groups, B), S
//   blocks a cluster along x; S comes from ops/decode_attention.py
//   decode_plan (at most 8, S * Hkv * B near the 132 SMs: 8 at GPT-J batch
//   1, 128 blocks of 64 keys). Block `rank` owns keys [rank ceil(T/S), ..)
//   of one kv head for up to 8 of its query heads (`groups` > 1 only past
//   8), so each K/V byte is read once a call. A rank that owns no key
//   contributes max -inf, l 0 and acc 0: exactly nothing.
// - Every load of the slice in flight before its first use. 16 bytes a
//   lane (8 bf16 or 16 int8 values: one warp instruction reads a 256-wide
//   bf16 row). Pass 1 issues kUnroll K rows a lane (all of a 64-key slice)
//   with their mask values, and each q8_0 row's scale once a lane (one per
//   16 values); then the slice's V rows and scales (up to kVBytes, the
//   rest read in pass 2) go to shared memory by cp.async, so they arrive
//   during the scores and the softmax. Warps take keys in both passes: the
//   lanes of a row add a score by shuffles; the slice's scores stay in
//   shared memory.
// - p rounded against the row's global max, as decode_attention_plain
//   rounds it: each rank writes its slice's max into every rank's shared
//   memory (distributed shared memory), and after cluster.sync each takes
//   M over the S maxima in its own and rounds p = bf16(exp(s - M)).
//   (decode_split.cuh rounds against each slice's max instead.)
// - Each rank writes its l into every rank, and its P V (warps summed in
//   warp order) for output dimension d into the rank that writes d: rank r
//   writes [r D / S, (r + 1) D / S). After a second cluster.sync each adds
//   what it holds in rank order and divides. Every sum has a fixed order:
//   the same bits on every launch. Ranks only write to one another, never
//   read, so nothing waits on a remote read and no rank waits to exit; the
//   cluster barrier's first arrival is made at the start, so the wait
//   before the first remote write (every rank must have started) is free.
// - q8_0 bytes become f32 by a byte permute and a subtraction (q8x4), not
//   by the conversion unit: with two conversions an element (int8 -> f32,
//   f32 -> bf16 one at a time) that quarter-rate unit made the q8_0 kernel
//   slower than the bf16 one on the H100, though it moves 44% fewer bytes.
#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;           // K rows a lane loads before its first product
constexpr int kMaxSplit = 8;         // a portable cluster's blocks (decode_plan's S)
constexpr int kMaxGroup = 8;         // query heads a block serves
constexpr int kMaxScores = 16384;    // floats of a slice's scores (_MAX_SCORES)
constexpr int kVBytes = 64 * 1024;   // shared memory for a slice's staged V rows
constexpr int kSmemMax = 227 * 1024;
constexpr float kNeg = -0.7f * FLT_MAX;

struct Args {
  const float* q;         // (B, Hq, D)
  const uint8_t *k, *v;   // the layer's (B, T, Hkv*D) arena slice, bf16 or int8
  const float *ks, *vs;   // (B, T, Hkv*D/32) f32 (q8_0), else null
  const float* mask;      // (B, T) f32 >= NEG
  float* out;             // (B, Hq, D)
  int Hq, Hkv, T, split, chunk, chunk4, vcap;
  float scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the two halves of a cluster barrier: an arrival that orders no memory,
// and the wait for every block's arrival
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the two bf16 values of a 32-bit word, as f32
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// the 4 int8 values of a 32-bit word times the scale s, rounded to bf16, as
// f32 in x. No conversion unit: each byte, its sign bit flipped, becomes
// the low byte of 2^23's mantissa (exactly 2^23 + 128 + v), less 2^23 + 128;
// the products are rounded to bf16 in pairs.
__device__ __forceinline__ void q8x4(uint32_t u, float s, float* x) {
  const uint32_t f = u ^ 0x80808080u;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (__uint_as_float(__byte_perm(f, 0x4B000000u, 0x7650 + j)) - 8388736.f) * s;
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(&p0);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(&p1);
  x[0] = bf_lo(w0);
  x[1] = bf_hi(w0);
  x[2] = bf_lo(w1);
  x[3] = bf_hi(w1);
}

template <int kD, bool kQ8, int kG>
struct Shape {
  static constexpr int EB = kQ8 ? 1 : 2;          // bytes an element
  static constexpr int RB = kD * EB;              // bytes of one head's row
  static constexpr int NSC = kD / 32;             // q8_0 scales of one head's row
  static constexpr int KV = 16 / EB;              // K values a lane (one 16-byte load)
  static constexpr int KL = kD / KV;              // lanes a K row
  static constexpr int KR = 32 / KL;              // K rows a warp instruction
  static constexpr int KB = kUnroll * kWarps * KR; // K rows a block's batch
  static constexpr int VL = kD / 8;               // lanes a V row in P V (8 values a lane)
  static constexpr int VR = 32 / VL;              // V rows a warp step
  static constexpr int VROW = RB + (kQ8 ? NSC * 4 : 0);  // staged bytes a V row
  // shared memory: the scores (kG x chunk4); the maxima and l the ranks
  // push here (kMaxSplit x kG each); the warps' partials (kWarps x kG);
  // the P V sums the ranks push for this rank's output dimensions (at most
  // kG x (kD + kMaxSplit)); then the staged V rows (and scales), reused
  // for the warps' P V partials
  __host__ __device__ static size_t floats(int chunk4) {
    return (size_t)kG * chunk4 + (2 * kMaxSplit + kWarps) * kG + kG * (kD + kMaxSplit);
  }
  __host__ __device__ static size_t stage(int vcap) {
    const size_t v = (size_t)vcap * VROW, red = (size_t)kWarps * kG * kD * 4;
    return v > red ? v : red;
  }
  __host__ __device__ static size_t bytes(int chunk4, int vcap) {
    return floats(chunk4) * 4 + stage(vcap);
  }
};

template <int kD, bool kQ8, int kG>
__global__ void __launch_bounds__(kThreads) decode_cluster_kernel(Args a) {
  using S = Shape<kD, kQ8, kG>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sc = reinterpret_cast<float*>(smem);    // kG x chunk4: scores, then bf16(p)
  float* inm = sc + kG * a.chunk4;               // kMaxSplit x kG: each rank's max
  float* inl = inm + kMaxSplit * kG;             // kMaxSplit x kG: each rank's l
  float* red = inl + kMaxSplit * kG;             // kWarps x kG: warp partials
  float* inp = red + kWarps * kG;                // split x kG x ndm: each rank's P V
  uint8_t* vst = smem + S::floats(a.chunk4) * 4; // vcap x RB staged V rows
  float* vss = reinterpret_cast<float*>(vst + (size_t)a.vcap * S::RB);  // vcap x NSC

  const int split = a.split, rank = blockIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  // every rank has started before any writes into its shared memory: the
  // arrival now, the wait once the scores are taken
  if (split > 1) cluster_arrive_relaxed();
  const int rep = a.Hq / a.Hkv, groups = (rep + kG - 1) / kG;
  const int hk = blockIdx.y / groups, g0 = blockIdx.y % groups * kG;
  const int ng = min(kG, rep - g0), h0 = hk * rep + g0;
  const int b = blockIdx.z;
  const int lo = min(rank * a.chunk, a.T), n = min(a.chunk, a.T - lo);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t row0 = (size_t)b * a.T + lo;           // arena row of key lo
  const size_t rs = (size_t)a.Hkv * S::RB;             // bytes between arena rows
  const size_t srs = (size_t)a.Hkv * S::NSC;           // scales between arena rows
  const uint8_t* kb = a.k + row0 * rs + (size_t)hk * S::RB;
  const uint8_t* vb = a.v + row0 * rs + (size_t)hk * S::RB;
  const float* ksb = kQ8 ? a.ks + row0 * srs + hk * S::NSC : nullptr;
  const float* vsb = kQ8 ? a.vs + row0 * srs + hk * S::NSC : nullptr;
  const float* mrow = a.mask + row0;
  const float* qrow = a.q + ((size_t)b * a.Hq + h0) * kD;

  // pass 1's loads: kUnroll K rows a lane, their mask values and scales
  const int kc = lane % S::KL, ksr = lane / S::KL;
  uint4 kr[kUnroll];
  float kss[kUnroll], mr[kUnroll];
  auto key = [&](int bt, int i) { return bt * S::KB + (i * kWarps + w) * S::KR + ksr; };
  auto load_k = [&](int bt) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = key(bt, i);
      kr[i] = make_uint4(0u, 0u, 0u, 0u);
      kss[i] = mr[i] = 0.f;
      if (t < n) {
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + t * rs) + kc);
        mr[i] = __ldg(mrow + t);
        if (kQ8) kss[i] = __ldg(ksb + t * srs + kc * S::KV / 32);
      }
    }
  };
  load_k(0);

  // the slice's V rows (and scales) to shared memory, in flight meanwhile
  const int nv = min(n, a.vcap);
  for (int e = tid; e < nv * (S::RB / 16); e += kThreads) {
    const int t = e / (S::RB / 16), c = e % (S::RB / 16);
    cp16(vst + (size_t)t * S::RB + c * 16, vb + t * rs + c * 16);
  }
  if (kQ8) {
    for (int e = tid; e < nv * (S::NSC / 4); e += kThreads) {
      const int t = e / (S::NSC / 4), c = e % (S::NSC / 4);
      cp16(vss + t * S::NSC + c * 4, vsb + t * srs + c * 4);
    }
  }
  cp_commit();

  // pass 1: scores of the slice's keys; each lane's share of q, bf16-rounded
  const int nbt = (n + S::KB - 1) / S::KB;
  for (int bt = 0; bt < nbt; ++bt) {
    if (bt > 0) load_k(bt);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= ng) break;
      float qv[S::KV];
#pragma unroll
      for (int j = 0; j < S::KV; ++j) qv[j] = round_bf16(__ldg(qrow + g * kD + kc * S::KV + j));
      float dot[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const uint32_t u[4] = {kr[i].x, kr[i].y, kr[i].z, kr[i].w};
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (kQ8) {
            float x[4];
            q8x4(u[c], kss[i], x);
#pragma unroll
            for (int j = 0; j < 4; ++j) s += qv[4 * c + j] * x[j];
          } else {
            s += qv[2 * c] * bf_lo(u[c]);
            s += qv[2 * c + 1] * bf_hi(u[c]);
          }
        }
        dot[i] = s;
      }
#pragma unroll
      for (int o = S::KL / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], o);
      }
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int t = key(bt, i);
          if (t < n) sc[g * a.chunk4 + t] = fmaxf(dot[i] * a.scale + mr[i], kNeg);
        }
      }
    }
  }
  __syncthreads();

  // the slice's max per query head, pushed into every rank's shared memory
  // (-inf from a rank without keys); the row's max M over the ranks
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float m = -INFINITY;
    if (g < ng)
      for (int t = tid; t < n; t += kThreads) m = fmaxf(m, sc[g * a.chunk4 + t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[w * kG + g] = m;
  }
  __syncthreads();
  if (split > 1) cluster_wait();
  if (tid < split * kG) {
    const int r = tid / kG, g = tid % kG;
    float m = red[g];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i * kG + g]);
    (split > 1 ? cluster.map_shared_rank(inm, r) : inm)[rank * kG + g] = m;
  }
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();

  // p = bf16(exp(s - M)) in place; this rank's l from the unrounded p,
  // pushed as the maxima were
  float ls[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    ls[g] = 0.f;
    if (g < ng) {
      float m = inm[g];
      for (int r = 1; r < split; ++r) m = fmaxf(m, inm[r * kG + g]);
      for (int t = tid; t < n; t += kThreads) {
        const float p = expf(sc[g * a.chunk4 + t] - m);
        ls[g] += p;
        sc[g * a.chunk4 + t] = round_bf16(p);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls[g] += __shfl_xor_sync(0xffffffffu, ls[g], o);
    if (lane == 0) red[w * kG + g] = ls[g];
  }
  cp_wait_all();
  __syncthreads();
  if (tid < split * kG) {
    const int r = tid / kG, g = tid % kG;
    float l = 0.f;
    for (int i = 0; i < kWarps; ++i) l += red[i * kG + g];
    (split > 1 ? cluster.map_shared_rank(inl, r) : inl)[rank * kG + g] = l;
  }

  // pass 2: P V, warps take keys; 8 values of a row a lane
  const int vc = lane % S::VL, vsr = lane / S::VL;
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }
  auto add = [&](const uint8_t* vrow, const float* vsrow, int t) {
    float x[8];
    if (kQ8) {
      const uint2 u = *reinterpret_cast<const uint2*>(vrow + vc * 8);
      const float s = vsrow[vc / 4];
      q8x4(u.x, s, x);
      q8x4(u.y, s, x + 4);
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(vrow + vc * 16);
      const uint32_t uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[2 * c] = bf_lo(uu[c]);
        x[2 * c + 1] = bf_hi(uu[c]);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= ng) break;
      const float p = sc[g * a.chunk4 + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += p * x[j];
    }
  };
  constexpr int step = kWarps * S::VR;
  int t = w * S::VR + vsr;
#pragma unroll 4
  for (; t < nv; t += step) add(vst + (size_t)t * S::RB, vss + t * S::NSC, t);
  // the rows past the staged ones, from device memory
#pragma unroll 4
  for (; t < n; t += step) add(vb + t * rs, kQ8 ? vsb + t * srs : nullptr, t);
#pragma unroll
  for (int o = S::VL; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
    }
  }
  __syncthreads();   // the staged rows are read: their room takes the warps' sums
  float* wp = reinterpret_cast<float*>(vst);   // kWarps x kG x kD
  if (vsr == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* dst = wp + ((size_t)w * kG + g) * kD + vc * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();

  // this rank's P V, summed over the warps in warp order, pushed to the rank
  // that writes each output dimension d: rank r writes [r D / S, (r + 1) D / S)
  const int ndm = (kD + split - 1) / split;
  for (int e = tid; e < kG * kD; e += kThreads) {
    float s = wp[e];
    for (int i = 1; i < kWarps; ++i) s += wp[(size_t)i * kG * kD + e];
    const int g = e / kD, d = e % kD;
    const int r = ((d + 1) * split + kD - 1) / kD - 1;
    float* dst = split > 1 ? cluster.map_shared_rank(inp, r) : inp;
    dst[(rank * kG + g) * ndm + d - r * kD / split] = s;
  }
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();

  // this rank's dimensions, the ranks' sums added in rank order; no rank
  // reads another's shared memory past the barrier, so none waits to exit
  const int d0 = rank * kD / split, nd = (rank + 1) * kD / split - d0;
  for (int e = tid; e < ng * nd; e += kThreads) {
    const int g = e / nd, dd = e % nd;
    float o = 0.f, l = 0.f;
    for (int r = 0; r < split; ++r) {
      o += inp[(r * kG + g) * ndm + dd];
      l += inl[r * kG + g];
    }
    a.out[((size_t)b * a.Hq + h0 + g) * kD + d0 + dd] = o / fmaxf(l, 1e-30f);
  }
}

template <int kD, bool kQ8, int kG>
int launch(const Args& a, int B, int groups, cudaStream_t stream) {
  using S = Shape<kD, kQ8, kG>;
  void (*kern)(Args) = decode_cluster_kernel<kD, kQ8, kG>;
  Args c = a;
  c.vcap = a.chunk < kVBytes / S::VROW ? a.chunk : kVBytes / S::VROW;
  const size_t smem = S::bytes(a.chunk4, c.vcap);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.split, a.Hkv * groups, B);
  if (a.split == 1) {
    kern<<<grid, kThreads, smem, stream>>>(c);
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
  err = cudaLaunchKernelEx(&cfg, kern, c);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int kD, bool kQ8>
int launch_g(const Args& a, int B, int rep, cudaStream_t stream) {
  const int groups = (rep + kMaxGroup - 1) / kMaxGroup;
  if (rep == 1) return launch<kD, kQ8, 1>(a, B, groups, stream);
  if (rep == 2) return launch<kD, kQ8, 2>(a, B, groups, stream);
  if (rep <= 4) return launch<kD, kQ8, 4>(a, B, groups, stream);
  return launch<kD, kQ8, 8>(a, B, groups, stream);
}

template <int kD>
int launch_d(const Args& a, int B, int rep, bool q8, cudaStream_t stream) {
  return q8 ? launch_g<kD, true>(a, B, rep, stream) : launch_g<kD, false>(a, B, rep, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// q (B, Hq, D) f32; k/v: the layer's (B, T, Hkv*D) slice of the arena, bf16
// (ks = vs = null) or int8 with ks/vs (B, T, Hkv*D/32) f32; mask (B, T) f32
// >= NEG; out (B, Hq, D) f32; split: the cluster's blocks (decode_plan).
// Requires D 128 or 256, Hq % Hkv == 0, 1 <= split <= 8, k/v/ks/vs 16-byte
// aligned, and ceil(T / split) * min(pow2 >= Hq/Hkv, 8) <= 16384.
extern "C" int ggml_decode_attention(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, const void* mask,
                                     void* out, int B, int Hq, int Hkv, int D, int T, int split,
                                     float scale, void* stream) {
  const bool q8 = ks != nullptr;
  if ((D != 128 && D != 256) || B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 || split < 1 ||
      split > kMaxSplit || !aligned16(k) || !aligned16(v) ||
      (q8 && (vs == nullptr || !aligned16(ks) || !aligned16(vs))))
    return (int)cudaErrorInvalidValue;
  const int rep = Hq / Hkv, g = rep == 1 ? 1 : rep == 2 ? 2 : rep <= 4 ? 4 : kMaxGroup;
  Args a;
  a.q = (const float*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)v;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.mask = (const float*)mask;
  a.out = (float*)out;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.split = split;
  a.chunk = (T + split - 1) / split;
  a.chunk4 = (a.chunk + 3) / 4 * 4;
  a.vcap = 0;
  a.scale = scale;
  if ((long)a.chunk * g > kMaxScores) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_d<128>(a, B, rep, q8, s) : launch_d<256>(a, B, rep, q8, s);
}
