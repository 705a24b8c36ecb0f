// Flash-attention backward: the dQ kernel and the dK/dV kernel.
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
// Bound on the H100: at GPT-2 117M training (B 8, T 512, 12 heads, D 64) the
// dQ kernel does 6*B*H*T^2*D flops (9.7 GFLOP, ~10 us at 989 TFLOP/s) and
// dK/dV 8*B*H*T^2*D, over ~50 MB of q/k/v/dO/mask/outputs (~15 us at
// 3.35 TB/s): both near the ridge, so tile and launch latency dominate.
//
// Design, as the forward: blocks of 8 warps, nvcuda::wmma bf16 products
// with f32 accumulation, 16-byte tile loads, one query tile (dQ) or key tile
// (dK/dV) per block, every sum taken by one block in a fixed order (no
// atomics, deterministic). Each product's 16x16 output tiles are dealt to
// the warps in turn; scores, dP and the accumulators live in shared memory.
// The dK/dV block walks the query tiles of every q head of its GQA group,
// so the group sum happens in the block. Shared memory grows with D: at
// D > 128 the key tile is 32 rows (dQ: ~190 KB; dK/dV: ~196 KB), above the
// 48 KB default, so each launch raises the limit with cudaFuncSetAttribute
// and its return code is checked.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNeg = -0.7f * FLT_MAX;
typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// rows [r0, r0 + n) of a (T, rowstride) bf16 matrix -> tile (zero past T)
__device__ void load_rows(bf16* dst, int ld, const bf16* src, size_t rowstride, int r0,
                          int n, int T, int D) {
  const int chunks = D / 8;
  for (int c = threadIdx.x; c < n * chunks; c += kThreads) {
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
  for (int t = warp; t < (M / 16) * tn; t += kWarps) {
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

struct Args {
  const bf16 *q, *k, *v, *dout;      // (B, Tq, Hq, D), (B, Tk, Hkv, D) x2, (B, Tq, Hq, D)
  const float *lse, *di;             // (B, Hq, Tq)
  const float *mask, *slopes;        // (B, Tq, Tk) >= NEG or null; (Hq) or null
  float *dq, *dk, *dv;               // (B, Tq, Hq, D); (B, Tk, Hkv, D) x2
  int Tq, Tk, Hq, Hkv, D;
  float scale, softcap;
};

// The shared tile math of both kernels: from S = Q K^T (Ss) and dP = dO V^T
// (dPs) of query rows [q0, q0 + BQ) and keys [k0, k0 + BK), write bf16(ds) to
// dSs and, if Ps is given, bf16(p) to Ps. Invalid rows and keys give 0.
template <int BQ, int BK>
__device__ void p_ds(const Args& a, int b, int h, int q0, int k0, const float* Ss,
                     const float* dPs, const float* lse_s, const float* di_s, bf16* dSs,
                     bf16* Ps) {
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 1.f;
  for (int e = threadIdx.x; e < BQ * BK; e += kThreads) {
    const int r = e / BK, c = e % BK, qi = q0 + r, kj = k0 + c;
    float p = 0.f, ds = 0.f;
    if (qi < a.Tq && kj < a.Tk) {
      const float s = Ss[r * LDS + c] * a.scale;
      float t = 0.f, se = s;
      if (a.softcap > 0.f) {
        t = tanhf(s / a.softcap);
        se = a.softcap * t;
      }
      const float mb = a.mask != nullptr ? a.mask[((size_t)b * a.Tq + qi) * a.Tk + kj] : 0.f;
      se = fmaxf(se + mb * slope, kNeg);
      p = expf(se - lse_s[r]);
      ds = p * (dPs[r * LDS + c] - di_s[r]);
      if (a.softcap > 0.f) ds *= 1.f - t * t;
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
struct DqLayout {
  size_t q, dout, k, v, s, dp, ds, acc, total;
  __host__ __device__ explicit DqLayout(int D) {
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

// grid (ceil(Tq / BQ), Hq, B): dQ of query rows [q0, q0 + BQ) of head h.
template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, lda = D + 4;
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const DqLayout<BQ, BK> L(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* dPs = reinterpret_cast<float*>(smem + L.dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __shared__ float lse_s[BQ], di_s[BQ];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;

  load_rows(Qs, ld, a.q + qbase, qstride, q0, BQ, a.Tq, D);
  load_rows(dOs, ld, a.dout + qbase, qstride, q0, BQ, a.Tq, D);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qi = q0 + r;
    const size_t row = ((size_t)b * a.Hq + h) * a.Tq + qi;
    lse_s[r] = qi < a.Tq ? a.lse[row] : 0.f;
    di_s[r] = qi < a.Tq ? a.di[row] : 0.f;
  }
  for (int e = threadIdx.x; e < BQ * lda; e += kThreads) acc[e] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();   // the previous tile fully consumed
    load_rows(Ks, ld, a.k + kbase, kstride, k0, BK, a.Tk, D);
    load_rows(Vs, ld, a.v + kbase, kstride, k0, BK, a.Tk, D);
    __syncthreads();
    warp_gemm<wmma::row_major, wmma::col_major>(Ss, LDS, Qs, ld, Ks, ld, BQ, BK, D, false);
    warp_gemm<wmma::row_major, wmma::col_major>(dPs, LDS, dOs, ld, Vs, ld, BQ, BK, D, false);
    __syncthreads();
    p_ds<BQ, BK>(a, b, h, q0, k0, Ss, dPs, lse_s, di_s, dSs, nullptr);
    __syncthreads();
    warp_gemm<wmma::row_major, wmma::row_major>(acc, lda, dSs, LDB, Ks, ld, BQ, D, BK, true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    if (qi < a.Tq) a.dq[((size_t)b * a.Tq + qi) * qstride + (size_t)h * D + d] = acc[r * lda + d] * a.scale;
  }
}

template <int BQ, int BK>
struct DkvLayout {
  size_t k, v, q, dout, s, dp, p, ds, dk, dv, total;
  __host__ __device__ explicit DkvLayout(int D) {
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

// grid (ceil(Tk / BK), Hkv, B): dK and dV of keys [k0, k0 + BK) of kv head
// hk, summed over the query tiles of every q head of its group.
template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, ld = D + 8, lda = D + 4;
  constexpr int LDS = BK + 4, LDB = BK + 8;
  const DkvLayout<BQ, BK> L(D);
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

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.Hq / a.Hkv;
  const size_t qstride = (size_t)a.Hq * D, kstride = (size_t)a.Hkv * D;
  const size_t kbase = (size_t)b * a.Tk * kstride + (size_t)hk * D;

  load_rows(Ks, ld, a.k + kbase, kstride, k0, BK, a.Tk, D);
  load_rows(Vs, ld, a.v + kbase, kstride, k0, BK, a.Tk, D);
  for (int e = threadIdx.x; e < BK * lda; e += kThreads) dKs[e] = dVs[e] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const size_t qbase = (size_t)b * a.Tq * qstride + (size_t)h * D;
    for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
      __syncthreads();   // the previous query tile fully consumed
      load_rows(Qs, ld, a.q + qbase, qstride, q0, BQ, a.Tq, D);
      load_rows(dOs, ld, a.dout + qbase, qstride, q0, BQ, a.Tq, D);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int qi = q0 + r;
        const size_t row = ((size_t)b * a.Hq + h) * a.Tq + qi;
        lse_s[r] = qi < a.Tq ? a.lse[row] : 0.f;
        di_s[r] = qi < a.Tq ? a.di[row] : 0.f;
      }
      __syncthreads();
      warp_gemm<wmma::row_major, wmma::col_major>(Ss, LDS, Qs, ld, Ks, ld, BQ, BK, D, false);
      warp_gemm<wmma::row_major, wmma::col_major>(dPs, LDS, dOs, ld, Vs, ld, BQ, BK, D, false);
      __syncthreads();
      p_ds<BQ, BK>(a, b, h, q0, k0, Ss, dPs, lse_s, di_s, dSs, Ps);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: P^T (BK x BQ) is P read column-major
      warp_gemm<wmma::col_major, wmma::row_major>(dVs, lda, Ps, LDB, dOs, ld, BK, D, BQ, true);
      warp_gemm<wmma::col_major, wmma::row_major>(dKs, lda, dSs, LDB, Qs, ld, BK, D, BQ, true);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BK * D; e += kThreads) {
    const int r = e / D, d = e % D, kj = k0 + r;
    if (kj < a.Tk) {
      const size_t o = ((size_t)b * a.Tk + kj) * kstride + (size_t)hk * D + d;
      a.dk[o] = dKs[r * lda + d] * a.scale;
      a.dv[o] = dVs[r * lda + d];
    }
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* mask, const void* slopes,
               void* dq, void* dk, void* dv, int Tq, int Tk, int Hq, int Hkv, int D,
               float scale, float softcap) {
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.di = (const float*)di;
  a.mask = (const float*)mask;
  a.slopes = (const float*)slopes;
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

template <int BQ, int BK>
int launch_dq(const Args& a, int B, cudaStream_t stream) {
  const DqLayout<BQ, BK> L(a.D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.Hq, B);
  flash_bwd_dq_kernel<BQ, BK><<<grid, kThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BQ, int BK>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  const DkvLayout<BQ, BK> L(a.D);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + BK - 1) / BK, a.Hkv, B);
  flash_bwd_dkv_kernel<BQ, BK><<<grid, kThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D) bf16; lse, di (B, Hq, Tq)
// f32; mask (B, Tq, Tk) f32 >= NEG or null; slopes (Hq) f32 or null; dq
// (B, Tq, Hq, D) f32. Requires D % 16 == 0, D <= 256 and Hq % Hkv == 0.
extern "C" int ggml_flash_backward_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      const void* mask, const void* slopes, void* dq, int B,
                                      int Tq, int Tk, int Hq, int Hkv, int D, float scale,
                                      float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, mask, slopes, dq, nullptr, nullptr, Tq, Tk,
                           Hq, Hkv, D, scale, softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D > 128 ? launch_dq<64, 32>(a, B, s) : launch_dq<64, 64>(a, B, s);
}

// The same inputs; dk, dv (B, Tk, Hkv, D) f32, summed over each GQA group.
extern "C" int ggml_flash_backward_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* di,
                                       const void* mask, const void* slopes, void* dk, void* dv,
                                       int B, int Tq, int Tk, int Hq, int Hkv, int D,
                                       float scale, float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, mask, slopes, nullptr, dk, dv, Tq, Tk, Hq,
                           Hkv, D, scale, softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D > 128 ? launch_dkv<64, 32>(a, B, s) : launch_dkv<64, 64>(a, B, s);
}
