// W8A8 decode GEMV over nat8 int8 weights.
//
// Replaces: ggml_imax_tpu/ops/pallas_qmm.py::_kernel_nat8_w8a8_stk (the
// per-layer GEMVs) and ::_kernel_nat8_w8a8 (one tensor) — one kernel here,
// since the port keeps per-layer weights as separate tensors.
//
// Computes out[n] = sum_b z[b,n] * (dx[b] * s[b,n])  (+ xs[b] * bias[b,n])
// with z[b,n] the int32 dot of the activation group x8[b, 0:g] and the
// weight rows q[b*g:(b+1)*g, n] (ggml's vec_dot_q8_0_q8_0 math), g = 32 or
// 16 (the per-16 formats). Scales and bias are f32 or bf16, read as f32.
//
// Bound on the H100: bytes. At m = 1 each weight byte feeds two int8
// multiply-adds, far below the ~590 ops/byte where the tensor cores would
// bind: the weight stream (K*N bytes + the scales) over 3.35 TB/s is the
// floor (3.4 us for GPT-2 XL's fc_w, 1600 x 6400).
//
// Design: (K, N) int8 keeps N contiguous. A thread owns 16 adjacent columns
// and reads them with one 16-byte load per k-row; four k-rows (a "quad")
// give four k-values of each column, which __byte_perm regroups into one
// int8x4 word per column for __dp4a against the quad's four activations.
// A block covers 32 columns (2 threads across) and splits K into 128
// contiguous, balanced slices of quads (one per thread pair), so any K that
// is a multiple of g runs with no padding (K = 1600 is 400 quads) and even
// N = 6400 launches 200 blocks for 132 SMs. A thread keeps each group's
// integer dot exact and applies the group's scale when it leaves the group;
// a group cut by a slice boundary is scaled in two parts (one more f32
// rounding than the reference). The bias term is spread over the slices by
// group. The 128 partial sums of each column are added in shared memory in
// a fixed order, so the result is deterministic. No split-K across blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                 // columns per thread
constexpr int kLanesN = 2;                // threads across a block's columns
constexpr int kBN = kCols * kLanesN;      // 32 columns per block
constexpr int kThreads = 256;
constexpr int kSlots = kThreads / kLanesN;   // 128 K-slices per block
constexpr int kChunks = kThreads / kBN;      // 8 partial-sum chunks per column

__device__ __forceinline__ float load_scale(const float* s, size_t i) { return s[i]; }
__device__ __forceinline__ float load_scale(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

// Four rows of 4 columns (one word per row, byte c = column c) -> four
// columns of 4 rows: col[c] byte r = row[r] byte c.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, int col[4]) {
  const uint32_t lo01 = __byte_perm(a0, a1, 0x5140);   // a0.0 a1.0 a0.1 a1.1
  const uint32_t lo23 = __byte_perm(a2, a3, 0x5140);
  const uint32_t hi01 = __byte_perm(a0, a1, 0x7362);   // a0.2 a1.2 a0.3 a1.3
  const uint32_t hi23 = __byte_perm(a2, a3, 0x7362);
  col[0] = (int)__byte_perm(lo01, lo23, 0x5410);
  col[1] = (int)__byte_perm(lo01, lo23, 0x7632);
  col[2] = (int)__byte_perm(hi01, hi23, 0x5410);
  col[3] = (int)__byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void dot_word(uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, int xv, int* z) {
  int col[4];
  transpose4(a0, a1, a2, a3, col);
#pragma unroll
  for (int c = 0; c < 4; ++c) z[c] = __dp4a(col[c], xv, z[c]);
}

template <typename ST>
__global__ void __launch_bounds__(kThreads)
nat8_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ dx,
                 const int8_t* __restrict__ q, const ST* __restrict__ s,
                 const ST* __restrict__ bias, const float* __restrict__ xs,
                 float* __restrict__ out, int K, int N, int g) {
  __shared__ float part[kSlots][kBN + 1];
  const int lane = threadIdx.x % kLanesN;
  const int slot = threadIdx.x / kLanesN;
  const int n0 = blockIdx.x * kBN + lane * kCols;
  const int nq = K / 4;                   // row quads
  const int qpg = g / 4;                  // quads per group
  const int r0 = (int)((long long)slot * nq / kSlots);
  const int r1 = (int)((long long)(slot + 1) * nq / kSlots);

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  if (n0 < N) {                           // N % 16 == 0: a thread is all in or out
    const int* xw = reinterpret_cast<const int*>(x8);
    int z[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) z[c] = 0;
    int grp = r0 / qpg;
    auto flush = [&](int b) {
      const float d = dx[b];
      const size_t base = (size_t)b * N + n0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[c] += (float)z[c] * (d * load_scale(s, base + c));
        z[c] = 0;
      }
    };
    for (int r = r0; r < r1; ++r) {
      if (r / qpg != grp) {
        flush(grp);
        grp = r / qpg;
      }
      const int8_t* qr = q + (size_t)(4 * r) * N + n0;
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(qr + (size_t)i * N));
      const int xv = __ldg(xw + r);
      dot_word(w[0].x, w[1].x, w[2].x, w[3].x, xv, z + 0);
      dot_word(w[0].y, w[1].y, w[2].y, w[3].y, xv, z + 4);
      dot_word(w[0].z, w[1].z, w[2].z, w[3].z, xv, z + 8);
      dot_word(w[0].w, w[1].w, w[2].w, w[3].w, xv, z + 12);
    }
    if (r0 < r1) flush(grp);
    if (bias != nullptr) {
      for (int b = slot; b < K / g; b += kSlots) {
        const float xb = xs[b];
        const size_t base = (size_t)b * N + n0;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += xb * load_scale(bias, base + c);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) part[slot][lane * kCols + c] = acc[c];
  __syncthreads();
  // thread t adds slots [chunk * 16, chunk * 16 + 16) of column t % 32
  const int col = threadIdx.x % kBN, chunk = threadIdx.x / kBN;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots / kChunks; ++i) sum += part[chunk * (kSlots / kChunks) + i][col];
  __syncthreads();
  part[chunk][col] = sum;
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int n = blockIdx.x * kBN + threadIdx.x;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) t += part[i][threadIdx.x];
    if (n < N) out[n] = t;
  }
}

}  // namespace

// x8 (K/g, g) int8, dx (K/g) f32, q (K, N) int8, scale/bias (K/g, N) f32 or
// bf16 (bias may be null), xs (K/g) f32, out (N) f32. Requires g in {16, 32},
// K % g == 0, N % 16 == 0, q 16-byte and x8 4-byte aligned.
extern "C" int ggml_nat8_gemv(const void* x8, const void* dx, const void* q,
                              const void* scale, const void* bias, const void* xs,
                              void* out, int K, int N, int g, int scale_is_bf16,
                              void* stream) {
  if ((g != 16 && g != 32) || K % g || N % 16 || (uintptr_t)q % 16 || (uintptr_t)x8 % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_is_bf16)
    nat8_gemv_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const int8_t*)x8, (const float*)dx, (const int8_t*)q,
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)bias, (const float*)xs,
        (float*)out, K, N, g);
  else
    nat8_gemv_kernel<float><<<grid, kThreads, 0, st>>>(
        (const int8_t*)x8, (const float*)dx, (const int8_t*)q, (const float*)scale,
        (const float*)bias, (const float*)xs, (float*)out, K, N, g);
  return (int)cudaGetLastError();
}
