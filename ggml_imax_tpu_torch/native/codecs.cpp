// The port's copy of ggml_imax_tpu/native/codecs.cpp (code unchanged).
//
// Native block-quantization codecs — the C++ equivalent of the reference's
// src/ggml-quants.c hot loops (quantize_row_* / dequantize_row_*,
// ggml's src/ggml-quants.c:260-1100 for the basic formats and the
// K-super-block unpack loops), used by the loader/saver on the host side.
// Bit-exact with the numpy codecs in ../quant/codecs.py, which are golden-
// tested against the compiled reference (tests/fixtures/golden_quant.npz).
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see native/__init__.py). Plain C ABI for
// ctypes. All entry points take block counts; rows are blocks*32 or *256.

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

#define API extern "C" __attribute__((visibility("default")))

// ---- fp16 <-> fp32 (IEEE, round-to-nearest-even) — ggml-impl.h:402-579 ----

static inline uint16_t f32_to_f16(float f) {
    uint32_t x; std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t  exp  = (int32_t)((x >> 23) & 0xff) - 127 + 15;
    uint32_t man  = x & 0x7fffffu;
    if (((x >> 23) & 0xff) == 0xff) {                 // inf/nan
        return (uint16_t)(sign | 0x7c00u | (man ? 0x200u | (man >> 13) : 0));
    }
    if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00u);   // overflow -> inf
    if (exp <= 0) {                                        // subnormal/zero
        if (exp < -10) return (uint16_t)sign;
        man |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t out   = man >> shift;
        uint32_t rem   = man & ((1u << shift) - 1);
        uint32_t half  = 1u << (shift - 1);
        if (rem > half || (rem == half && (out & 1))) out++;  // RNE
        return (uint16_t)(sign | out);
    }
    uint16_t out = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
    uint32_t rem = man & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (out & 1))) out++;
    return out;
}

static inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp  = (h >> 10) & 0x1f;
    uint32_t man  = h & 0x3ffu;
    uint32_t x;
    if (exp == 0) {
        if (man == 0) { x = sign; }
        else {
            exp = 127 - 15 + 1;
            while (!(man & 0x400u)) { man <<= 1; exp--; }
            man &= 0x3ffu;
            x = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 0x1f) {
        x = sign | 0x7f800000u | (man << 13);
    } else {
        x = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f; std::memcpy(&f, &x, 4);
    return f;
}

static inline int nearest_int(float f) {           // ggml nearest_int
    // round half to even via bit trick used by the reference
    float v = f + 12582912.0f;                      // 1.5 * 2^23
    int32_t i; std::memcpy(&i, &v, 4);
    return (i & 0x007fffff) - 0x00400000;
}

#define QK 32
#define QK_K 256

// ---------------- Q4_0 ----------------
API void q4_0_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 18;
        float amax = 0.0f, max = 0.0f;
        for (int j = 0; j < QK; ++j) {
            float v = xb[j];
            if (std::fabs(v) > amax) { amax = std::fabs(v); max = v; }
        }
        float d = max / -8.0f;
        float id = d ? 1.0f / d : 0.0f;
        uint16_t dh = f32_to_f16(d);
        std::memcpy(o, &dh, 2);
        for (int j = 0; j < QK / 2; ++j) {
            int lo = (int)(xb[j] * id + 8.5f);            // trunc == floor, v>=0.5
            int hi = (int)(xb[j + QK / 2] * id + 8.5f);
            if (lo > 15) lo = 15;
            if (hi > 15) hi = 15;
            o[2 + j] = (uint8_t)(lo | (hi << 4));
        }
    }
}

API void q4_0_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 18;
        uint16_t dh; std::memcpy(&dh, b, 2);
        float d = f16_to_f32(dh);
        float* o = y + i * QK;
        for (int j = 0; j < QK / 2; ++j) {
            o[j]          = ((int)(b[2 + j] & 0xF) - 8) * d;
            o[j + QK / 2] = ((int)(b[2 + j] >> 4)  - 8) * d;
        }
    }
}

// ---------------- Q4_1 ----------------
API void q4_1_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 20;
        float mn = xb[0], mx = xb[0];
        for (int j = 1; j < QK; ++j) {
            if (xb[j] < mn) mn = xb[j];
            if (xb[j] > mx) mx = xb[j];
        }
        float d = (mx - mn) / 15.0f;
        float id = d ? 1.0f / d : 0.0f;
        uint16_t dh = f32_to_f16(d), mh = f32_to_f16(mn);
        std::memcpy(o, &dh, 2);
        std::memcpy(o + 2, &mh, 2);
        for (int j = 0; j < QK / 2; ++j) {
            int lo = (int)((xb[j] - mn) * id + 0.5f);
            int hi = (int)((xb[j + QK / 2] - mn) * id + 0.5f);
            if (lo > 15) lo = 15;
            if (hi > 15) hi = 15;
            o[4 + j] = (uint8_t)(lo | (hi << 4));
        }
    }
}

API void q4_1_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 20;
        uint16_t dh, mh;
        std::memcpy(&dh, b, 2); std::memcpy(&mh, b + 2, 2);
        float d = f16_to_f32(dh), m = f16_to_f32(mh);
        float* o = y + i * QK;
        for (int j = 0; j < QK / 2; ++j) {
            o[j]          = (b[4 + j] & 0xF) * d + m;
            o[j + QK / 2] = (b[4 + j] >> 4)  * d + m;
        }
    }
}

// ---------------- Q5_0 / Q5_1 ----------------
static inline void pack_q5(const int* xi, uint8_t* qs, uint32_t* qh) {
    *qh = 0;
    for (int j = 0; j < QK / 2; ++j) {
        int lo = xi[j], hi = xi[j + QK / 2];
        qs[j] = (uint8_t)((lo & 0xF) | ((hi & 0xF) << 4));
        *qh |= ((uint32_t)((lo & 0x10) >> 4)) << j;
        *qh |= ((uint32_t)((hi & 0x10) >> 4)) << (j + QK / 2);
    }
}

API void q5_0_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 22;
        float amax = 0.0f, max = 0.0f;
        for (int j = 0; j < QK; ++j) {
            float v = xb[j];
            if (std::fabs(v) > amax) { amax = std::fabs(v); max = v; }
        }
        float d = max / -16.0f;
        float id = d ? 1.0f / d : 0.0f;
        uint16_t dh = f32_to_f16(d);
        std::memcpy(o, &dh, 2);
        int xi[QK];
        for (int j = 0; j < QK; ++j) {
            int v = (int)(xb[j] * id + 16.5f);
            xi[j] = v > 31 ? 31 : v;
        }
        uint32_t qh;
        pack_q5(xi, o + 6, &qh);
        std::memcpy(o + 2, &qh, 4);
    }
}

API void q5_0_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 22;
        uint16_t dh; std::memcpy(&dh, b, 2);
        uint32_t qh; std::memcpy(&qh, b + 2, 4);
        float d = f16_to_f32(dh);
        float* o = y + i * QK;
        for (int j = 0; j < QK / 2; ++j) {
            int xh0 = ((qh >> j) << 4) & 0x10;
            int xh1 = (qh >> (j + 12)) & 0x10;
            o[j]          = (((b[6 + j] & 0xF) | xh0) - 16) * d;
            o[j + QK / 2] = (((b[6 + j] >> 4)  | xh1) - 16) * d;
        }
    }
}

API void q5_1_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 24;
        float mn = xb[0], mx = xb[0];
        for (int j = 1; j < QK; ++j) {
            if (xb[j] < mn) mn = xb[j];
            if (xb[j] > mx) mx = xb[j];
        }
        float d = (mx - mn) / 31.0f;
        float id = d ? 1.0f / d : 0.0f;
        uint16_t dh = f32_to_f16(d), mh = f32_to_f16(mn);
        std::memcpy(o, &dh, 2);
        std::memcpy(o + 2, &mh, 2);
        int xi[QK];
        for (int j = 0; j < QK; ++j) {
            xi[j] = (int)((xb[j] - mn) * id + 0.5f);
        }
        uint32_t qh;
        pack_q5(xi, o + 8, &qh);
        std::memcpy(o + 4, &qh, 4);
    }
}

API void q5_1_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 24;
        uint16_t dh, mh;
        std::memcpy(&dh, b, 2); std::memcpy(&mh, b + 2, 2);
        uint32_t qh; std::memcpy(&qh, b + 4, 4);
        float d = f16_to_f32(dh), m = f16_to_f32(mh);
        float* o = y + i * QK;
        for (int j = 0; j < QK / 2; ++j) {
            int xh0 = ((qh >> j) << 4) & 0x10;
            int xh1 = (qh >> (j + 12)) & 0x10;
            o[j]          = ((b[8 + j] & 0xF) | xh0) * d + m;
            o[j + QK / 2] = ((b[8 + j] >> 4)  | xh1) * d + m;
        }
    }
}

// ---------------- Q8_0 / Q8_1 ----------------
API void q8_0_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 34;
        float amax = 0.0f;
        for (int j = 0; j < QK; ++j) {
            float v = std::fabs(xb[j]);
            if (v > amax) amax = v;
        }
        float d = amax / 127.0f;
        float id = d ? 1.0f / d : 0.0f;
        uint16_t dh = f32_to_f16(d);
        std::memcpy(o, &dh, 2);
        for (int j = 0; j < QK; ++j) {
            ((int8_t*)(o + 2))[j] = (int8_t)std::roundf(xb[j] * id);
        }
    }
}

API void q8_0_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 34;
        uint16_t dh; std::memcpy(&dh, b, 2);
        float d = f16_to_f32(dh);
        for (int j = 0; j < QK; ++j) {
            y[i * QK + j] = ((const int8_t*)(b + 2))[j] * d;
        }
    }
}

API void q8_1_quantize(const float* x, uint8_t* out, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK;
        uint8_t* o = out + i * 36;
        float amax = 0.0f;
        for (int j = 0; j < QK; ++j) {
            float v = std::fabs(xb[j]);
            if (v > amax) amax = v;
        }
        float d = amax / 127.0f;
        float id = d ? 1.0f / d : 0.0f;
        int sum = 0;
        int8_t* q = (int8_t*)(o + 4);
        for (int j = 0; j < QK; ++j) {
            q[j] = (int8_t)std::roundf(xb[j] * id);
            sum += q[j];
        }
        uint16_t dh = f32_to_f16(d);
        uint16_t sh = f32_to_f16(d * (float)sum);
        std::memcpy(o, &dh, 2);
        std::memcpy(o + 2, &sh, 2);
    }
}

API void q8_1_dequantize(const uint8_t* raw, float* y, int64_t nb) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * 36;
        uint16_t dh; std::memcpy(&dh, b, 2);
        float d = f16_to_f32(dh);
        for (int j = 0; j < QK; ++j) {
            y[i * QK + j] = ((const int8_t*)(b + 4))[j] * d;
        }
    }
}

// ---------------- K-quant dequantizers (super-blocks of 256) ----------------
// layouts: ggml-common.h:214-321; loops mirror dequantize_row_qX_K
// (ggml-quants.c) which our numpy codecs reproduce bit-exactly.

static inline void get_scale_min_k4(int j, const uint8_t* q,
                                    uint8_t* d, uint8_t* m) {
    if (j < 4) { *d = q[j] & 63; *m = q[j + 4] & 63; }
    else {
        *d = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        *m = (q[j + 4] >> 4)  | ((q[j - 0] >> 6) << 4);
    }
}

API void q2_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = 2 + 2 + QK_K / 16 + QK_K / 4;   // 84
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        const uint8_t* scales = b;
        const uint8_t* qs = b + QK_K / 16;
        uint16_t dh, mh;
        std::memcpy(&dh, b + QK_K / 16 + QK_K / 4, 2);
        std::memcpy(&mh, b + QK_K / 16 + QK_K / 4 + 2, 2);
        float d = f16_to_f32(dh), dmin = f16_to_f32(mh);
        float* o = y + i * QK_K;
        int is = 0;
        const uint8_t* q = qs;
        for (int n = 0; n < QK_K; n += 128) {
            int shift = 0;
            for (int j = 0; j < 4; ++j) {
                uint8_t sc = scales[is++];
                float dl = d * (sc & 0xF), ml = dmin * (sc >> 4);
                for (int l = 0; l < 16; ++l) *o++ = dl * ((q[l] >> shift) & 3) - ml;
                sc = scales[is++];
                dl = d * (sc & 0xF); ml = dmin * (sc >> 4);
                for (int l = 16; l < 32; ++l) *o++ = dl * ((q[l] >> shift) & 3) - ml;
                shift += 2;
            }
            q += 32;
        }
    }
}

API void q3_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = QK_K / 8 + QK_K / 4 + 12 + 2;   // 110
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        const uint8_t* hm = b;
        const uint8_t* qs = b + QK_K / 8;
        const uint8_t* sc = b + QK_K / 8 + QK_K / 4;
        uint16_t dh; std::memcpy(&dh, b + bs - 2, 2);
        float d_all = f16_to_f32(dh);
        // unpack 16 6-bit scales (ggml-quants.c dequantize_row_q3_K)
        int8_t scales[16];
        for (int j = 0; j < 16; ++j) {
            int lo = j < 8 ? (sc[j] & 0xF) : (sc[j - 8] >> 4);
            int hi = (sc[8 + (j % 4)] >> (2 * (j / 4))) & 3;
            scales[j] = (int8_t)((lo | (hi << 4)) - 32);
        }
        float* o = y + i * QK_K;
        uint8_t m = 1;
        int is = 0;
        const uint8_t* q = qs;
        for (int n = 0; n < QK_K; n += 128) {
            int shift = 0;
            for (int j = 0; j < 4; ++j) {
                float dl = d_all * scales[is++];
                for (int l = 0; l < 16; ++l)
                    *o++ = dl * (((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
                dl = d_all * scales[is++];
                for (int l = 16; l < 32; ++l)
                    *o++ = dl * (((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
                shift += 2;
                m <<= 1;
            }
            q += 32;
        }
    }
}

API void q4_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = 2 + 2 + 12 + QK_K / 2;          // 144
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        uint16_t dh, mh;
        std::memcpy(&dh, b, 2); std::memcpy(&mh, b + 2, 2);
        float d = f16_to_f32(dh), dmin = f16_to_f32(mh);
        const uint8_t* scales = b + 4;
        const uint8_t* q = b + 16;
        float* o = y + i * QK_K;
        int is = 0;
        for (int j = 0; j < QK_K; j += 64) {
            uint8_t sd, sm;
            get_scale_min_k4(is + 0, scales, &sd, &sm);
            float d1 = d * sd, m1 = dmin * sm;
            get_scale_min_k4(is + 1, scales, &sd, &sm);
            float d2 = d * sd, m2 = dmin * sm;
            for (int l = 0; l < 32; ++l) *o++ = d1 * (q[l] & 0xF) - m1;
            for (int l = 0; l < 32; ++l) *o++ = d2 * (q[l] >> 4)  - m2;
            q += 32;
            is += 2;
        }
    }
}

API void q5_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = 2 + 2 + 12 + QK_K / 8 + QK_K / 2;  // 176
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        uint16_t dh, mh;
        std::memcpy(&dh, b, 2); std::memcpy(&mh, b + 2, 2);
        float d = f16_to_f32(dh), dmin = f16_to_f32(mh);
        const uint8_t* scales = b + 4;
        const uint8_t* qh = b + 16;
        const uint8_t* ql = b + 16 + QK_K / 8;
        float* o = y + i * QK_K;
        int is = 0;
        uint8_t u1 = 1, u2 = 2;
        for (int j = 0; j < QK_K; j += 64) {
            uint8_t sd, sm;
            get_scale_min_k4(is + 0, scales, &sd, &sm);
            float d1 = d * sd, m1 = dmin * sm;
            get_scale_min_k4(is + 1, scales, &sd, &sm);
            float d2 = d * sd, m2 = dmin * sm;
            for (int l = 0; l < 32; ++l)
                *o++ = d1 * ((ql[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - m1;
            for (int l = 0; l < 32; ++l)
                *o++ = d2 * ((ql[l] >> 4)  + ((qh[l] & u2) ? 16 : 0)) - m2;
            ql += 32;
            is += 2;
            u1 <<= 2; u2 <<= 2;
        }
    }
}

API void q6_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = QK_K / 2 + QK_K / 4 + QK_K / 16 + 2;  // 210
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        const uint8_t* ql = b;
        const uint8_t* qh = b + QK_K / 2;
        const int8_t* sc = (const int8_t*)(b + QK_K / 2 + QK_K / 4);
        uint16_t dh; std::memcpy(&dh, b + bs - 2, 2);
        float d = f16_to_f32(dh);
        float* o = y + i * QK_K;
        for (int n = 0; n < QK_K; n += 128) {
            for (int l = 0; l < 32; ++l) {
                int is = l / 16;
                int8_t q1 = (int8_t)((ql[l +  0] & 0xF) | (((qh[l] >> 0) & 3) << 4)) - 32;
                int8_t q2 = (int8_t)((ql[l + 32] & 0xF) | (((qh[l] >> 2) & 3) << 4)) - 32;
                int8_t q3 = (int8_t)((ql[l +  0] >> 4)  | (((qh[l] >> 4) & 3) << 4)) - 32;
                int8_t q4 = (int8_t)((ql[l + 32] >> 4)  | (((qh[l] >> 6) & 3) << 4)) - 32;
                o[l +  0] = d * sc[is + 0] * q1;
                o[l + 32] = d * sc[is + 2] * q2;
                o[l + 64] = d * sc[is + 4] * q3;
                o[l + 96] = d * sc[is + 6] * q4;
            }
            o += 128;
            ql += 64;
            qh += 32;
            sc += 8;
        }
    }
}

API void q8_K_dequantize(const uint8_t* raw, float* y, int64_t nb) {
    const int bs = 4 + QK_K + QK_K / 16 * 2;       // 292
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const uint8_t* b = raw + i * bs;
        float d; std::memcpy(&d, b, 4);
        const int8_t* q = (const int8_t*)(b + 4);
        for (int j = 0; j < QK_K; ++j) y[i * QK_K + j] = q[j] * d;
    }
}

// fp16 row conversions (ggml-impl.h table path analog)
API void f16_row_to_f32(const uint16_t* x, float* y, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) y[i] = f16_to_f32(x[i]);
}

API void f32_row_to_f16(const float* x, uint16_t* y, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) y[i] = f32_to_f16(x[i]);
}

API int codecs_abi_version(void) { return 1; }

// ---------------- K-quant quantizers ----------------
// Scale-search semantics of ggml-quants.c (make_qx_quants:1104,
// make_qkx2_quants:1275, make_q3_quants:1173) and the per-format row
// quantizers; bit-exact with the numpy codecs (golden-tested vs reference).

static const float GROUP_MAX_EPS = 1e-30f;

static float make_qx_quants(int n, int nmax, const float* x, int8_t* L,
                            const float* qw) {   // rmse_type == 1
    float max = 0.0f, amax = 0.0f;
    for (int i = 0; i < n; ++i) {
        float ax = std::fabs(x[i]);
        if (ax > amax) { amax = ax; max = x[i]; }
    }
    if (amax < GROUP_MAX_EPS) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        return 0.0f;
    }
    float iscale = -nmax / max;
    float sumlx = 0.0f, suml2 = 0.0f;
    for (int i = 0; i < n; ++i) {
        int l = nearest_int(iscale * x[i]);
        l = l < -nmax ? -nmax : (l > nmax - 1 ? nmax - 1 : l);
        L[i] = (int8_t)l;
        float w = qw ? qw[i] : x[i] * x[i];
        sumlx += w * x[i] * l;
        suml2 += w * (float)l * l;
    }
    float scale = sumlx / suml2;
    float best = scale * sumlx;
    for (int is = -9; is <= 9; ++is) {
        if (is == 0) continue;
        float isc = -(nmax + 0.1f * is) / max;
        float slx = 0.0f, sl2 = 0.0f;
        for (int i = 0; i < n; ++i) {
            int l = nearest_int(isc * x[i]);
            l = l < -nmax ? -nmax : (l > nmax - 1 ? nmax - 1 : l);
            float w = qw ? qw[i] : x[i] * x[i];
            slx += w * x[i] * l;
            sl2 += w * (float)l * l;
        }
        if (sl2 > 0 && slx * slx > best * sl2) {
            for (int i = 0; i < n; ++i) {
                int l = nearest_int(isc * x[i]);
                L[i] = (int8_t)(l < -nmax ? -nmax : (l > nmax - 1 ? nmax - 1 : l));
            }
            scale = slx / sl2;
            best = scale * slx;
        }
    }
    for (int i = 0; i < n; ++i) L[i] = (int8_t)(L[i] + nmax);
    return scale;
}

static float make_qkx2_quants(int n, int nmax, const float* x,
                              const float* weights, uint8_t* L,
                              float* the_min, uint8_t* Laux, float rmin,
                              float rdelta, int nstep, bool use_mad) {
    float min = x[0], max = x[0];
    float sum_w = weights[0], sum_x = sum_w * x[0];
    for (int i = 1; i < n; ++i) {
        if (x[i] < min) min = x[i];
        if (x[i] > max) max = x[i];
        float w = weights[i];
        sum_w += w;
        sum_x += w * x[i];
    }
    if (min > 0) min = 0;
    if (max == min) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        *the_min = -min;
        return 0.0f;
    }
    float iscale = nmax / (max - min);
    float scale = 1.0f / iscale;
    float best_mad = 0.0f;
    for (int i = 0; i < n; ++i) {
        int l = nearest_int(iscale * (x[i] - min));
        L[i] = (uint8_t)(l < 0 ? 0 : (l > nmax ? nmax : l));
        float diff = scale * L[i] + min - x[i];
        diff = use_mad ? std::fabs(diff) : diff * diff;
        best_mad += weights[i] * diff;
    }
    if (nstep < 1) { *the_min = -min; return scale; }
    for (int is = 0; is <= nstep; ++is) {
        iscale = (rmin + rdelta * is + nmax) / (max - min);
        float sum_l = 0, sum_l2 = 0, sum_xl = 0;
        for (int i = 0; i < n; ++i) {
            int l = nearest_int(iscale * (x[i] - min));
            l = l < 0 ? 0 : (l > nmax ? nmax : l);
            Laux[i] = (uint8_t)l;
            float w = weights[i];
            sum_l += w * l;
            sum_l2 += w * (float)l * l;
            sum_xl += w * l * x[i];
        }
        float D = sum_w * sum_l2 - sum_l * sum_l;
        if (D > 0) {
            float this_scale = (sum_w * sum_xl - sum_x * sum_l) / D;
            float this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D;
            if (this_min > 0) {
                this_min = 0;
                this_scale = sum_xl / sum_l2;
            }
            float mad = 0;
            for (int i = 0; i < n; ++i) {
                float diff = this_scale * Laux[i] + this_min - x[i];
                diff = use_mad ? std::fabs(diff) : diff * diff;
                mad += weights[i] * diff;
            }
            if (mad < best_mad) {
                for (int i = 0; i < n; ++i) L[i] = Laux[i];
                best_mad = mad;
                scale = this_scale;
                min = this_min;
            }
        }
    }
    *the_min = -min;
    return scale;
}

static float make_q3_quants(int n, int nmax, const float* x, int8_t* L,
                            bool do_rmse) {
    float max = 0.0f, amax = 0.0f;
    for (int i = 0; i < n; ++i) {
        float ax = std::fabs(x[i]);
        if (ax > amax) { amax = ax; max = x[i]; }
    }
    if (amax < GROUP_MAX_EPS) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        return 0.0f;
    }
    float iscale = -nmax / max;
    if (do_rmse) {
        float sumlx = 0, suml2 = 0;
        for (int i = 0; i < n; ++i) {
            int l = nearest_int(iscale * x[i]);
            l = l < -nmax ? -nmax : (l > nmax - 1 ? nmax - 1 : l);
            L[i] = (int8_t)l;
            float w = x[i] * x[i];
            sumlx += w * x[i] * l;
            suml2 += w * (float)l * l;
        }
        for (int itry = 0; itry < 5; ++itry) {
            int n_changed = 0;
            for (int i = 0; i < n; ++i) {
                float w = x[i] * x[i];
                float slx = sumlx - w * x[i] * L[i];
                if (slx > 0) {
                    float sl2 = suml2 - w * (float)L[i] * L[i];
                    int new_l = nearest_int(x[i] * sl2 / slx);
                    new_l = new_l < -nmax ? -nmax : (new_l > nmax - 1 ? nmax - 1 : new_l);
                    if (new_l != L[i]) {
                        slx += w * x[i] * new_l;
                        sl2 += w * (float)new_l * new_l;
                        if (sl2 > 0 && slx * slx * suml2 > sumlx * sumlx * sl2) {
                            L[i] = (int8_t)new_l;
                            sumlx = slx;
                            suml2 = sl2;
                            ++n_changed;
                        }
                    }
                }
            }
            if (!n_changed) break;
        }
        for (int i = 0; i < n; ++i) L[i] = (int8_t)(L[i] + nmax);
        return suml2 > 0 ? sumlx / suml2 : 0.0f;
    }
    for (int i = 0; i < n; ++i) {
        int l = nearest_int(iscale * x[i]);
        l = l < -nmax ? -nmax : (l > nmax - 1 ? nmax - 1 : l);
        L[i] = (int8_t)(l + nmax);
    }
    return 1.0f / iscale;
}

static void pack_scale_min_k4(const uint8_t* ls, const uint8_t* lm,
                              uint8_t* sc) {     // inverse of get_scale_min_k4
    for (int j = 0; j < 12; ++j) sc[j] = 0;
    for (int j = 0; j < 4; ++j) {
        sc[j] = ls[j];
        sc[j + 4] = lm[j];
    }
    for (int j = 4; j < 8; ++j) {
        sc[j + 4] = (uint8_t)((ls[j] & 0xF) | ((lm[j] & 0xF) << 4));
        sc[j - 4] |= (uint8_t)((ls[j] >> 4) << 6);
        sc[j] |= (uint8_t)((lm[j] >> 4) << 6);
    }
}

API void q2_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 84;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        uint8_t* scales = o;
        uint8_t* qs = o + 16;
        uint8_t L[QK_K], Laux[16];
        float weights[16], sc16[16], mn16[16];
        for (int j = 0; j < 16; ++j) {
            for (int l = 0; l < 16; ++l) weights[l] = std::fabs(xb[16 * j + l]);
            sc16[j] = make_qkx2_quants(16, 3, xb + 16 * j, weights,
                                       L + 16 * j, &mn16[j], Laux,
                                       -0.5f, 0.1f, 15, true);
        }
        float max_scale = 0, max_min = 0;
        for (int j = 0; j < 16; ++j) {
            if (sc16[j] > max_scale) max_scale = sc16[j];
            if (mn16[j] > max_min) max_min = mn16[j];
        }
        float d = 0, dmin = 0;
        if (max_scale > 0) {
            float isc = 15.0f / max_scale;
            for (int j = 0; j < 16; ++j)
                scales[j] = (uint8_t)nearest_int(isc * sc16[j]);
            d = max_scale / 15.0f;
        } else {
            for (int j = 0; j < 16; ++j) scales[j] = 0;
        }
        if (max_min > 0) {
            float iscm = 15.0f / max_min;
            for (int j = 0; j < 16; ++j)
                scales[j] |= (uint8_t)(nearest_int(iscm * mn16[j]) << 4);
            dmin = max_min / 15.0f;
        }
        uint16_t dh = f32_to_f16(d), mh = f32_to_f16(dmin);
        std::memcpy(o + 80, &dh, 2);
        std::memcpy(o + 82, &mh, 2);
        float d16 = f16_to_f32(dh), dmin16 = f16_to_f32(mh);
        for (int j = 0; j < 16; ++j) {
            float dl = d16 * (scales[j] & 0xF);
            if (dl == 0.0f) continue;
            float ml = dmin16 * (scales[j] >> 4);
            for (int l = 0; l < 16; ++l) {
                int nl = nearest_int((xb[16 * j + l] + ml) / dl);
                L[16 * j + l] = (uint8_t)(nl < 0 ? 0 : (nl > 3 ? 3 : nl));
            }
        }
        // pack 2-bit (inverse of the q2_K dequant loop)
        for (int jj = 0; jj < QK_K; jj += 128) {
            uint8_t* q = qs + jj / 4;
            for (int l = 0; l < 32; ++l) {
                q[l] = (uint8_t)(L[jj + l] | (L[jj + l + 32] << 2)
                                 | (L[jj + l + 64] << 4) | (L[jj + l + 96] << 6));
            }
        }
    }
}

API void q3_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 110;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        uint8_t* hmask = o;
        uint8_t* qs = o + 32;
        uint8_t* scb = o + 96;
        int8_t L8[QK_K];
        float sc16[16];
        for (int j = 0; j < 16; ++j)
            sc16[j] = make_q3_quants(16, 4, xb + 16 * j, L8 + 16 * j, true);
        // 6-bit quantize the scales against -32 super scale
        float max_scale = 0, amax = 0;
        for (int j = 0; j < 16; ++j) {
            float ax = std::fabs(sc16[j]);
            if (ax > amax) { amax = ax; max_scale = sc16[j]; }
        }
        float d = 0;
        uint8_t l6[16];
        for (int j = 0; j < 12; ++j) scb[j] = 0;
        if (max_scale != 0) {
            float iscale = -32.0f / max_scale;
            for (int j = 0; j < 16; ++j) {
                int l = nearest_int(iscale * sc16[j]);
                l = (l < -32 ? -32 : (l > 31 ? 31 : l)) + 32;
                l6[j] = (uint8_t)l;
            }
            d = 1.0f / iscale;
        } else {
            for (int j = 0; j < 16; ++j) l6[j] = 0;
        }
        // pack 16 6-bit scales into 12 bytes (q3_K layout)
        for (int j = 0; j < 16; ++j) {
            uint8_t lo = l6[j] & 0xF, hi = l6[j] >> 4;
            if (j < 8) scb[j] |= lo;
            else scb[j - 8] |= (uint8_t)(lo << 4);
            scb[8 + (j % 4)] |= (uint8_t)(hi << (2 * (j / 4)));
        }
        uint16_t dh = f32_to_f16(d);
        std::memcpy(o + 108, &dh, 2);
        // re-quantize with stored 6-bit scales
        float d16 = f16_to_f32(dh);
        for (int j = 0; j < 16; ++j) {
            int lo = j < 8 ? (scb[j] & 0xF) : (scb[j - 8] >> 4);
            int hi = (scb[8 + (j % 4)] >> (2 * (j / 4))) & 3;
            float dl = d16 * ((lo | (hi << 4)) - 32);
            if (dl != 0.0f) {
                for (int l = 0; l < 16; ++l) {
                    int nl = nearest_int(xb[16 * j + l] / dl);
                    nl = nl < -4 ? -4 : (nl > 3 ? 3 : nl);
                    L8[16 * j + l] = (int8_t)(nl + 4);
                }
            }
        }
        // split into high-bit mask + 2-bit quants
        for (int j = 0; j < 32; ++j) hmask[j] = 0;
        uint8_t m = 1;
        {
            int bit_j = 0;
            for (int jj = 0; jj < QK_K; jj += 128) {
                for (int sh = 0; sh < 4; ++sh) {
                    for (int l = 0; l < 32; ++l) {
                        int idx = jj + sh * 32 + l;
                        if (L8[idx] > 3) {
                            hmask[l] |= m;
                            L8[idx] = (int8_t)(L8[idx] - 4);
                        }
                    }
                    m <<= 1;
                }
                (void)bit_j;
            }
        }
        for (int jj = 0; jj < QK_K; jj += 128) {
            uint8_t* q = qs + jj / 4;
            for (int l = 0; l < 32; ++l) {
                q[l] = (uint8_t)(L8[jj + l] | (L8[jj + l + 32] << 2)
                                 | (L8[jj + l + 64] << 4) | (L8[jj + l + 96] << 6));
            }
        }
    }
}

static void quantize_k45(const float* xb, int nmax, float rmin, int nstep,
                         float* sc8, float* mn8, uint8_t* L) {
    uint8_t Laux[32];
    float weights[32];
    for (int j = 0; j < 8; ++j) {
        float sum_x2 = 0;
        for (int l = 0; l < 32; ++l) {
            float v = xb[32 * j + l];
            sum_x2 += v * v;
        }
        float av_x = std::sqrt(sum_x2 / 32.0f);
        for (int l = 0; l < 32; ++l)
            weights[l] = av_x + std::fabs(xb[32 * j + l]);
        sc8[j] = make_qkx2_quants(32, nmax, xb + 32 * j, weights, L + 32 * j,
                                  &mn8[j], Laux, rmin, 0.1f, nstep, false);
    }
}

static void store_k45_scales(const float* sc8, const float* mn8,
                             uint8_t* packed, float* d, float* dmin) {
    float max_scale = 0, max_min = 0;
    for (int j = 0; j < 8; ++j) {
        if (sc8[j] > max_scale) max_scale = sc8[j];
        if (mn8[j] > max_min) max_min = mn8[j];
    }
    float inv_scale = max_scale > 0 ? 63.0f / max_scale : 0.0f;
    float inv_min = max_min > 0 ? 63.0f / max_min : 0.0f;
    uint8_t ls[8], lm[8];
    for (int j = 0; j < 8; ++j) {
        int a = nearest_int(inv_scale * sc8[j]);
        int b = nearest_int(inv_min * mn8[j]);
        ls[j] = (uint8_t)(a > 63 ? 63 : a);
        lm[j] = (uint8_t)(b > 63 ? 63 : b);
    }
    pack_scale_min_k4(ls, lm, packed);
    *d = max_scale / 63.0f;
    *dmin = max_min / 63.0f;
}

API void q4_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 144;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        uint8_t L[QK_K];
        float sc8[8], mn8[8], d, dmin;
        quantize_k45(xb, 15, -1.0f, 20, sc8, mn8, L);
        store_k45_scales(sc8, mn8, o + 4, &d, &dmin);
        uint16_t dh = f32_to_f16(d), mh = f32_to_f16(dmin);
        std::memcpy(o, &dh, 2);
        std::memcpy(o + 2, &mh, 2);
        float d16 = f16_to_f32(dh), dmin16 = f16_to_f32(mh);
        for (int j = 0; j < 8; ++j) {
            uint8_t sd, sm;
            get_scale_min_k4(j, o + 4, &sd, &sm);
            float dl = d16 * sd;
            if (dl == 0.0f) continue;
            float ml = dmin16 * sm;
            for (int l = 0; l < 32; ++l) {
                int nl = nearest_int((xb[32 * j + l] + ml) / dl);
                L[32 * j + l] = (uint8_t)(nl < 0 ? 0 : (nl > 15 ? 15 : nl));
            }
        }
        uint8_t* q = o + 16;
        for (int j = 0; j < QK_K; j += 64) {
            for (int l = 0; l < 32; ++l)
                q[l] = (uint8_t)(L[j + l] | (L[j + l + 32] << 4));
            q += 32;
        }
    }
}

API void q5_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 176;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        uint8_t L[QK_K];
        float sc8[8], mn8[8], d, dmin;
        quantize_k45(xb, 31, -0.5f, 15, sc8, mn8, L);
        store_k45_scales(sc8, mn8, o + 4, &d, &dmin);
        uint16_t dh = f32_to_f16(d), mh = f32_to_f16(dmin);
        std::memcpy(o, &dh, 2);
        std::memcpy(o + 2, &mh, 2);
        float d16 = f16_to_f32(dh), dmin16 = f16_to_f32(mh);
        for (int j = 0; j < 8; ++j) {
            uint8_t sd, sm;
            get_scale_min_k4(j, o + 4, &sd, &sm);
            float dl = d16 * sd;
            if (dl == 0.0f) continue;
            float ml = dmin16 * sm;
            for (int l = 0; l < 32; ++l) {
                int nl = nearest_int((xb[32 * j + l] + ml) / dl);
                L[32 * j + l] = (uint8_t)(nl < 0 ? 0 : (nl > 31 ? 31 : nl));
            }
        }
        uint8_t* qh = o + 16;
        uint8_t* ql = o + 48;
        for (int j = 0; j < 32; ++j) qh[j] = 0;
        uint8_t u1 = 1, u2 = 2;
        for (int j = 0; j < QK_K; j += 64) {
            for (int l = 0; l < 32; ++l) {
                uint8_t a = L[j + l], b = L[j + l + 32];
                ql[l] = (uint8_t)((a & 0xF) | ((b & 0xF) << 4));
                if (a > 15) qh[l] |= u1;
                if (b > 15) qh[l] |= u2;
            }
            ql += 32;
            u1 <<= 2; u2 <<= 2;
        }
    }
}

API void q6_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 210;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        uint8_t* ql = o;
        uint8_t* qh = o + 128;
        int8_t* scb = (int8_t*)(o + 192);
        int8_t L8[QK_K];
        float sc16[16];
        for (int j = 0; j < 16; ++j)
            sc16[j] = make_qx_quants(16, 32, xb + 16 * j, L8 + 16 * j, NULL);
        float max_scale = 0, amax = 0;
        for (int j = 0; j < 16; ++j) {
            float ax = std::fabs(sc16[j]);
            if (ax > amax) { amax = ax; max_scale = sc16[j]; }
        }
        if (amax == 0) {
            std::memset(o, 0, bs);
            continue;
        }
        float iscale = -128.0f / max_scale;
        float d = 1.0f / iscale;
        for (int j = 0; j < 16; ++j) {
            int l = nearest_int(iscale * sc16[j]);
            scb[j] = (int8_t)(l > 127 ? 127 : l);
        }
        uint16_t dh = f32_to_f16(d);
        std::memcpy(o + 208, &dh, 2);
        float d16 = f16_to_f32(dh);
        for (int j = 0; j < 16; ++j) {
            float dl = d16 * scb[j];
            if (dl == 0.0f) continue;
            for (int l = 0; l < 16; ++l) {
                int nl = nearest_int(xb[16 * j + l] / dl);
                nl = nl < -32 ? -32 : (nl > 31 ? 31 : nl);
                L8[16 * j + l] = (int8_t)(nl + 32);
            }
        }
        for (int jj = 0; jj < QK_K; jj += 128) {
            uint8_t* pl = ql + jj / 2;
            uint8_t* ph = qh + jj / 4;
            for (int l = 0; l < 32; ++l) {
                uint8_t q1 = (uint8_t)L8[jj + l];
                uint8_t q2 = (uint8_t)L8[jj + l + 32];
                uint8_t q3 = (uint8_t)L8[jj + l + 64];
                uint8_t q4 = (uint8_t)L8[jj + l + 96];
                pl[l]      = (uint8_t)((q1 & 0xF) | ((q3 & 0xF) << 4));
                pl[l + 32] = (uint8_t)((q2 & 0xF) | ((q4 & 0xF) << 4));
                ph[l] = (uint8_t)((q1 >> 4) | ((q2 >> 4) << 2)
                                  | ((q3 >> 4) << 4) | ((q4 >> 4) << 6));
            }
        }
    }
}

API void q8_K_quantize(const float* x, uint8_t* out, int64_t nb) {
    const int bs = 292;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nb; ++i) {
        const float* xb = x + i * QK_K;
        uint8_t* o = out + i * bs;
        int8_t* q = (int8_t*)(o + 4);
        int16_t* bsums = (int16_t*)(o + 4 + QK_K);
        float max = 0, amax = 0;
        for (int j = 0; j < QK_K; ++j) {
            float ax = std::fabs(xb[j]);
            if (ax > amax) { amax = ax; max = xb[j]; }
        }
        if (amax == 0) {
            float z = 0;
            std::memcpy(o, &z, 4);
            std::memset(o + 4, 0, QK_K + 32);
            continue;
        }
        float iscale = -127.0f / max;
        for (int j = 0; j < QK_K; ++j) {
            int v = nearest_int(iscale * xb[j]);
            q[j] = (int8_t)(v > 127 ? 127 : v);
        }
        for (int j = 0; j < 16; ++j) {
            int s = 0;
            for (int l = 0; l < 16; ++l) s += q[16 * j + l];
            bsums[j] = (int16_t)s;
        }
        float d = 1.0f / iscale;
        std::memcpy(o, &d, 4);
    }
}
