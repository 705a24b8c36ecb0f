// The port's copy of ggml_imax_tpu/native/iq_encoders.cpp, with two
// changes for inputs where that copy reads memory it never wrote:
// - the L, Laux and shifts scratch arrays are one RowScratch a call, zeroed
//   at its start, that every row uses in turn. A sub-block whose importance
//   weights are all zero never takes a trial scale (best stays 0), so its
//   L was whatever the stack held; IQ1_S / IQ1_M skip an all-zero
//   sub-block without setting its shift, then read it (IQ1_M indexes
//   masks[] with it, out of bounds). The stack held the previous row's
//   values, as RowScratch now does, except in a call's first row;
// - IQ1_S / IQ1_M, when no split of a sub-block scores (every weight 0,
//   where the reference asserts), take the all-zero sub-block's path; the
//   copy indexed idx[-2] and masks[-1].
// There the output depended on earlier calls, or the process crashed.
// Wherever that copy reads only what it wrote, the bytes are unchanged
// (tests/fixtures/golden_iq_encode.npz).
//
// iq_encoders.cpp — weight-space encoders for the IQ codebook formats
// (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M).
//
// Algorithm spec: the importance-weighted codebook searches of the reference
// (quantize_iq2_xxs and siblings, ggml's src/ggml-quants.c:12529
// through :14200, grid/neighbour construction iq2xs_init_impl :12139 /
// iq3xs_init_impl :12933). Bit-exactness against the compiled reference
// requires the identical float operation ORDER — the algorithm is the spec —
// but the structure here is our own: one generic grid-set constructor shared by
// the 2-bit/1-bit (8-point) and 3-bit (4-point) lattices, codebook l-value
// tables supplied by the Python caller (derived from the normative decode
// grids in quant/iq_grids.npz), and flat encoder entry points with a ctypes
// ABI. Compiled with -ffp-contract=off (see native/__init__.py).
//
// Build: g++ -O3 -ffp-contract=off -shared (cached by source hash, see
// native/__init__.py). No dependencies beyond libc/libm.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#define API extern "C" __attribute__((visibility("default")))

#define QK_K 256

// ---- helpers identical to native/codecs.cpp (duplicated: separate .so) ----
static inline uint16_t f32_to_f16(float f) {
    uint32_t x; std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t  exp  = (int32_t)((x >> 23) & 0xff) - 127 + 15;
    uint32_t man  = x & 0x7fffffu;
    if (((x >> 23) & 0xff) == 0xff) {
        return (uint16_t)(sign | 0x7c00u | (man ? 0x200u | (man >> 13) : 0));
    }
    if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00u);
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;
        man |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t out   = man >> shift;
        uint32_t rem   = man & ((1u << shift) - 1);
        uint32_t half  = 1u << (shift - 1);
        if (rem > half || (rem == half && (out & 1))) out++;
        return (uint16_t)(sign | out);
    }
    uint16_t out = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
    uint32_t rem = man & 0x1fffu;
    if (rem > 0x1000u || (rem == 0x1000u && (out & 1))) out++;
    return out;
}

static inline int nearest_int(float f) {
    float v = f + 12582912.0f;                      // 1.5 * 2^23, RNE trick
    int32_t i; std::memcpy(&i, &v, 4);
    return (i & 0x007fffff) - 0x00400000;
}

#define MAXF(a, b) ((a) > (b) ? (a) : (b))
#define MINI(a, b) ((a) < (b) ? (a) : (b))
#define MAXI(a, b) ((a) > (b) ? (a) : (b))

// ------------------------------------------------------------- grid sets ----
// A grid set = expanded codebook + exact-match map + nearest-neighbour lists,
// built once per lattice from the l-value seeds (2 or 3 bits per coordinate).
// Entry layout matches the reference: npos int8 coords 2*l+1 per grid point,
// stored in a uint64 slot so int8* aliasing works for both 8- and 4-point
// lattices.

struct GridSet {
    int        n = 0;           // grid point count
    int        npos = 0;        // coords per point (8 for iq2/iq1, 4 for iq3)
    int        bits = 0;        // bits per coord in the packed index (2 or 3)
    int        kmap_size = 0;
    uint64_t  *grid = nullptr;  // n slots, int8 coords in the low npos bytes
    int       *map = nullptr;   // packed-index -> grid id, or -(neigh_pos+1)
    uint16_t  *neigh = nullptr; // [count, ids...] runs, indexed via map
};

enum { GS_IQ2_XXS = 0, GS_IQ2_XS, GS_IQ2_S, GS_IQ1, GS_IQ3_256, GS_IQ3_512,
       GS_COUNT };
static GridSet g_sets[GS_COUNT];

struct DistEntry { int d2; int id; };

static int cmp_dist(const void *a, const void *b) {
    const DistEntry *l = (const DistEntry *)a;
    const DistEntry *r = (const DistEntry *)b;
    return l->d2 < r->d2 ? -1 : l->d2 > r->d2 ? 1 :
           l->id < r->id ? -1 : l->id > r->id ? 1 : 0;
}

// Replicates iq2xs_init_impl / iq3xs_init_impl (ggml-quants.c:12404-12500,
// :13000-13090): expand seeds, invert into the map, and for every packed
// index not on the grid collect all neighbours within the nwant nearest
// distinct squared distances (sorted by distance, then grid id).
static void build_gridset(GridSet *gs, const uint16_t *seeds, int n, int npos,
                          int bits, int kmap_size, int nwant) {
    gs->n = n; gs->npos = npos; gs->bits = bits; gs->kmap_size = kmap_size;
    gs->grid = (uint64_t *)malloc(n * sizeof(uint64_t));
    for (int k = 0; k < n; ++k) {
        int8_t *pos = (int8_t *)(gs->grid + k);
        for (int i = 0; i < 8; ++i) pos[i] = 0;
        for (int i = 0; i < npos; ++i) {
            int l = (seeds[k] >> (bits * i)) & ((1 << bits) - 1);
            pos[i] = (int8_t)(2 * l + 1);
        }
    }
    gs->map = (int *)malloc(kmap_size * sizeof(int));
    for (int i = 0; i < kmap_size; ++i) gs->map[i] = -1;
    for (int k = 0; k < n; ++k) {
        const int8_t *pos = (const int8_t *)(gs->grid + k);
        uint32_t index = 0;
        for (int i = 0; i < npos; ++i) {
            uint32_t q = (uint32_t)((pos[i] - 1) / 2);
            index |= q << (bits * i);
        }
        gs->map[index] = k;
    }

    DistEntry *dist = (DistEntry *)malloc(n * sizeof(DistEntry));
    int8_t pos[8];
    // pass 1: count neighbour storage
    long total = 0; int num_not_in_map = 0;
    for (int i = 0; i < kmap_size; ++i) {
        if (gs->map[i] >= 0) continue;
        ++num_not_in_map;
        for (int k = 0; k < npos; ++k)
            pos[k] = (int8_t)(2 * ((i >> (bits * k)) & ((1 << bits) - 1)) + 1);
        for (int j = 0; j < n; ++j) {
            const int8_t *pg = (const int8_t *)(gs->grid + j);
            int d2 = 0;
            for (int k = 0; k < npos; ++k)
                d2 += (pg[k] - pos[k]) * (pg[k] - pos[k]);
            dist[j].d2 = d2; dist[j].id = j;
        }
        qsort(dist, n, sizeof(DistEntry), cmp_dist);
        int cnt = 0, d2 = dist[0].d2, nhave = 1;
        for (int j = 0; j < n; ++j) {
            if (dist[j].d2 > d2) {
                if (nhave == nwant) break;
                d2 = dist[j].d2; ++nhave;
            }
            ++cnt;
        }
        total += cnt;
    }
    gs->neigh = (uint16_t *)malloc((total + num_not_in_map) * sizeof(uint16_t));
    // pass 2: fill neighbour runs and re-point the map at them
    int counter = 0;
    for (int i = 0; i < kmap_size; ++i) {
        if (gs->map[i] >= 0) continue;
        for (int k = 0; k < npos; ++k)
            pos[k] = (int8_t)(2 * ((i >> (bits * k)) & ((1 << bits) - 1)) + 1);
        for (int j = 0; j < n; ++j) {
            const int8_t *pg = (const int8_t *)(gs->grid + j);
            int d2 = 0;
            for (int k = 0; k < npos; ++k)
                d2 += (pg[k] - pos[k]) * (pg[k] - pos[k]);
            dist[j].d2 = d2; dist[j].id = j;
        }
        qsort(dist, n, sizeof(DistEntry), cmp_dist);
        gs->map[i] = -(counter + 1);
        uint16_t *start = &gs->neigh[counter++];
        int cnt = 0, d2 = dist[0].d2, nhave = 1;
        for (int j = 0; j < n; ++j) {
            if (dist[j].d2 > d2) {
                if (nhave == nwant) break;
                d2 = dist[j].d2; ++nhave;
            }
            gs->neigh[counter++] = (uint16_t)dist[j].id;
            ++cnt;
        }
        *start = (uint16_t)cnt;
    }
    free(dist);
}

API int iq_init(int which, const uint16_t *seeds, int grid_size) {
    if (which < 0 || which >= GS_COUNT) return -1;
    if (g_sets[which].grid) return 0;   // already built
    switch (which) {
        case GS_IQ2_XXS: build_gridset(&g_sets[which], seeds, grid_size, 8, 2, 43692, 2); break;
        case GS_IQ2_XS:  build_gridset(&g_sets[which], seeds, grid_size, 8, 2, 43692, 2); break;
        case GS_IQ2_S:   build_gridset(&g_sets[which], seeds, grid_size, 8, 2, 43692, 1); break;
        case GS_IQ1:     build_gridset(&g_sets[which], seeds, grid_size, 8, 2, 43692, 3); break;
        case GS_IQ3_256: build_gridset(&g_sets[which], seeds, grid_size, 4, 3, 4096, 2); break;
        case GS_IQ3_512: build_gridset(&g_sets[which], seeds, grid_size, 4, 3, 4096, 3); break;
    }
    return 0;
}

API int iq_ready(int which) {
    return which >= 0 && which < GS_COUNT && g_sets[which].grid ? 1 : 0;
}

// -------------------------------------------------- neighbour refinements ----
// weighted nearest grid point at a fixed scale (iq2_find_best_neighbour,
// ggml-quants.c:12505)
static int nearest_on_grid8(const GridSet &gs, const uint16_t *nb,
                            const float *xval, const float *waux, float scale,
                            int8_t *L) {
    int num = nb[0];
    float best_d2 = FLT_MAX;
    int gi = -1;
    for (int j = 1; j <= num; ++j) {
        const int8_t *pg = (const int8_t *)(gs.grid + nb[j]);
        float d2 = 0;
        for (int i = 0; i < 8; ++i) {
            float q = pg[i];
            float diff = scale * q - xval[i];
            d2 += waux[i] * diff * diff;
        }
        if (d2 < best_d2) { best_d2 = d2; gi = nb[j]; }
    }
    const int8_t *pg = (const int8_t *)(gs.grid + gi);
    for (int i = 0; i < 8; ++i) L[i] = (int8_t)((pg[i] - 1) / 2);
    return gi;
}

// 4-point variant (iq3_find_best_neighbour, ggml-quants.c:13091)
static int nearest_on_grid4(const GridSet &gs, const uint16_t *nb,
                            const float *xval, const float *waux, float scale,
                            int8_t *L) {
    int num = nb[0];
    float best_d2 = FLT_MAX;
    int gi = -1;
    for (int j = 1; j <= num; ++j) {
        const int8_t *pg = (const int8_t *)(gs.grid + nb[j]);
        float d2 = 0;
        for (int i = 0; i < 4; ++i) {
            float q = pg[i];
            float diff = scale * q - xval[i];
            d2 += waux[i] * diff * diff;
        }
        if (d2 < best_d2) { best_d2 = d2; gi = nb[j]; }
    }
    const int8_t *pg = (const int8_t *)(gs.grid + gi);
    for (int i = 0; i < 4; ++i) L[i] = (int8_t)((pg[i] - 1) / 2);
    return gi;
}

// make_qp_quants (ggml-quants.c:1579): weighted non-negative quantizer with
// iscale probing and 5 rounds of coordinate descent
static float qp_quants(int n, int nmax, const float *x, uint8_t *L,
                       const float *qw) {
    float max = 0;
    for (int i = 0; i < n; ++i) max = MAXF(max, x[i]);
    if (!max) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        return 0.f;
    }
    float iscale = nmax / max;
    for (int i = 0; i < n; ++i) L[i] = (uint8_t)nearest_int(iscale * x[i]);
    float scale = 1 / iscale;
    float best_mse = 0;
    for (int i = 0; i < n; ++i) {
        float diff = x[i] - scale * L[i];
        best_mse += qw[i] * diff * diff;
    }
    for (int is = -4; is <= 4; ++is) {
        if (is == 0) continue;
        float isc = (0.1f * is + nmax) / max;
        float sc  = 1 / isc;
        float mse = 0;
        for (int i = 0; i < n; ++i) {
            int l = nearest_int(isc * x[i]);
            l = MINI(nmax, l);
            float diff = x[i] - sc * l;
            mse += qw[i] * diff * diff;
        }
        if (mse < best_mse) { best_mse = mse; iscale = isc; }
    }
    float sumlx = 0, suml2 = 0;
    for (int i = 0; i < n; ++i) {
        int l = nearest_int(iscale * x[i]);
        l = MINI(nmax, l);
        L[i] = (uint8_t)l;
        sumlx += qw[i] * x[i] * l;
        suml2 += qw[i] * (float)l * l;
    }
    for (int itry = 0; itry < 5; ++itry) {
        int n_changed = 0;
        for (int i = 0; i < n; ++i) {
            float w = qw[i];
            float slx = sumlx - w * x[i] * L[i];
            float sl2 = suml2 - w * (float)L[i] * L[i];
            if (slx > 0 && sl2 > 0) {
                int nl = nearest_int(x[i] * sl2 / slx);
                nl = MINI(nmax, nl);
                if (nl != L[i]) {
                    slx += w * x[i] * nl;
                    sl2 += w * (float)nl * nl;
                    if (slx * slx * suml2 > sumlx * sumlx * sl2) {
                        L[i] = (uint8_t)nl; sumlx = slx; suml2 = sl2;
                        ++n_changed;
                    }
                }
            }
        }
        if (!n_changed) break;
    }
    return sumlx / suml2;
}

// shared preamble: fold signs out of an 8-group, forcing even sign parity by
// flipping the least-significant element (iq2_xxs/iq2_xs only)
static uint8_t fold_signs_even(const float *xb, const float *weight,
                               float *xval) {
    int nflip = 0;
    uint8_t s = 0;
    for (int i = 0; i < 8; ++i) {
        if (xb[i] >= 0) xval[i] = xb[i];
        else { xval[i] = -xb[i]; ++nflip; s |= (uint8_t)(1 << i); }
    }
    if (nflip % 2) {
        int imin = 0; float min = weight[0] * xb[0] * xb[0];
        for (int i = 1; i < 8; ++i) {
            float ax = weight[i] * xb[i] * xb[i];
            if (ax < min) { min = ax; imin = i; }
        }
        xval[imin] = -xval[imin];
        s ^= (uint8_t)(1 << imin);
    }
    return (uint8_t)(s & 127);
}

// ------------------------------------------------------------- IQ2_XXS ----
// block: fp16 d + uint16 qs[QK_K/8]  (66 bytes)
// Scratch the row encoders keep across the rows of one call, zeroed at its
// start: the reference's stack arrays of quantize_row_*_impl, which a row
// reads where it wrote nothing (L of a sub-block whose weights are all
// zero; the shift of an all-zero IQ1 sub-block) and which then hold what
// the previous row left. The compiled reference's golden bytes come from
// that (an all-zero IQ1_S sub-block takes the shift of the same sub-block
// in the row before).
struct RowScratch {
    int8_t L[32], Laux[32], shifts[QK_K / 16];
};

static void enc_row_iq2_xxs(const float *x, uint8_t *out, int64_t n,
                            const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ2_XXS];
    const int kMaxQ = 3;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + QK_K / 4;

    float scales[QK_K / 32], weight[32], xval[32], waux[32];
    int8_t *L = s.L, *Laux = s.Laux;
    uint8_t block_signs[4];
    uint32_t q2[2 * (QK_K / 32)];

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        std::memset(q2, 0, QK_K / 4);

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / 32; ++ib) {
            const float *xb = xbl + 32 * ib;
            const float *qw = qw_row + QK_K * ibl + 32 * ib;
            for (int i = 0; i < 32; ++i)
                weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            for (int i = 0; i < 32; ++i) waux[i] = sqrtf(weight[i]);
            for (int k = 0; k < 4; ++k)
                block_signs[k] = fold_signs_even(xb + 8 * k, weight + 8 * k,
                                                 xval + 8 * k);
            float max = xval[0];
            for (int i = 1; i < 32; ++i) max = MAXF(max, xval[i]);
            if (!max) {
                scales[ib] = 0;
                std::memset(L, 0, 32);
                continue;
            }
            float scale = qp_quants(32, kMaxQ + 1, xval, (uint8_t *)L, weight);
            float eff_max = scale * kMaxQ;
            float best = 0;
            for (int is = -6; is <= 6; ++is) {
                float id = (2 * kMaxQ - 1 + is * 0.1f) / eff_max;
                float this_scale = 1 / id;
                for (int k = 0; k < 4; ++k) {
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        Laux[8 * k + i] = (int8_t)MAXI(0, MINI(kMaxQ - 1, l));
                    }
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i)
                        u |= (uint16_t)(Laux[8 * k + i] << 2 * i);
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid8(gs, nb, xval + 8 * k, waux + 8 * k,
                                         this_scale, Laux + 8 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 32; ++i) {
                    float w = weight[i];
                    float q = 2 * Laux[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0 && sumqx * sumqx > best * sumq2) {
                    scale = sumqx / sumq2; best = scale * sumqx;
                    std::memcpy(L, Laux, 32);
                }
            }
            if (scale > 0) {
                float id = 1 / scale;
                for (int k = 0; k < 4; ++k) {
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        l = MAXI(0, MINI(kMaxQ - 1, l));
                        u |= (uint16_t)(l << 2 * i);
                    }
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        gi = nearest_on_grid8(gs, nb, xval + 8 * k,
                                              waux + 8 * k, scale, L + 8 * k);
                    }
                    const int8_t *pg = (const int8_t *)(gs.grid + gi);
                    for (int i = 0; i < 8; ++i)
                        L[8 * k + i] = (int8_t)((pg[i] - 1) / 2);
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 32; ++i) {
                    float w = weight[i];
                    float q = 2 * L[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0) scale = sumqx / sumq2;
            }
            if (scale < 0) {
                scale = -scale;
                for (int k = 0; k < 4; ++k)
                    block_signs[k] = (uint8_t)((~block_signs[k]) & 127);
            }
            for (int k = 0; k < 4; ++k) {
                uint16_t u = 0;
                for (int i = 0; i < 8; ++i)
                    u |= (uint16_t)(L[8 * k + i] << 2 * i);
                int gi = gs.map[u];
                q2[2 * ib + 0] |= ((uint32_t)gi << 8 * k);
                q2[2 * ib + 1] |= ((uint32_t)block_signs[k] << 7 * k);
            }
            scales[ib] = scale;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;   // block already zeroed (d = 0)

        float d = max_scale / 31;
        uint16_t dh = f32_to_f16(d);
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / 32; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib] - 1));
            l = MAXI(0, MINI(15, l));
            q2[2 * ib + 1] |= ((uint32_t)l << 28);
        }
        std::memcpy(yb + 2, q2, QK_K / 4);
    }
}

// -------------------------------------------------------------- IQ2_XS ----
// block: fp16 d + uint16 qs[QK_K/16? -> QK_K/32*2] + uint8 scales[QK_K/32] (74)
static void enc_row_iq2_xs(const float *x, uint8_t *out, int64_t n,
                           const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ2_XS];
    const int kMaxQ = 3;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + QK_K / 4 + QK_K / 32;

    float scales[QK_K / 16], weight[16], xval[16], waux[16];
    int8_t *L = s.L, *Laux = s.Laux;
    bool on_grid[2], on_grid_aux[2];
    uint8_t block_signs[2];
    uint16_t q2[2 * (QK_K / 16)];

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        uint8_t *ysc = yb + 2 + QK_K / 4;
        std::memset(yb, 0, bsz);
        std::memset(q2, 0, QK_K / 4);

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / 16; ++ib) {
            const float *xb = xbl + 16 * ib;
            const float *qw = qw_row + QK_K * ibl + 16 * ib;
            for (int i = 0; i < 16; ++i)
                weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            for (int i = 0; i < 16; ++i) waux[i] = sqrtf(weight[i]);
            for (int k = 0; k < 2; ++k)
                block_signs[k] = fold_signs_even(xb + 8 * k, weight + 8 * k,
                                                 xval + 8 * k);
            float max = xval[0];
            for (int i = 1; i < 16; ++i) max = MAXF(max, xval[i]);
            if (!max) {
                scales[ib] = 0;
                std::memset(L, 0, 16);
                continue;
            }
            float best = 0;
            float scale = max / (2 * kMaxQ - 1);
            on_grid[0] = on_grid[1] = true;
            for (int is = -9; is <= 9; ++is) {
                float id = (2 * kMaxQ - 1 + is * 0.1f) / max;
                float this_scale = 1 / id;
                for (int k = 0; k < 2; ++k) {
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        Laux[8 * k + i] = (int8_t)MAXI(0, MINI(kMaxQ - 1, l));
                    }
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i)
                        u |= (uint16_t)(Laux[8 * k + i] << 2 * i);
                    int gi = gs.map[u];
                    on_grid_aux[k] = true;
                    if (gi < 0) {
                        on_grid_aux[k] = false;
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid8(gs, nb, xval + 8 * k, waux + 8 * k,
                                         this_scale, Laux + 8 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 16; ++i) {
                    float w = weight[i];
                    float q = 2 * Laux[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0 && sumqx * sumqx > best * sumq2) {
                    scale = sumqx / sumq2; best = scale * sumqx;
                    for (int i = 0; i < 16; ++i) L[i] = Laux[i];
                    for (int k = 0; k < 2; ++k) on_grid[k] = on_grid_aux[k];
                }
            }
            int n_off = 0;
            for (int k = 0; k < 2; ++k) if (!on_grid[k]) ++n_off;
            if (n_off > 0 && scale > 0) {
                float id = 1 / scale;
                for (int k = 0; k < 2; ++k) {
                    if (on_grid[k]) continue;
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        l = MAXI(0, MINI(kMaxQ - 1, l));
                        u |= (uint16_t)(l << 2 * i);
                        L[8 * k + i] = (int8_t)l;
                    }
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid8(gs, nb, xval + 8 * k, waux + 8 * k,
                                         scale, L + 8 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 16; ++i) {
                    float w = weight[i];
                    float q = 2 * L[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0) scale = sumqx / sumq2;
            }
            if (scale < 0) {
                scale = -scale;
                for (int k = 0; k < 2; ++k)
                    block_signs[k] = (uint8_t)((~block_signs[k]) & 127);
            }
            for (int k = 0; k < 2; ++k) {
                uint16_t u = 0;
                for (int i = 0; i < 8; ++i)
                    u |= (uint16_t)(L[8 * k + i] << 2 * i);
                int gi = gs.map[u];
                q2[2 * ib + k] = (uint16_t)(gi | (block_signs[k] << 9));
            }
            scales[ib] = scale;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 31;
        uint16_t dh = f32_to_f16(d);
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / 16; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib] - 1));
            l = MAXI(0, MINI(15, l));
            if (ib % 2 == 0) ysc[ib / 2] = (uint8_t)l;
            else ysc[ib / 2] |= (uint8_t)(l << 4);
        }
        std::memcpy(yb + 2, q2, QK_K / 4);
    }
}

// --------------------------------------------------------------- IQ2_S ----
// block: fp16 d + qs[QK_K/4] (32 idx + 32 signs) + qh[QK_K/32] + scales[QK_K/32]
static void enc_row_iq2_s(const float *x, uint8_t *out, int64_t n,
                          const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ2_S];
    const int kMaxQ = 3;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + QK_K / 4 + QK_K / 32 + QK_K / 32;

    float scales[QK_K / 16], weight[16], xval[16], waux[16];
    int8_t *L = s.L, *Laux = s.Laux;
    bool on_grid[2], on_grid_aux[2];
    uint8_t block_signs[2];

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        uint8_t *yqs = yb + 2;
        uint8_t *yqh = yb + 2 + QK_K / 4;
        uint8_t *ysc = yqh + QK_K / 32;

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = 2 * sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / 16; ++ib) {
            const float *xb = xbl + 16 * ib;
            if (qw_row) {
                const float *qw = qw_row + QK_K * ibl + 16 * ib;
                for (int i = 0; i < 16; ++i)
                    weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            } else {
                for (int i = 0; i < 16; ++i)
                    weight[i] = 0.25f * sigma2 + xb[i] * xb[i];
            }
            for (int i = 0; i < 16; ++i) waux[i] = sqrtf(weight[i]);
            for (int k = 0; k < 2; ++k) {      // no parity forcing (full signs)
                uint8_t s = 0;
                for (int i = 0; i < 8; ++i) {
                    if (xb[8 * k + i] >= 0) xval[8 * k + i] = xb[8 * k + i];
                    else { xval[8 * k + i] = -xb[8 * k + i]; s |= (uint8_t)(1 << i); }
                }
                block_signs[k] = s;
            }
            float max = xval[0];
            for (int i = 1; i < 16; ++i) max = MAXF(max, xval[i]);
            if (!max) {
                scales[ib] = 0;
                continue;
            }
            float best = 0;
            float scale = max / (2 * kMaxQ - 1);
            on_grid[0] = on_grid[1] = true;
            for (int is = -9; is <= 9; ++is) {
                float id = (2 * kMaxQ - 1 + is * 0.1f) / max;
                float this_scale = 1 / id;
                for (int k = 0; k < 2; ++k) {
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        Laux[8 * k + i] = (int8_t)MAXI(0, MINI(kMaxQ - 1, l));
                    }
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i)
                        u |= (uint16_t)(Laux[8 * k + i] << 2 * i);
                    int gi = gs.map[u];
                    on_grid_aux[k] = true;
                    if (gi < 0) {
                        on_grid_aux[k] = false;
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid8(gs, nb, xval + 8 * k, waux + 8 * k,
                                         this_scale, Laux + 8 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 16; ++i) {
                    float w = weight[i];
                    float q = 2 * Laux[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0 && sumqx * sumqx > best * sumq2) {
                    scale = sumqx / sumq2; best = scale * sumqx;
                    for (int i = 0; i < 16; ++i) L[i] = Laux[i];
                    for (int k = 0; k < 2; ++k) on_grid[k] = on_grid_aux[k];
                }
            }
            int n_off = 0;
            for (int k = 0; k < 2; ++k) if (!on_grid[k]) ++n_off;
            if (n_off > 0 && scale > 0) {
                float id = 1 / scale;
                for (int k = 0; k < 2; ++k) {
                    if (on_grid[k]) continue;
                    uint16_t u = 0;
                    for (int i = 0; i < 8; ++i) {
                        int l = nearest_int(0.5f * (id * xval[8 * k + i] - 1));
                        l = MAXI(0, MINI(kMaxQ - 1, l));
                        u |= (uint16_t)(l << 2 * i);
                        L[8 * k + i] = (int8_t)l;
                    }
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid8(gs, nb, xval + 8 * k, waux + 8 * k,
                                         scale, L + 8 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 16; ++i) {
                    float w = weight[i];
                    float q = 2 * L[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0) scale = sumqx / sumq2;
            }
            if (scale < 0) {
                scale = -scale;
                for (int k = 0; k < 2; ++k)
                    block_signs[k] = (uint8_t)(~block_signs[k]);
            }
            for (int k = 0; k < 2; ++k) {
                uint16_t u = 0;
                for (int i = 0; i < 8; ++i)
                    u |= (uint16_t)(L[8 * k + i] << 2 * i);
                int gi = gs.map[u];
                const int i8 = 2 * ib + k;
                yqs[i8] = (uint8_t)(gi & 255);
                yqh[i8 / 4] |= (uint8_t)(((unsigned)gi >> 8) << 2 * (i8 % 4));
                yqs[QK_K / 8 + i8] = block_signs[k];
            }
            scales[ib] = scale;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 31;
        uint16_t dh = f32_to_f16(d * 0.9875f);
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / 16; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib] - 1));
            l = MAXI(0, MINI(15, l));
            if (ib % 2 == 0) ysc[ib / 2] = (uint8_t)l;
            else ysc[ib / 2] |= (uint8_t)(l << 4);
        }
    }
}

// ---------------------------------------------------- IQ3_XXS / IQ3_S ------
// shared search over the D4-lattice codebook (quantize_row_iq3_xxs_impl,
// ggml-quants.c:13123; quantize_row_iq3_s_impl :13359)
static void enc_row_iq3_xxs(const float *x, uint8_t *out, int64_t n,
                            const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ3_256];
    const int kMaxQ = 8;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + 3 * QK_K / 8;          // 98

    float scales[QK_K / 32], weight[32], xval[32], waux[32];
    int8_t *L = s.L, *Laux = s.Laux;
    bool on_grid[8], on_grid_aux[8];
    uint8_t block_signs[8];
    uint8_t q3[3 * (QK_K / 8) + QK_K / 32];
    uint32_t *sas = (uint32_t *)(q3 + QK_K / 4);  // scales_and_signs

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        std::memset(q3, 0, sizeof(q3));

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = 2 * sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / 32; ++ib) {
            const float *xb = xbl + 32 * ib;
            if (qw_row) {
                const float *qw = qw_row + QK_K * ibl + 32 * ib;
                for (int i = 0; i < 32; ++i)
                    weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            } else {
                for (int i = 0; i < 32; ++i) weight[i] = xb[i] * xb[i];
            }
            for (int i = 0; i < 32; ++i) waux[i] = sqrtf(weight[i]);
            for (int k = 0; k < 4; ++k)
                block_signs[k] = fold_signs_even(xb + 8 * k, weight + 8 * k,
                                                 xval + 8 * k);
            float max = xval[0];
            for (int i = 1; i < 32; ++i) max = MAXF(max, xval[i]);
            if (!max) {
                scales[ib] = 0;
                std::memset(L, 0, 32);
                continue;
            }
            float best = 0;
            float scale = max / (2 * kMaxQ - 1);
            for (int is = -15; is <= 15; ++is) {
                float id = (2 * kMaxQ - 1 + is * 0.2f) / max;
                float this_scale = 1 / id;
                for (int k = 0; k < 8; ++k) {
                    for (int i = 0; i < 4; ++i) {
                        int l = nearest_int(0.5f * (id * xval[4 * k + i] - 1));
                        Laux[4 * k + i] = (int8_t)MAXI(0, MINI(kMaxQ - 1, l));
                    }
                    uint16_t u = 0;
                    for (int i = 0; i < 4; ++i)
                        u |= (uint16_t)(Laux[4 * k + i] << 3 * i);
                    int gi = gs.map[u];
                    on_grid_aux[k] = true;
                    if (gi < 0) {
                        on_grid_aux[k] = false;
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid4(gs, nb, xval + 4 * k, waux + 4 * k,
                                         this_scale, Laux + 4 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 32; ++i) {
                    float w = weight[i];
                    float q = 2 * Laux[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0 && sumqx * sumqx > best * sumq2) {
                    scale = sumqx / sumq2; best = scale * sumqx;
                    for (int i = 0; i < 32; ++i) L[i] = Laux[i];
                    for (int k = 0; k < 8; ++k) on_grid[k] = on_grid_aux[k];
                }
            }
            int n_off = 0;
            for (int k = 0; k < 8; ++k) if (!on_grid[k]) ++n_off;
            if (n_off > 0 && scale > 0) {
                float id = 1 / scale;
                for (int k = 0; k < 8; ++k) {
                    if (on_grid[k]) continue;
                    uint16_t u = 0;
                    for (int i = 0; i < 4; ++i) {
                        int l = nearest_int(0.5f * (id * xval[4 * k + i] - 1));
                        l = MAXI(0, MINI(kMaxQ - 1, l));
                        u |= (uint16_t)(l << 3 * i);
                    }
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        gi = nearest_on_grid4(gs, nb, xval + 4 * k,
                                              waux + 4 * k, scale, L + 4 * k);
                    }
                    const int8_t *pg = (const int8_t *)(gs.grid + gi);
                    for (int i = 0; i < 4; ++i)
                        L[4 * k + i] = (int8_t)((pg[i] - 1) / 2);
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < 32; ++i) {
                    float w = weight[i];
                    float q = 2 * L[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0) scale = sumqx / sumq2;
            }
            if (scale < 0) {
                scale = -scale;
                for (int k = 0; k < 4; ++k)
                    block_signs[k] = (uint8_t)((~block_signs[k]) & 127);
            }
            for (int k = 0; k < 8; ++k) {
                uint16_t u = 0;
                for (int i = 0; i < 4; ++i)
                    u |= (uint16_t)(L[4 * k + i] << 3 * i);
                int gi = gs.map[u];
                q3[8 * ib + k] = (uint8_t)gi;
            }
            sas[ib] = (uint32_t)block_signs[0] | ((uint32_t)block_signs[1] << 7)
                    | ((uint32_t)block_signs[2] << 14)
                    | ((uint32_t)block_signs[3] << 21);
            scales[ib] = scale;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 31;
        uint16_t dh = f32_to_f16(d * 1.0125f);    // reference fudge factor
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / 32; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib] - 1));
            l = MAXI(0, MINI(15, l));
            sas[ib] |= ((uint32_t)l << 28);
        }
        std::memcpy(yb + 2, q3, 3 * QK_K / 8);
    }
}

// IQ3_S block: fp16 d + qs[QK_K/4] + qh[QK_K/32] + signs[QK_K/8] + scales[QK_K/64]
static void enc_row_iq3_s(const float *x, uint8_t *out, int64_t n,
                          const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ3_512];
    const int kMaxQ = 8;
    const int block_size = 32;
    const int bs4 = block_size / 4, bs8 = block_size / 8;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + QK_K / 4 + QK_K / 32 + QK_K / 8 + QK_K / 64;

    float scales[QK_K / 32], weight[32], xval[32], waux[32];
    int8_t *L = s.L, *Laux = s.Laux;
    bool on_grid[8], on_grid_aux[8];
    uint8_t block_signs[4];

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        uint8_t *yqs = yb + 2;
        uint8_t *yqh = yb + 2 + QK_K / 4;
        uint8_t *ysigns = yqh + QK_K / 32;
        uint8_t *ysc = ysigns + QK_K / 8;
        uint8_t *qs = yqs;
        uint8_t *signs = ysigns;

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = 2 * sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / block_size; ++ib) {
            const float *xb = xbl + block_size * ib;
            if (qw_row) {
                const float *qw = qw_row + QK_K * ibl + block_size * ib;
                for (int i = 0; i < block_size; ++i)
                    weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            } else {
                for (int i = 0; i < block_size; ++i) weight[i] = xb[i] * xb[i];
            }
            for (int i = 0; i < block_size; ++i) waux[i] = sqrtf(weight[i]);
            for (int k = 0; k < bs8; ++k) {       // full signs, no parity
                uint8_t s = 0;
                for (int i = 0; i < 8; ++i) {
                    if (xb[8 * k + i] >= 0) xval[8 * k + i] = xb[8 * k + i];
                    else { xval[8 * k + i] = -xb[8 * k + i]; s |= (uint8_t)(1 << i); }
                }
                block_signs[k] = s;
            }
            float max = xval[0];
            for (int i = 1; i < block_size; ++i) max = MAXF(max, xval[i]);
            if (!max) {
                scales[ib] = 0;
                continue;
            }
            float best = 0;
            float scale = max / (2 * kMaxQ - 1);
            for (int k = 0; k < bs4; ++k) on_grid[k] = false;
            for (int is = -9; is <= 9; ++is) {
                float id = (2 * kMaxQ - 1 + is * 0.2f) / max;
                float this_scale = 1 / id;
                for (int k = 0; k < bs4; ++k) {
                    for (int i = 0; i < 4; ++i) {
                        int l = nearest_int(0.5f * (id * xval[4 * k + i] - 1));
                        Laux[4 * k + i] = (int8_t)MAXI(0, MINI(kMaxQ - 1, l));
                    }
                    uint16_t u = 0;
                    for (int i = 0; i < 4; ++i)
                        u |= (uint16_t)(Laux[4 * k + i] << 3 * i);
                    int gi = gs.map[u];
                    on_grid_aux[k] = true;
                    if (gi < 0) {
                        on_grid_aux[k] = false;
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        nearest_on_grid4(gs, nb, xval + 4 * k, waux + 4 * k,
                                         this_scale, Laux + 4 * k);
                    }
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < block_size; ++i) {
                    float w = weight[i];
                    float q = 2 * Laux[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0 && sumqx * sumqx > best * sumq2) {
                    scale = sumqx / sumq2; best = scale * sumqx;
                    for (int i = 0; i < block_size; ++i) L[i] = Laux[i];
                    for (int k = 0; k < bs4; ++k) on_grid[k] = on_grid_aux[k];
                }
            }
            int n_off = 0;
            for (int k = 0; k < bs4; ++k) if (!on_grid[k]) ++n_off;
            if (n_off > 0 && scale > 0) {
                float id = 1 / scale;
                for (int k = 0; k < bs4; ++k) {   // re-snap ALL groups (ref)
                    uint16_t u = 0;
                    for (int i = 0; i < 4; ++i) {
                        int l = nearest_int(0.5f * (id * xval[4 * k + i] - 1));
                        l = MAXI(0, MINI(kMaxQ - 1, l));
                        u |= (uint16_t)(l << 3 * i);
                    }
                    int gi = gs.map[u];
                    if (gi < 0) {
                        const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                        gi = nearest_on_grid4(gs, nb, xval + 4 * k,
                                              waux + 4 * k, scale, L + 4 * k);
                    }
                    const int8_t *pg = (const int8_t *)(gs.grid + gi);
                    for (int i = 0; i < 4; ++i)
                        L[4 * k + i] = (int8_t)((pg[i] - 1) / 2);
                }
                float sumqx = 0, sumq2 = 0;
                for (int i = 0; i < block_size; ++i) {
                    float w = weight[i];
                    float q = 2 * L[i] + 1;
                    sumqx += w * xval[i] * q;
                    sumq2 += w * q * q;
                }
                if (sumq2 > 0) scale = sumqx / sumq2;
            }
            if (scale < 0) {
                scale = -scale;
                for (int k = 0; k < bs8; ++k)
                    block_signs[k] = (uint8_t)(~block_signs[k]);
            }
            for (int k = 0; k < bs4; ++k) {
                uint16_t u = 0;
                for (int i = 0; i < 4; ++i)
                    u |= (uint16_t)(L[4 * k + i] << 3 * i);
                int gi = gs.map[u];
                qs[k] = (uint8_t)(gi & 255);
                yqh[(ib * bs4 + k) / 8] |=
                    (uint8_t)(((unsigned)gi >> 8) << ((ib * bs4 + k) % 8));
            }
            qs += bs4;
            for (int k = 0; k < bs8; ++k) signs[k] = block_signs[k];
            signs += bs8;
            scales[ib] = scale;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 31;
        uint16_t dh = f32_to_f16(d * 1.033f);     // reference fudge factor
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / block_size; ib += 2) {
            int l1 = nearest_int(0.5f * (id * scales[ib + 0] - 1));
            l1 = MAXI(0, MINI(15, l1));
            int l2 = nearest_int(0.5f * (id * scales[ib + 1] - 1));
            l2 = MAXI(0, MINI(15, l2));
            ysc[ib / 2] = (uint8_t)(l1 | (l2 << 4));
        }
    }
}

// ------------------------------------------------------- IQ1_S / IQ1_M ----
#define IQ1S_DELTA 0.125f
#define IQ1M_DELTA 0.125f
#define IQ1S_BLOCK 32
#define IQ1M_BLOCK 16

static int cmp_float_pair(const void *a, const void *b) {
    const float *l = (const float *)a;
    const float *r = (const float *)b;
    return *l < *r ? -1 : *l > *r ? 1 : 0;
}

// iq1_find_best_neighbour2 (ggml-quants.c:13638): weighted nearest under the
// shifted ternary values xg, falling back to a full-grid scan
static int iq1_nearest2(const GridSet &gs, const uint16_t *nb,
                        const float *xval, const float *weight, float scale,
                        const float *xg, int8_t *L) {
    int num = nb[0];
    float best = FLT_MAX;
    int gi = -1;
    for (int j = 1; j <= num; ++j) {
        const int8_t *pg = (const int8_t *)(gs.grid + nb[j]);
        float d2 = 0;
        for (int i = 0; i < 8; ++i) {
            float q = xg[(pg[i] - 1) / 2];
            float diff = scale * q - xval[i];
            d2 += weight[i] * diff * diff;
        }
        if (d2 < best) { best = d2; gi = nb[j]; }
    }
    if (gi < 0) {
        for (int i = 0; i < gs.n; ++i) {
            const int8_t *pg = (const int8_t *)(gs.grid + i);
            float d2 = 0;
            for (int j = 0; j < 8; ++j) {
                float q = xg[(pg[j] - 1) / 2];
                float diff = scale * q - xval[i];   // ref indexes xval[i] here
                d2 += weight[j] * diff * diff;
            }
            if (d2 < best) { best = d2; gi = i; }
        }
    }
    const int8_t *pg = (const int8_t *)(gs.grid + gi);
    for (int i = 0; i < 8; ++i) L[i] = (int8_t)((pg[i] - 1) / 2);
    return gi;
}

// block_iq1_s: fp16 d + qs[QK_K/8] + uint16 qh[QK_K/32]  (50 bytes)
static void enc_row_iq1_s(const float *x, uint8_t *out, int64_t n,
                          const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ1];
    const int block_size = IQ1S_BLOCK;
    const int64_t nbl = n / QK_K;
    const size_t bsz = 2 + QK_K / 8 + QK_K / 16;

    const float x_p[3] = {-1 + IQ1S_DELTA,  IQ1S_DELTA, 1 + IQ1S_DELTA};
    const float x_m[3] = {-1 - IQ1S_DELTA, -IQ1S_DELTA, 1 - IQ1S_DELTA};

    float scales[QK_K / IQ1S_BLOCK], weight[IQ1S_BLOCK];
    float sumx[IQ1S_BLOCK + 1], sumw[IQ1S_BLOCK + 1];
    float pairs[2 * IQ1S_BLOCK];
    int8_t *L = s.L, *shifts = s.shifts;
    uint16_t index[IQ1S_BLOCK / 8];
    int *idx = (int *)(pairs + 1);

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        uint8_t *yqs = yb + 2;
        uint16_t *yqh = (uint16_t *)(yb + 2 + QK_K / 8);

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = 2 * sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / block_size; ++ib) {
            const float *xb = xbl + block_size * ib;
            const float *qw = qw_row + QK_K * ibl + block_size * ib;
            for (int i = 0; i < block_size; ++i)
                weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            float max = fabsf(xb[0]);
            for (int i = 1; i < block_size; ++i) max = MAXF(max, fabsf(xb[i]));
            if (!max) {
                scales[ib] = 0;
                std::memset(L, 1, block_size);
                continue;
            }
            // exhaustive 3-way split over the sorted block (the exact
            // weighted-SSD solution for a ternary alphabet)
            for (int j = 0; j < block_size; ++j) {
                pairs[2 * j] = xb[j];
                idx[2 * j] = j;
            }
            qsort(pairs, block_size, 2 * sizeof(float), cmp_float_pair);
            sumx[0] = sumw[0] = 0;
            for (int j = 0; j < block_size; ++j) {
                int i = idx[2 * j];
                sumx[j + 1] = sumx[j] + weight[i] * xb[i];
                sumw[j + 1] = sumw[j] + weight[i];
            }
            float best_score = 0, scale = max;
            int besti1 = -1, besti2 = -1, best_shift = 0;
            for (int i1 = 0; i1 <= block_size; ++i1) {
                for (int i2 = i1; i2 <= block_size; ++i2) {
                    float sumqx = (sumx[i1] - sumx[0]) * x_p[0]
                                + (sumx[i2] - sumx[i1]) * x_p[1]
                                + (sumx[block_size] - sumx[i2]) * x_p[2];
                    float sumq2 = (sumw[i1] - sumw[0]) * x_p[0] * x_p[0]
                                + (sumw[i2] - sumw[i1]) * x_p[1] * x_p[1]
                                + (sumw[block_size] - sumw[i2]) * x_p[2] * x_p[2];
                    if (sumq2 > 0 && sumqx * sumqx > best_score * sumq2) {
                        scale = sumqx / sumq2; best_score = scale * sumqx;
                        besti1 = i1; besti2 = i2; best_shift = 1;
                    }
                    sumqx = (sumx[i1] - sumx[0]) * x_m[0]
                          + (sumx[i2] - sumx[i1]) * x_m[1]
                          + (sumx[block_size] - sumx[i2]) * x_m[2];
                    sumq2 = (sumw[i1] - sumw[0]) * x_m[0] * x_m[0]
                          + (sumw[i2] - sumw[i1]) * x_m[1] * x_m[1]
                          + (sumw[block_size] - sumw[i2]) * x_m[2] * x_m[2];
                    if (sumq2 > 0 && sumqx * sumqx > best_score * sumq2) {
                        scale = sumqx / sumq2; best_score = scale * sumqx;
                        besti1 = i1; besti2 = i2; best_shift = -1;
                    }
                }
            }
            if (besti1 < 0) {
                // no split scored (every weight 0; the reference asserts
                // here): the all-zero sub-block's path
                scales[ib] = 0;
                std::memset(L, 1, block_size);
                continue;
            }
            for (int j = 0; j < besti1; ++j) L[idx[2 * j]] = 0;
            for (int j = besti1; j < besti2; ++j) L[idx[2 * j]] = 1;
            for (int j = besti2; j < block_size; ++j) L[idx[2 * j]] = 2;
            if (scale < 0) {
                for (int j = 0; j < block_size; ++j) L[j] = (int8_t)(2 - L[j]);
                scale = -scale; best_shift = -best_shift;
            }
            bool all_on_grid = true;
            const float *xx = best_shift == 1 ? x_p : x_m;
            for (int k = 0; k < block_size / 8; ++k) {
                uint16_t u = 0;
                for (int j = 0; j < 8; ++j)
                    u |= (uint16_t)(L[8 * k + j] << 2 * j);
                int gi = gs.map[u];
                if (gi < 0) {
                    all_on_grid = false;
                    const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                    gi = iq1_nearest2(gs, nb, xb + 8 * k, weight + 8 * k,
                                      scale, xx, L + 8 * k);
                }
                index[k] = (uint16_t)gi;
            }
            if (!all_on_grid) {
                float sumqx = 0, sumq2 = 0;
                for (int k = 0; k < block_size / 8; ++k) {
                    const int8_t *pg = (const int8_t *)(gs.grid + index[k]);
                    for (int j = 0; j < 8; ++j) {
                        float w = weight[8 * k + j];
                        float q = xx[(pg[j] - 1) / 2];
                        sumqx += w * q * xb[8 * k + j];
                        sumq2 += w * q * q;
                    }
                }
                if (sumqx > 0 && sumq2 > 0) scale = sumqx / sumq2;
            }
            uint16_t h = 0;
            for (int k = 0; k < block_size / 8; ++k) {
                yqs[(block_size / 8) * ib + k] = (uint8_t)(index[k] & 255);
                h |= (uint16_t)((index[k] >> 8) << 3 * k);
            }
            yqh[ib] = h;
            scales[ib] = scale;
            shifts[ib] = (int8_t)best_shift;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 15;
        uint16_t dh = f32_to_f16(d * 1.125f);     // reference fudge factor
        std::memcpy(yb, &dh, 2);
        float id = 1 / d;
        for (int ib = 0; ib < QK_K / block_size; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib] - 1));
            l = MAXI(0, MINI(7, l));
            if (shifts[ib] == -1) l |= 8;
            yqh[ib] |= (uint16_t)(l << 12);
        }
    }
}

// block_iq1_m: qs[QK_K/8] + qh[QK_K/16] + scales[QK_K/32]  (56 bytes, fp16
// super-scale nibble-packed into scales — ggml-common.h block_iq1_m)
static void enc_row_iq1_m(const float *x, uint8_t *out, int64_t n,
                          const float *qw_row, RowScratch &s) {
    const GridSet &gs = g_sets[GS_IQ1];
    const int block_size = IQ1M_BLOCK;
    const int64_t nbl = n / QK_K;
    const size_t bsz = QK_K / 8 + QK_K / 16 + QK_K / 32;

    const float x_p[3] = {-1 + IQ1M_DELTA,  IQ1M_DELTA, 1 + IQ1M_DELTA};
    const float x_m[3] = {-1 - IQ1M_DELTA, -IQ1M_DELTA, 1 - IQ1M_DELTA};
    const uint8_t masks[4] = {0x00, 0x80, 0x08, 0x88};

    float scales[QK_K / IQ1M_BLOCK], weight[IQ1M_BLOCK];
    float pairs[2 * IQ1M_BLOCK];
    int8_t *L = s.L, *shifts = s.shifts;
    uint16_t index[IQ1M_BLOCK / 8];
    int *idx = (int *)(pairs + 1);
    float sumqx[4], sumq2[4];
    const float *xx;

    for (int64_t ibl = 0; ibl < nbl; ++ibl) {
        uint8_t *yb = out + ibl * bsz;
        std::memset(yb, 0, bsz);
        uint8_t *yqs = yb;
        uint8_t *yqh = yb + QK_K / 8;
        uint16_t *sc = (uint16_t *)(yqh + QK_K / 16);

        float max_scale = 0;
        const float *xbl = x + QK_K * ibl;
        float sumx2 = 0;
        for (int i = 0; i < QK_K; ++i) sumx2 += xbl[i] * xbl[i];
        float sigma2 = 2 * sumx2 / QK_K;

        for (int ib = 0; ib < QK_K / block_size; ++ib) {
            const float *xb = xbl + block_size * ib;
            if (qw_row) {
                const float *qw = qw_row + QK_K * ibl + block_size * ib;
                for (int i = 0; i < block_size; ++i)
                    weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            } else {
                for (int i = 0; i < block_size; ++i) weight[i] = xb[i] * xb[i];
            }
            float max = fabsf(xb[0]);
            for (int i = 1; i < block_size; ++i) max = MAXF(max, fabsf(xb[i]));
            if (!max) {
                scales[ib] = 0;
                std::memset(L, 1, block_size);
                continue;
            }
            for (int j = 0; j < block_size; ++j) {
                pairs[2 * j] = xb[j];
                idx[2 * j] = j;
            }
            qsort(pairs, block_size, 2 * sizeof(float), cmp_float_pair);
            float best_score = 0, scale = max;
            int besti1 = -1, besti2 = -1, best_k = -1;
            // the two block halves can take opposite delta shifts:
            // k = 0: (+,+)  1: (+,-)  2: (-,+)  3: (-,-)
            for (int i1 = 0; i1 <= block_size; ++i1) {
                for (int i2 = i1; i2 <= block_size; ++i2) {
                    std::memset(sumqx, 0, sizeof(sumqx));
                    std::memset(sumq2, 0, sizeof(sumq2));
                    for (int j = 0; j < i1; ++j) {
                        int i = idx[2 * j];
                        int half = i < block_size / 2 ? 0 : 1;
                        float wx = weight[i] * xb[i];
                        float w = weight[i];
                        if (half == 0) {
                            sumqx[0] += wx * x_p[0]; sumqx[1] += wx * x_p[0];
                            sumqx[2] += wx * x_m[0]; sumqx[3] += wx * x_m[0];
                            sumq2[0] += w * x_p[0] * x_p[0]; sumq2[1] += w * x_p[0] * x_p[0];
                            sumq2[2] += w * x_m[0] * x_m[0]; sumq2[3] += w * x_m[0] * x_m[0];
                        } else {
                            sumqx[0] += wx * x_p[0]; sumqx[2] += wx * x_p[0];
                            sumqx[1] += wx * x_m[0]; sumqx[3] += wx * x_m[0];
                            sumq2[0] += w * x_p[0] * x_p[0]; sumq2[2] += w * x_p[0] * x_p[0];
                            sumq2[1] += w * x_m[0] * x_m[0]; sumq2[3] += w * x_m[0] * x_m[0];
                        }
                    }
                    for (int j = i1; j < i2; ++j) {
                        int i = idx[2 * j];
                        int half = i < block_size / 2 ? 0 : 1;
                        float wx = weight[i] * xb[i];
                        float w = weight[i];
                        if (half == 0) {
                            sumqx[0] += wx * x_p[1]; sumqx[1] += wx * x_p[1];
                            sumqx[2] += wx * x_m[1]; sumqx[3] += wx * x_m[1];
                            sumq2[0] += w * x_p[1] * x_p[1]; sumq2[1] += w * x_p[1] * x_p[1];
                            sumq2[2] += w * x_m[1] * x_m[1]; sumq2[3] += w * x_m[1] * x_m[1];
                        } else {
                            sumqx[0] += wx * x_p[1]; sumqx[2] += wx * x_p[1];
                            sumqx[1] += wx * x_m[1]; sumqx[3] += wx * x_m[1];
                            sumq2[0] += w * x_p[1] * x_p[1]; sumq2[2] += w * x_p[1] * x_p[1];
                            sumq2[1] += w * x_m[1] * x_m[1]; sumq2[3] += w * x_m[1] * x_m[1];
                        }
                    }
                    for (int j = i2; j < block_size; ++j) {
                        int i = idx[2 * j];
                        int half = i < block_size / 2 ? 0 : 1;
                        float wx = weight[i] * xb[i];
                        float w = weight[i];
                        if (half == 0) {
                            sumqx[0] += wx * x_p[2]; sumqx[1] += wx * x_p[2];
                            sumqx[2] += wx * x_m[2]; sumqx[3] += wx * x_m[2];
                            sumq2[0] += w * x_p[2] * x_p[2]; sumq2[1] += w * x_p[2] * x_p[2];
                            sumq2[2] += w * x_m[2] * x_m[2]; sumq2[3] += w * x_m[2] * x_m[2];
                        } else {
                            sumqx[0] += wx * x_p[2]; sumqx[2] += wx * x_p[2];
                            sumqx[1] += wx * x_m[2]; sumqx[3] += wx * x_m[2];
                            sumq2[0] += w * x_p[2] * x_p[2]; sumq2[2] += w * x_p[2] * x_p[2];
                            sumq2[1] += w * x_m[2] * x_m[2]; sumq2[3] += w * x_m[2] * x_m[2];
                        }
                    }
                    for (int k = 0; k < 4; ++k) {
                        if (sumq2[k] > 0 &&
                            sumqx[k] * sumqx[k] > best_score * sumq2[k]) {
                            scale = sumqx[k] / sumq2[k];
                            best_score = scale * sumqx[k];
                            besti1 = i1; besti2 = i2; best_k = k;
                        }
                    }
                }
            }
            if (besti1 < 0) {
                // no split scored (every weight 0; the reference asserts
                // here): the all-zero sub-block's path
                scales[ib] = 0;
                std::memset(L, 1, block_size);
                continue;
            }
            for (int j = 0; j < besti1; ++j) L[idx[2 * j]] = 0;
            for (int j = besti1; j < besti2; ++j) L[idx[2 * j]] = 1;
            for (int j = besti2; j < block_size; ++j) L[idx[2 * j]] = 2;
            if (scale < 0) {
                for (int j = 0; j < block_size; ++j) L[j] = (int8_t)(2 - L[j]);
                scale = -scale;
                best_k = best_k == 0 ? 3 : best_k == 1 ? 2 :
                         best_k == 2 ? 1 : 0;
            }
            bool all_on_grid = true;
            for (int k = 0; k < block_size / 8; ++k) {
                if (k == 0) xx = best_k < 2 ? x_p : x_m;
                else xx = best_k % 2 == 0 ? x_p : x_m;
                uint16_t u = 0;
                for (int j = 0; j < 8; ++j)
                    u |= (uint16_t)(L[8 * k + j] << 2 * j);
                int gi = gs.map[u];
                if (gi < 0) {
                    all_on_grid = false;
                    const uint16_t *nb = gs.neigh - gs.map[u] - 1;
                    gi = iq1_nearest2(gs, nb, xb + 8 * k, weight + 8 * k,
                                      scale, xx, L + 8 * k);
                }
                index[k] = (uint16_t)gi;
            }
            if (!all_on_grid) {
                float sumqx_f = 0, sumq2_f = 0;
                for (int k = 0; k < block_size / 8; ++k) {
                    if (k == 0) xx = best_k < 2 ? x_p : x_m;
                    else xx = best_k % 2 == 0 ? x_p : x_m;
                    const int8_t *pg = (const int8_t *)(gs.grid + index[k]);
                    for (int j = 0; j < 8; ++j) {
                        float w = weight[8 * k + j];
                        float q = xx[(pg[j] - 1) / 2];
                        sumqx_f += w * q * xb[8 * k + j];
                        sumq2_f += w * q * q;
                    }
                }
                if (sumqx_f > 0 && sumq2_f > 0) scale = sumqx_f / sumq2_f;
            }
            yqs[2 * ib + 0] = (uint8_t)(index[0] & 255);
            yqs[2 * ib + 1] = (uint8_t)(index[1] & 255);
            yqh[ib] = (uint8_t)((index[0] >> 8) | ((index[1] >> 8) << 4));
            scales[ib] = scale;
            shifts[ib] = (int8_t)best_k;
            max_scale = MAXF(max_scale, scale);
        }

        if (!max_scale) continue;

        float d = max_scale / 15;
        float id = 1 / d;
        float sumqx_f = 0, sumq2_f = 0;
        for (int ib = 0; ib < QK_K / block_size; ++ib) {
            int l = nearest_int(0.5f * (id * scales[ib + 0] - 1));
            l = MAXI(0, MINI(7, l));
            sc[ib / 4] |= (uint16_t)(l << 3 * (ib % 4));
            yqh[ib] |= masks[shifts[ib]];
            const float *xb = xbl + block_size * ib;
            if (qw_row) {
                const float *qw = qw_row + QK_K * ibl + block_size * ib;
                for (int i = 0; i < block_size; ++i)
                    weight[i] = qw[i] * sqrtf(sigma2 + xb[i] * xb[i]);
            } else {
                for (int i = 0; i < block_size; ++i) weight[i] = xb[i] * xb[i];
            }
            for (int k = 0; k < block_size / 8; ++k) {
                if (k == 0) xx = shifts[ib] < 2 ? x_p : x_m;
                else xx = shifts[ib] % 2 == 0 ? x_p : x_m;
                const int8_t *pg = (const int8_t *)(gs.grid + yqs[2 * ib + k]
                    + ((yqh[ib] << (8 - 4 * k)) & 0x700));
                for (int j = 0; j < 8; ++j) {
                    float w = weight[8 * k + j];
                    float q = xx[(pg[j] - 1) / 2] * (2 * l + 1);
                    sumqx_f += w * q * xb[8 * k + j];
                    sumq2_f += w * q * q;
                }
            }
        }
        if (sumq2_f > 0) d = sumqx_f / sumq2_f;
        uint16_t dh = f32_to_f16(d * 1.1125f);    // reference fudge factor
        sc[0] |= (uint16_t)((dh & 0x000f) << 12);
        sc[1] |= (uint16_t)((dh & 0x00f0) << 8);
        sc[2] |= (uint16_t)((dh & 0x0f00) << 4);
        sc[3] |= (uint16_t)((dh & 0xf000) << 0);
    }
}

// ------------------------------------------------------------ entry API ----
#define ROW_LOOP(fn, bsz_per_k)                                               \
    RowScratch scratch{};                                                     \
    for (int64_t row = 0; row < nrow; ++row) {                                \
        fn(x + row * n_per_row, out + row * (n_per_row / QK_K) * (bsz_per_k), \
           n_per_row, qw, scratch);                                           \
    }

API void iq2_xxs_quantize(const float *x, uint8_t *out, int64_t nrow,
                          int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq2_xxs, 2 + QK_K / 4)
}
API void iq2_xs_quantize(const float *x, uint8_t *out, int64_t nrow,
                         int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq2_xs, 2 + QK_K / 4 + QK_K / 32)
}
API void iq2_s_quantize(const float *x, uint8_t *out, int64_t nrow,
                        int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq2_s, 2 + QK_K / 4 + QK_K / 16)
}
API void iq3_xxs_quantize(const float *x, uint8_t *out, int64_t nrow,
                          int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq3_xxs, 2 + 3 * QK_K / 8)
}
API void iq3_s_quantize(const float *x, uint8_t *out, int64_t nrow,
                        int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq3_s, 2 + QK_K / 4 + QK_K / 32 + QK_K / 8 + QK_K / 64)
}
API void iq1_s_quantize(const float *x, uint8_t *out, int64_t nrow,
                        int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq1_s, 2 + QK_K / 8 + QK_K / 16)
}
API void iq1_m_quantize(const float *x, uint8_t *out, int64_t nrow,
                        int64_t n_per_row, const float *qw) {
    ROW_LOOP(enc_row_iq1_m, QK_K / 8 + QK_K / 16 + QK_K / 32)
}

API int iq_abi_version(void) { return 1; }
