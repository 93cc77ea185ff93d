/* CABAC slice encoder — native hot loop (ITU-T H.264 §9.3).
 *
 * C port of x264vfw_tpu/bitstream/cabac_slice.py (the behavioural golden
 * model): encodes a whole P or I slice from the encoder's packed syntax
 * arrays in one call.  Output must be byte-identical to the Python writer —
 * tests/test_cabac.py asserts this on random syntax, and the Python writer
 * itself is validated against stock FFmpeg decode of real streams.
 *
 * Role in the architecture (SURVEY §7): the host finalization stage fed by
 * TPU-resident syntax tensors; native because the per-bin loop is the one
 * part of the codec that is inherently serial (the reference's equivalent
 * lives in libx264's assembly-tuned CABAC engine).
 *
 * Build: gcc -O2 -shared -fPIC cabac_ext.c -o libcabac.so
 */

#include <stdint.h>
#include <string.h>
#include "cabac_tables.h"

typedef struct {
    uint8_t state[1024];
    uint8_t mps[1024];
    uint32_t low;
    int32_t range;
    int32_t bits_outstanding;
    int first_bit;
    uint8_t *out;
    long cap;
    long nbits;     /* bits written so far (logical, incl. pending) */
    int overflow;
    uint64_t acc;   /* pending output bits, LSB-aligned (newest in low bits) */
    int nacc;       /* number of valid bits in acc, < 8 between calls */
    long pos;       /* bytes flushed to out */
} Cabac;

/* Byte-buffered bit output: bits accumulate in a 64-bit word and flush as
 * whole bytes.  Semantically identical to writing one bit at a time into a
 * zeroed buffer (the bitstream is unchanged); ~an order of magnitude less
 * work per bin than per-bit shifts into memory. */
static inline void put_bits(Cabac *c, uint64_t val, int n)
{
    c->acc = (c->acc << n) | val;
    c->nacc += n;
    c->nbits += n;
    while (c->nacc >= 8) {
        if (c->pos >= c->cap) { c->overflow = 1; c->pos = c->cap; c->nacc = 0; return; }
        c->out[c->pos++] = (uint8_t)(c->acc >> (c->nacc - 8));
        c->nacc -= 8;
    }
}

static inline void put_raw(Cabac *c, int b)
{
    put_bits(c, (uint64_t)b, 1);
}

static void flush_final(Cabac *c)
{
    /* pad the last partial byte with zeros (not counted in nbits) */
    if (c->nacc > 0) {
        if (c->pos >= c->cap) { c->overflow = 1; return; }
        c->out[c->pos++] = (uint8_t)(c->acc << (8 - c->nacc));
        c->nacc = 0;
    }
}

static void put_bit(Cabac *c, int b)
{
    /* PutBit(b) per §9.3.4.3: emit b (dropped if firstBitFlag), then
     * bits_outstanding copies of !b — a single bit-field write:
     * b=1 -> 1 followed by k zeros = 1<<k; b=0 -> 0 followed by k ones =
     * (1<<k)-1, both of width k+1. */
    long k = c->bits_outstanding;
    c->bits_outstanding = 0;
    if (c->first_bit) {
        c->first_bit = 0;
        while (k > 0) {
            int ch = k > 32 ? 32 : (int)k;
            put_bits(c, b ? 0 : ((1ULL << ch) - 1), ch);
            k -= ch;
        }
        return;
    }
    if (k <= 47) {
        put_bits(c, b ? (1ULL << k) : ((1ULL << k) - 1), (int)k + 1);
    } else {
        put_bits(c, (uint64_t)(b != 0), 1);
        while (k > 0) {
            int ch = k > 32 ? 32 : (int)k;
            put_bits(c, b ? 0 : ((1ULL << ch) - 1), ch);
            k -= ch;
        }
    }
}

static void renorm(Cabac *c)
{
    while (c->range < 256) {
        if (c->low >= 512) {
            put_bit(c, 1);
            c->low -= 512;
        } else if (c->low < 256) {
            put_bit(c, 0);
        } else {
            c->low -= 256;
            c->bits_outstanding++;
        }
        c->range <<= 1;
        c->low <<= 1;
    }
}

static void decision(Cabac *c, int ctx, int binval)
{
    int s = c->state[ctx];
    int rlps = RANGE_LPS[(s << 2) | ((c->range >> 6) & 3)];
    c->range -= rlps;
    if (binval != c->mps[ctx]) {
        c->low += (uint32_t)c->range;
        c->range = rlps;
        if (s == 0)
            c->mps[ctx] ^= 1;
        c->state[ctx] = TRANS_LPS[s];
    } else {
        c->state[ctx] = TRANS_MPS[s];
    }
    renorm(c);
}

static void bypass(Cabac *c, int binval)
{
    c->low <<= 1;
    if (binval)
        c->low += (uint32_t)c->range;
    if (c->low >= 1024) {
        put_bit(c, 1);
        c->low -= 1024;
    } else if (c->low < 512) {
        put_bit(c, 0);
    } else {
        c->low -= 512;
        c->bits_outstanding++;
    }
}

static void terminate(Cabac *c, int binval)
{
    c->range -= 2;
    if (binval) {
        c->low += (uint32_t)c->range;
        c->range = 2;
        renorm(c);
        put_bit(c, (c->low >> 9) & 1);
        put_raw(c, (c->low >> 8) & 1);
        put_raw(c, 1);
    } else {
        renorm(c);
    }
}

static void cabac_init(Cabac *c, int intra, int qp, int init_idc,
                       uint8_t *out, long cap)
{
    const int8_t *t = intra ? CTX_INIT_I : (CTX_INIT_PB + init_idc * 2048);
    int q = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
    for (int i = 0; i < 1024; i++) {
        int m = t[2 * i], n = t[2 * i + 1];
        int pre = ((m * q) >> 4) + n;
        if (pre < 1) pre = 1;
        if (pre > 126) pre = 126;
        if (pre <= 63) { c->state[i] = (uint8_t)(63 - pre); c->mps[i] = 0; }
        else           { c->state[i] = (uint8_t)(pre - 64); c->mps[i] = 1; }
    }
    c->low = 0;
    c->range = 510;
    c->bits_outstanding = 0;
    c->first_bit = 1;
    c->out = out;
    c->cap = cap;
    c->nbits = 0;
    c->overflow = 0;
    c->acc = 0;
    c->nacc = 0;
    c->pos = 0;
}

/* ---------------- binarizations ---------------- */

static void ueg(Cabac *c, const int *ctxs, int nctx, int k, int ucoff,
                int value, int signedval)
{
    int mag = value < 0 ? -value : value;
    int prefix = mag < ucoff ? mag : ucoff;
    for (int i = 0; i < prefix; i++)
        decision(c, ctxs[i < nctx - 1 ? i : nctx - 1], 1);
    if (prefix < ucoff) {
        decision(c, ctxs[prefix < nctx - 1 ? prefix : nctx - 1], 0);
    } else {
        int suf = mag - ucoff, kk = k;
        while (suf >= (1 << kk)) {
            bypass(c, 1);
            suf -= 1 << kk;
            kk++;
        }
        bypass(c, 0);
        for (int i = kk - 1; i >= 0; i--)
            bypass(c, (suf >> i) & 1);
    }
    if (signedval && mag)
        bypass(c, value < 0 ? 1 : 0);
}

/* per-slice neighbor maps (static scratch; single-threaded use) */
#define MAXMB_W 512
#define MAXMB_H 512
typedef struct {
    int mbh, mbw;
    uint8_t skip[MAXMB_H * MAXMB_W];
    uint8_t direct[MAXMB_H * MAXMB_W];
    int32_t cbp_l[MAXMB_H * MAXMB_W];
    int32_t cbp_c[MAXMB_H * MAXMB_W];
    /* mvd/ref neighbour maps live on the 8x8 partition grid
     * (2*mbh x 2*mbw): the mvd ctxIdxInc (9.3.3.1.1.7) and the
     * ref_idx ctxIdxInc (9.3.3.1.1.6) read the PARTITION covering
     * the neighbouring 4x4 block; partitions here are 8x8-aligned */
    int32_t mvdx[4 * MAXMB_H * MAXMB_W];
    int32_t mvdy[4 * MAXMB_H * MAXMB_W];
    int32_t mvd1x[4 * MAXMB_H * MAXMB_W];
    int32_t mvd1y[4 * MAXMB_H * MAXMB_W];
    int32_t ref8[4 * MAXMB_H * MAXMB_W];
    uint8_t cbf4[4 * MAXMB_H * 4 * MAXMB_W];
    uint8_t cbf_dc[MAXMB_H * MAXMB_W];
    uint8_t is_i16[MAXMB_H * MAXMB_W];
    uint8_t is_inxn[MAXMB_H * MAXMB_W];
    uint8_t cbf_cdc[MAXMB_H * MAXMB_W * 2];
    uint8_t t8m[MAXMB_H * MAXMB_W];
    uint8_t cbf_cac[2 * MAXMB_H * 2 * MAXMB_W * 2];
    int32_t cmode[MAXMB_H * MAXMB_W];
} Maps;

static _Thread_local Maps g_maps;

/* clear only the region a slice actually uses (the static arrays are sized
 * for MAXMB; zeroing all of them is ~14 MB of memset per call) */
static void maps_clear(Maps *m, int mbh, int mbw)
{
    long n = (long)mbh * mbw;
    m->mbh = mbh;
    m->mbw = mbw;
    memset(m->skip, 0, (size_t)n);
    memset(m->direct, 0, (size_t)n);
    memset(m->cbp_l, 0, (size_t)n * sizeof(int32_t));
    memset(m->cbp_c, 0, (size_t)n * sizeof(int32_t));
    memset(m->mvdx, 0, (size_t)(4 * n) * sizeof(int32_t));
    memset(m->mvdy, 0, (size_t)(4 * n) * sizeof(int32_t));
    memset(m->mvd1x, 0, (size_t)(4 * n) * sizeof(int32_t));
    memset(m->mvd1y, 0, (size_t)(4 * n) * sizeof(int32_t));
    memset(m->ref8, 0, (size_t)(4 * n) * sizeof(int32_t));
    memset(m->cbf4, 0, (size_t)(16 * n));
    memset(m->cbf_dc, 0, (size_t)n);
    memset(m->is_i16, 0, (size_t)n);
    memset(m->is_inxn, 0, (size_t)n);
    memset(m->cbf_cdc, 0, (size_t)(2 * n));
    memset(m->t8m, 0, (size_t)n);
    memset(m->cbf_cac, 0, (size_t)(8 * n));
    memset(m->cmode, 0, (size_t)n * sizeof(int32_t));
}

/* block coding order -> raster within MB */
static const int BLKX[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLKY[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};

static const int CBF_OFF[5] = {0, 4, 8, 12, 16};
static const int SIG_OFF[5] = {0, 15, 29, 44, 47};
static const int ABS_OFF[5] = {0, 10, 20, 30, 39};

/* cat-5 (luma 8x8) position->ctx maps, frame-coded (Table 9-43):
 * significant at 402 + map, last at 417 + map, abs at 426; no cbf
 * (mirrors bitstream/cabac_slice.py SIG8_MAP/LAST8_MAP) */
static const uint8_t SIG8C[63] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12};
static const uint8_t LAST8C[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};

static int residual(Cabac *c, int cat, int cbf_inc, const int32_t *coeffs,
                    int n)
{
    int last = -1;
    for (int i = 0; i < n; i++)
        if (coeffs[i])
            last = i;
    if (cat == 5) {
        if (last < 0)
            return 0;              /* caller guarantees cbp bit => nz */
    } else {
        decision(c, 85 + CBF_OFF[cat] + cbf_inc, last >= 0);
        if (last < 0)
            return 0;
    }
    for (int i = 0; i < n - 1; i++) {
        decision(c, cat == 5 ? 402 + SIG8C[i] : 105 + SIG_OFF[cat] + i,
                 coeffs[i] != 0);
        if (coeffs[i]) {
            decision(c, cat == 5 ? 417 + LAST8C[i]
                                 : 166 + SIG_OFF[cat] + i, i == last);
            if (i == last)
                break;
        }
    }
    int abs_base = cat == 5 ? 426 : 227 + ABS_OFF[cat];
    int num_eq1 = 0, num_gt1 = 0;
    for (int i = last; i >= 0; i--) {
        int v = coeffs[i];
        if (!v)
            continue;
        int mag = (v < 0 ? -v : v) - 1;
        int c0 = abs_base
                 + (num_gt1 ? 0 : (num_eq1 + 1 < 4 ? num_eq1 + 1 : 4));
        int c1 = abs_base + 5 + (num_gt1 < 4 ? num_gt1 : 4);
        int ctxs[2] = {c0, c1};
        ueg(c, ctxs, 2, 0, 14, mag, 0);
        bypass(c, v < 0);
        if (mag == 0) num_eq1++; else num_gt1++;
    }
    return 1;
}

static int cbf_inc_luma4(Maps *m, int mx, int my, int bx, int by, int intra)
{
    int gx = 4 * mx + bx, gy = 4 * my + by;
    int a = (gx - 1 < 0 || gy < 0) ? (intra ? 1 : 0)
            : m->cbf4[gy * 4 * m->mbw + gx - 1];
    int b = (gy - 1 < 0) ? (intra ? 1 : 0)
            : m->cbf4[(gy - 1) * 4 * m->mbw + gx];
    return a + 2 * b;
}

static int cbf_inc_dc(Maps *m, int mx, int my, int intra)
{
    int a, b;
    if (mx - 1 < 0) a = intra ? 1 : 0;
    else a = m->is_i16[my * m->mbw + mx - 1]
             ? m->cbf_dc[my * m->mbw + mx - 1] : 0;
    if (my - 1 < 0) b = intra ? 1 : 0;
    else b = m->is_i16[(my - 1) * m->mbw + mx]
             ? m->cbf_dc[(my - 1) * m->mbw + mx] : 0;
    return a + 2 * b;
}

static int cbf_inc_cdc(Maps *m, int mx, int my, int pl, int intra)
{
    int a = (mx - 1 < 0) ? (intra ? 1 : 0)
            : m->cbf_cdc[(my * m->mbw + mx - 1) * 2 + pl];
    int b = (my - 1 < 0) ? (intra ? 1 : 0)
            : m->cbf_cdc[((my - 1) * m->mbw + mx) * 2 + pl];
    return a + 2 * b;
}

static int cbf_inc_cac(Maps *m, int mx, int my, int sb, int pl, int intra)
{
    int gx = 2 * mx + (sb & 1), gy = 2 * my + (sb >> 1);
    int a = (gx - 1 < 0 || gy < 0) ? (intra ? 1 : 0)
            : m->cbf_cac[(gy * 2 * m->mbw + gx - 1) * 2 + pl];
    int b = (gy - 1 < 0) ? (intra ? 1 : 0)
            : m->cbf_cac[((gy - 1) * 2 * m->mbw + gx) * 2 + pl];
    return a + 2 * b;
}

/* qx/qy: 8x8-grid coords of the partition's FIRST block */
static void mvd_comp_q(Cabac *c, Maps *m, int qx, int qy, int comp,
                       int val, int lst)
{
    const int32_t *arr = lst ? (comp ? m->mvd1y : m->mvd1x)
                             : (comp ? m->mvdy : m->mvdx);
    int qw = 2 * m->mbw;
    int sa = 0, sb = 0;
    if (qx - 1 >= 0) { int t = arr[qy * qw + qx - 1]; sa = t < 0 ? -t : t; }
    if (qy - 1 >= 0) { int t = arr[(qy - 1) * qw + qx]; sb = t < 0 ? -t : t; }
    int s = sa + sb;
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    int off = comp ? 47 : 40;
    int ctxs[5] = {off + inc, off + 3, off + 4, off + 5, off + 6};
    ueg(c, ctxs, 5, 3, 9, val, 1);
}

/* fill a partition's cells in the 8x8 mvd map (pw/ph in 8-pel units) */
static void mvd_fill(Maps *m, int qx, int qy, int pw, int ph,
                     int vx, int vy, int lst)
{
    int32_t *ax = lst ? m->mvd1x : m->mvdx;
    int32_t *ay = lst ? m->mvd1y : m->mvdy;
    int qw = 2 * m->mbw;
    for (int dy = 0; dy < ph; dy++)
        for (int dx = 0; dx < pw; dx++) {
            ax[(qy + dy) * qw + qx + dx] = vx;
            ay[(qy + dy) * qw + qx + dx] = vy;
        }
}

/* ref_idx bins (9.3.3.1.1.6): unary, bin0 ctx 54 + condA + 2*condB
 * (condTerm = neighbouring partition has refIdx > 0), bins 1/2+ at
 * ctx 58/59 */
static void ref_idx_code(Cabac *c, Maps *m, int qx, int qy, int ref)
{
    int qw = 2 * m->mbw;
    int ca = (qx - 1 >= 0 && m->ref8[qy * qw + qx - 1] > 0) ? 1 : 0;
    int cb = (qy - 1 >= 0 && m->ref8[(qy - 1) * qw + qx] > 0) ? 1 : 0;
    decision(c, 54 + ca + 2 * cb, ref > 0);
    if (ref > 0) {
        for (int i = 1; i < ref; i++)
            decision(c, i == 1 ? 58 : 59, 1);
        decision(c, ref == 1 ? 58 : 59, 0);
    }
}

static void ref_fill(Maps *m, int qx, int qy, int pw, int ph, int ref)
{
    int qw = 2 * m->mbw;
    for (int dy = 0; dy < ph; dy++)
        for (int dx = 0; dx < pw; dx++)
            m->ref8[(qy + dy) * qw + qx + dx] = ref;
}

static void cbp_code(Cabac *c, Maps *m, int mx, int my, int cbp_l, int cbp_c)
{
    int cur = 0;
    for (int b = 0; b < 4; b++) {
        int bx = b & 1, by = b >> 1;
        int la, has_a, tb, has_b;
        if (bx == 0) {
            has_a = mx - 1 >= 0;
            la = has_a ? (m->cbp_l[my * m->mbw + mx - 1] >> (b + 1)) & 1 : 0;
        } else { has_a = 1; la = (cur >> (b - 1)) & 1; }
        if (by == 0) {
            has_b = my - 1 >= 0;
            tb = has_b ? (m->cbp_l[(my - 1) * m->mbw + mx] >> (b + 2)) & 1 : 0;
        } else { has_b = 1; tb = (cur >> (b - 2)) & 1; }
        int conda = has_a ? 1 - la : 0;
        int condb = has_b ? 1 - tb : 0;
        int bit = (cbp_l >> b) & 1;
        decision(c, 73 + conda + 2 * condb, bit);
        cur |= bit << b;
    }
    int a = mx - 1 >= 0 ? m->cbp_c[my * m->mbw + mx - 1] : 0;
    int b2 = my - 1 >= 0 ? m->cbp_c[(my - 1) * m->mbw + mx] : 0;
    decision(c, 77 + (a != 0) + 2 * (b2 != 0), cbp_c != 0);
    if (cbp_c)
        decision(c, 77 + 4 + (a == 2) + 2 * (b2 == 2), cbp_c == 2);
}

static void chroma_res(Cabac *c, Maps *m, int mx, int my, int cbp_c,
                       int intra, const int32_t *dc_u, const int32_t *dc_v,
                       const int32_t *ac_u, const int32_t *ac_v)
{
    if (cbp_c >= 1) {
        m->cbf_cdc[(my * m->mbw + mx) * 2 + 0] =
            (uint8_t)residual(c, 3, cbf_inc_cdc(m, mx, my, 0, intra), dc_u, 4);
        m->cbf_cdc[(my * m->mbw + mx) * 2 + 1] =
            (uint8_t)residual(c, 3, cbf_inc_cdc(m, mx, my, 1, intra), dc_v, 4);
    }
    if (cbp_c == 2) {
        for (int pl = 0; pl < 2; pl++) {
            const int32_t *acp = pl ? ac_v : ac_u;
            for (int sb = 0; sb < 4; sb++) {
                int cbf = residual(c, 4, cbf_inc_cac(m, mx, my, sb, pl, intra),
                                   acp + sb * 15, 15);
                int gy = 2 * my + (sb >> 1), gx = 2 * mx + (sb & 1);
                m->cbf_cac[(gy * 2 * m->mbw + gx) * 2 + pl] = (uint8_t)cbf;
            }
        }
    }
}

/* mb_qp_delta: mapped-unary bins, ctx 60+prev_nz / 62 / 63 (§9.3.2.7) */
static void qp_delta_code(Cabac *c, int val, int *prev_nz)
{
    decision(c, 60 + *prev_nz, val != 0);
    if (!val) {
        *prev_nz = 0;
        return;
    }
    int nbins = val > 0 ? 2 * val - 1 : -2 * val;
    for (int k = 1; ; k++) {
        int bit = k < nbins;
        decision(c, k == 1 ? 62 : 63, bit);
        if (!bit)
            break;
    }
    *prev_nz = 1;
}

/* returns payload bytes, or -1 on overflow / -2 on bad dims.
 * part: (n,) in {0:P_L0_16x16, 1:16x8, 2:8x16, 3:P_8x8} or NULL (all 0)
 * mvd:  (n,4,2) per-MB mvd pairs in quadrant raster order (16x16 uses
 *       slot 0; 16x8 slots 0,2; 8x16 slots 0,1; 8x8 all four)
 * ref:  (n,) per-MB refIdx (partitions gated to ref 0) or NULL; coded
 *       only when nref > 1 */
long cabac_encode_p_slice(
    int qp, int init_idc, int mbh, int mbw,
    const uint8_t *skip, const int32_t *part,
    const int32_t *mvd,                                 /* (n,4,2) */
    const int32_t *ref, int nref,
    const int32_t *cbp_l, const int32_t *cbp_c,
    const int32_t *levels,                              /* (n,16,16) masked */
    const int32_t *dc_u, const int32_t *dc_v,           /* (n,4) masked */
    const int32_t *ac_u, const int32_t *ac_v,           /* (n,4,15) masked */
    const int32_t *qpd,                                 /* (n,) or NULL */
    const uint8_t *t8, int t8_mode,   /* transform_size_8x8_flag per MB */
    uint8_t *out, long cap)
{
    int prev_nz = 0;
    if (mbh > MAXMB_H || mbw > MAXMB_W)
        return -2;
    Cabac c;
    Maps *m = &g_maps;
    maps_clear(m, mbh, mbw);
    cabac_init(&c, 0, qp, init_idc, out, cap);
    int n = mbh * mbw;
    for (int k = 0; k < n; k++) {
        int mx = k % mbw, my = k / mbw;
        /* mb_skip_flag: 3 contexts, inc = condA + condB */
        int ca = mx - 1 >= 0 ? !m->skip[my * mbw + mx - 1] : 0;
        int cb = my - 1 >= 0 ? !m->skip[(my - 1) * mbw + mx] : 0;
        decision(&c, 11 + ca + cb, skip[k]);
        m->skip[my * mbw + mx] = skip[k];
        if (!skip[k]) {
            int pt = part ? part[k] : 0;
            /* mb_type bins (Table 9-37 strings 000/011/010/001):
             * 16x16: 14:0 15:0 16:0; P_8x8: 14:0 15:0 16:1;
             * 8x16:  14:0 15:1 17:0; 16x8:  14:0 15:1 17:1 */
            decision(&c, 14, 0);
            if (pt == 0 || pt == 3) {
                decision(&c, 15, 0);
                decision(&c, 16, pt == 3);
            } else {
                decision(&c, 15, 1);
                decision(&c, 17, pt == 1);
            }
            if (pt == 3)
                for (int sbt = 0; sbt < 4; sbt++)
                    decision(&c, 21, 1);   /* sub_mb_type P_L0_8x8 */
            int r = ref ? ref[k] : 0;
            int qx0 = 2 * mx, qy0 = 2 * my;
            /* partition geometry: first-block offsets + sizes (8-pel) */
            static const int POS[4][4][2] = {
                {{0,0},{-1,-1},{-1,-1},{-1,-1}},   /* 16x16 */
                {{0,0},{0,1},{-1,-1},{-1,-1}},     /* 16x8: top, bottom */
                {{0,0},{1,0},{-1,-1},{-1,-1}},     /* 8x16: left, right */
                {{0,0},{1,0},{0,1},{1,1}}};        /* 8x8 raster */
            static const int SIZ[4][2] = {{2,2},{2,1},{1,2},{1,1}};
            int np = pt == 0 ? 1 : (pt == 3 ? 4 : 2);
            if (nref > 1)
                for (int pi = 0; pi < np; pi++) {
                    int qx = qx0 + POS[pt][pi][0], qy = qy0 + POS[pt][pi][1];
                    ref_idx_code(&c, m, qx, qy, r);
                    /* the MB's later partitions read this one as their
                     * neighbour A or B (9.3.3.1.1.6) */
                    ref_fill(m, qx, qy, pt == 0 ? 2 : SIZ[pt][0],
                             pt == 0 ? 2 : SIZ[pt][1], r);
                }
            for (int pi = 0; pi < np; pi++) {
                int qx = qx0 + POS[pt][pi][0], qy = qy0 + POS[pt][pi][1];
                int pw = pt == 0 ? 2 : SIZ[pt][0];
                int ph = pt == 0 ? 2 : SIZ[pt][1];
                /* mvd slot index in the (4,2) quadrant-raster layout */
                int sl = POS[pt][pi][1] * 2 + POS[pt][pi][0];
                int vx = mvd[8 * k + 2 * sl], vy = mvd[8 * k + 2 * sl + 1];
                mvd_comp_q(&c, m, qx, qy, 0, vx, 0);
                mvd_comp_q(&c, m, qx, qy, 1, vy, 0);
                mvd_fill(m, qx, qy, pw, ph, vx, vy, 0);
                ref_fill(m, qx, qy, pw, ph, r);
            }
            cbp_code(&c, m, mx, my, cbp_l[k], cbp_c[k]);
            m->cbp_l[my * mbw + mx] = cbp_l[k];
            m->cbp_c[my * mbw + mx] = cbp_c[k];
            int t8v = 0;
            if (t8_mode && cbp_l[k]) {
                t8v = t8 ? t8[k] : 0;
                int ta = mx - 1 >= 0 ? m->t8m[my * mbw + mx - 1] : 0;
                int tb = my - 1 >= 0 ? m->t8m[(my - 1) * mbw + mx] : 0;
                decision(&c, 399 + ta + tb, t8v);
            }
            m->t8m[my * mbw + mx] = (uint8_t)t8v;
            if (cbp_l[k] || cbp_c[k]) {
                qp_delta_code(&c, qpd ? qpd[k] : 0, &prev_nz);
                if (t8v) {
                    /* High 8x8: one cat-5 residual per coded 8x8 block;
                     * input levels are the CAVLC interleaved-4x4 layout
                     * (sub-block b carries scan positions 4j+b) */
                    for (int q = 0; q < 4; q++) {
                        int coded8 = (cbp_l[k] >> q) & 1;
                        if (coded8) {
                            int32_t co[64];
                            int nz = 0;
                            for (int i = 0; i < 64; i++) {
                                co[i] = levels[(k * 16 + q * 4 + (i & 3))
                                               * 16 + (i >> 2)];
                                nz |= co[i] != 0;
                            }
                            if (!nz)
                                return -3;  /* not representable in CABAC */
                            residual(&c, 5, 0, co, 64);
                        }
                        for (int b = 0; b < 4; b++) {
                            int blk = q * 4 + b;
                            int bx = BLKX[blk], by = BLKY[blk];
                            m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx]
                                = (uint8_t)coded8;
                        }
                    }
                } else {
                    for (int blk = 0; blk < 16; blk++) {
                        if (!((cbp_l[k] >> (blk / 4)) & 1))
                            continue;
                        int bx = BLKX[blk], by = BLKY[blk];
                        int inc = cbf_inc_luma4(m, mx, my, bx, by, 0);
                        int cbf = residual(&c, 2, inc, levels + (k * 16 + blk) * 16, 16);
                        m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx] = (uint8_t)cbf;
                    }
                }
                chroma_res(&c, m, mx, my, cbp_c[k], 0, dc_u + 4 * k,
                           dc_v + 4 * k, ac_u + 60 * k, ac_v + 60 * k);
            } else {
                prev_nz = 0;
            }
        } else {
            prev_nz = 0;
        }
        terminate(&c, k == n - 1);
        if (c.overflow)
            return -1;
    }
    flush_final(&c);
    if (c.overflow)
        return -1;
    return (c.nbits + 7) >> 3;
}

/* I slice with mixed I16x16 / I_NxN macroblocks.  The five i4 arrays may
 * all be NULL for a pure-I16 slice: use_i4 (n,), i4_prev (n,16),
 * i4_rem (n,16), cbp4 (n,), levels4 (n,16,16 zigzag decode order). */
long cabac_encode_i_slice(
    int qp, int mbh, int mbw,
    const uint8_t *use_i4, const uint8_t *i4_prev, const int32_t *i4_rem,
    const int32_t *cbp4, const int32_t *levels4,
    const int32_t *i16mode, const int32_t *cmode, const uint8_t *acflag,
    const int32_t *cbp_c,
    const int32_t *dc,                                  /* (n,16) */
    const int32_t *ac,                                  /* (n,16,15) */
    const int32_t *dc_u, const int32_t *dc_v,           /* (n,4) */
    const int32_t *ac_u, const int32_t *ac_v,           /* (n,4,15) */
    int t8_mode,
    uint8_t *out, long cap)
{
    if (mbh > MAXMB_H || mbw > MAXMB_W)
        return -2;
    Cabac c;
    Maps *m = &g_maps;
    maps_clear(m, mbh, mbw);
    cabac_init(&c, 1, qp, 0, out, cap);
    int n = mbh * mbw;
    for (int k = 0; k < n; k++) {
        int mx = k % mbw, my = k / mbw;
        int i4 = use_i4 && use_i4[k];
        /* mb_type b0 at 3 + condA + condB (condTerm = nbr not I_NxN) */
        int ca = mx - 1 >= 0 ? !m->is_inxn[my * mbw + mx - 1] : 0;
        int cb = my - 1 >= 0 ? !m->is_inxn[(my - 1) * mbw + mx] : 0;
        decision(&c, 3 + ca + cb, !i4);
        if (i4) {
            m->is_inxn[my * mbw + mx] = 1;
            if (t8_mode) {
                /* transform_size_8x8_flag = 0 (no Intra_8x8 yet) */
                int ta = mx - 1 >= 0 ? m->t8m[my * mbw + mx - 1] : 0;
                int tb = my - 1 >= 0 ? m->t8m[(my - 1) * mbw + mx] : 0;
                decision(&c, 399 + ta + tb, 0);
            }
            for (int b = 0; b < 16; b++) {
                int pf = i4_prev[16 * k + b];
                decision(&c, 68, pf);
                if (!pf) {
                    int rv = i4_rem[16 * k + b];
                    for (int i = 0; i < 3; i++)
                        decision(&c, 69, (rv >> i) & 1);
                }
            }
        } else {
            terminate(&c, 0);      /* I_PCM escape, always 0 for I16 */
            decision(&c, 6, acflag[k]);
            decision(&c, 7, cbp_c[k] != 0);
            if (cbp_c[k])
                decision(&c, 8, cbp_c[k] == 2);
            decision(&c, 9, (i16mode[k] >> 1) & 1);
            decision(&c, 10, i16mode[k] & 1);
            m->is_i16[my * mbw + mx] = 1;
            m->cbp_l[my * mbw + mx] = acflag[k] ? 15 : 0;
            m->cbp_c[my * mbw + mx] = cbp_c[k];
        }
        /* intra_chroma_pred_mode: TU cMax 3 */
        int ia = mx - 1 >= 0 ? (m->cmode[my * mbw + mx - 1] != 0) : 0;
        int ib = my - 1 >= 0 ? (m->cmode[(my - 1) * mbw + mx] != 0) : 0;
        int inc = ia + ib;
        for (int v = 0; v < cmode[k]; v++)
            decision(&c, v == 0 ? 64 + inc : 67, 1);
        if (cmode[k] < 3)
            decision(&c, cmode[k] == 0 ? 64 + inc : 67, 0);
        m->cmode[my * mbw + mx] = cmode[k];
        if (i4) {
            cbp_code(&c, m, mx, my, cbp4[k], cbp_c[k]);
            m->cbp_l[my * mbw + mx] = cbp4[k];
            m->cbp_c[my * mbw + mx] = cbp_c[k];
            if (cbp4[k] || cbp_c[k]) {
                decision(&c, 60, 0);    /* mb_qp_delta = 0 */
                for (int blk = 0; blk < 16; blk++) {
                    if (!((cbp4[k] >> (blk / 4)) & 1))
                        continue;
                    int bx = BLKX[blk], by = BLKY[blk];
                    int inc2 = cbf_inc_luma4(m, mx, my, bx, by, 1);
                    int cb2 = residual(&c, 2, inc2,
                                       levels4 + (k * 16 + blk) * 16, 16);
                    m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx]
                        = (uint8_t)cb2;
                }
                chroma_res(&c, m, mx, my, cbp_c[k], 1, dc_u + 4 * k,
                           dc_v + 4 * k, ac_u + 60 * k, ac_v + 60 * k);
            }
        } else {
            decision(&c, 60, 0);        /* mb_qp_delta = 0 */
            int cbf = residual(&c, 0, cbf_inc_dc(m, mx, my, 1),
                               dc + 16 * k, 16);
            m->cbf_dc[my * mbw + mx] = (uint8_t)cbf;
            if (acflag[k]) {
                for (int blk = 0; blk < 16; blk++) {
                    int bx = BLKX[blk], by = BLKY[blk];
                    int inc2 = cbf_inc_luma4(m, mx, my, bx, by, 1);
                    int cb2 = residual(&c, 1, inc2, ac + (k * 16 + blk) * 15,
                                       15);
                    m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx]
                        = (uint8_t)cb2;
                }
            }
            chroma_res(&c, m, mx, my, cbp_c[k], 1, dc_u + 4 * k,
                       dc_v + 4 * k, ac_u + 60 * k, ac_v + 60 * k);
        }
        terminate(&c, k == n - 1);
        if (c.overflow)
            return -1;
    }
    flush_final(&c);
    if (c.overflow)
        return -1;
    return (c.nbits + 7) >> 3;
}

/* B slice: B_Skip / B_Direct_16x16 / B_{L0,L1,Bi}_16x16 (mode 0..3).
 * Returns payload bytes, -1 overflow, -2 bad dims, -3 unsupported mode. */
long cabac_encode_b_slice(
    int qp, int init_idc, int mbh, int mbw,
    const uint8_t *skip, const int32_t *mode,
    const int32_t *mvd0, const int32_t *mvd1,          /* (n,2) each */
    const int32_t *cbp_l, const int32_t *cbp_c,
    const int32_t *levels,                              /* (n,16,16) masked */
    const int32_t *dc_u, const int32_t *dc_v,           /* (n,4) masked */
    const int32_t *ac_u, const int32_t *ac_v,           /* (n,4,15) masked */
    int t8_mode, const uint8_t *t8,
    uint8_t *out, long cap)
{
    if (mbh > MAXMB_H || mbw > MAXMB_W)
        return -2;
    Cabac c;
    Maps *m = &g_maps;
    maps_clear(m, mbh, mbw);
    cabac_init(&c, 0, qp, init_idc, out, cap);
    int n = mbh * mbw;
    for (int k = 0; k < n; k++) {
        int mx = k % mbw, my = k / mbw;
        /* mb_skip_flag for B: ctx 24..26 */
        int ca = mx - 1 >= 0 ? !m->skip[my * mbw + mx - 1] : 0;
        int cb = my - 1 >= 0 ? !m->skip[(my - 1) * mbw + mx] : 0;
        decision(&c, 24 + ca + cb, skip[k]);
        m->skip[my * mbw + mx] = skip[k];
        if (skip[k]) {
            m->direct[my * mbw + mx] = 1;
        } else {
            int t = mode[k];
            if (t < 0 || t > 3)
                return -3;
            /* mb_type ctx 27: condTerm = coded && !skip && !direct */
            int da = mx - 1 >= 0
                     ? !(m->skip[my * mbw + mx - 1]
                         || m->direct[my * mbw + mx - 1]) : 0;
            int db = my - 1 >= 0
                     ? !(m->skip[(my - 1) * mbw + mx]
                         || m->direct[(my - 1) * mbw + mx]) : 0;
            decision(&c, 27 + da + db, t != 0);
            m->direct[my * mbw + mx] = t == 0;
            if (t) {
                decision(&c, 27 + 3, t > 2);
                if (t <= 2) {
                    decision(&c, 27 + 5, t == 2);
                } else {    /* Bi_16x16: 4-bin field = 0 */
                    decision(&c, 27 + 4, 0);
                    decision(&c, 27 + 5, 0);
                    decision(&c, 27 + 5, 0);
                    decision(&c, 27 + 5, 0);
                }
                if (t == 1 || t == 3) {
                    mvd_comp_q(&c, m, 2 * mx, 2 * my, 0, mvd0[2 * k], 0);
                    mvd_comp_q(&c, m, 2 * mx, 2 * my, 1, mvd0[2 * k + 1], 0);
                    mvd_fill(m, 2 * mx, 2 * my, 2, 2,
                             mvd0[2 * k], mvd0[2 * k + 1], 0);
                }
                if (t == 2 || t == 3) {
                    mvd_comp_q(&c, m, 2 * mx, 2 * my, 0, mvd1[2 * k], 1);
                    mvd_comp_q(&c, m, 2 * mx, 2 * my, 1, mvd1[2 * k + 1], 1);
                    mvd_fill(m, 2 * mx, 2 * my, 2, 2,
                             mvd1[2 * k], mvd1[2 * k + 1], 1);
                }
            }
            cbp_code(&c, m, mx, my, cbp_l[k], cbp_c[k]);
            m->cbp_l[my * mbw + mx] = cbp_l[k];
            m->cbp_c[my * mbw + mx] = cbp_c[k];
            int t8v = 0;
            if (t8_mode && cbp_l[k]) {
                t8v = t8 ? t8[k] : 0;
                int ta = mx - 1 >= 0 ? m->t8m[my * mbw + mx - 1] : 0;
                int tb = my - 1 >= 0 ? m->t8m[(my - 1) * mbw + mx] : 0;
                decision(&c, 399 + ta + tb, t8v);
            }
            m->t8m[my * mbw + mx] = (uint8_t)t8v;
            if (cbp_l[k] || cbp_c[k]) {
                decision(&c, 60, 0);    /* mb_qp_delta = 0 */
                if (t8v) {
                    for (int q = 0; q < 4; q++) {
                        int coded8 = (cbp_l[k] >> q) & 1;
                        if (coded8) {
                            int32_t co[64];
                            int nz = 0;
                            for (int i = 0; i < 64; i++) {
                                co[i] = levels[(k * 16 + q * 4 + (i & 3))
                                               * 16 + (i >> 2)];
                                nz |= co[i] != 0;
                            }
                            if (!nz)
                                return -3;
                            residual(&c, 5, 0, co, 64);
                        }
                        for (int b = 0; b < 4; b++) {
                            int blk = q * 4 + b;
                            int bx = BLKX[blk], by = BLKY[blk];
                            m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx]
                                = (uint8_t)coded8;
                        }
                    }
                } else {
                    for (int blk = 0; blk < 16; blk++) {
                        if (!((cbp_l[k] >> (blk / 4)) & 1))
                            continue;
                        int bx = BLKX[blk], by = BLKY[blk];
                        int inc = cbf_inc_luma4(m, mx, my, bx, by, 0);
                        int cbf = residual(&c, 2, inc,
                                           levels + (k * 16 + blk) * 16, 16);
                        m->cbf4[(4 * my + by) * 4 * mbw + 4 * mx + bx]
                            = (uint8_t)cbf;
                    }
                }
                chroma_res(&c, m, mx, my, cbp_c[k], 0, dc_u + 4 * k,
                           dc_v + 4 * k, ac_u + 60 * k, ac_v + 60 * k);
            }
        }
        terminate(&c, k == n - 1);
        if (c.overflow)
            return -1;
    }
    flush_final(&c);
    if (c.overflow)
        return -1;
    return (c.nbits + 7) >> 3;
}
