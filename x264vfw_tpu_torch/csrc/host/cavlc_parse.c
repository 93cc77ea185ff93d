/* Native CAVLC slice-data parser for the decode path.
 *
 * Replaces the per-MB Python entropy parse of decode/decoder.py (the
 * serial host stage of BASELINE config 4) with a C pass that emits the
 * full syntax tensors a batched device reconstruction consumes: per-MB
 * kinds/modes/cbp/qp, per-block coefficients, and the RESOLVED motion
 * field (mv prediction 8.4.1.3 and P_Skip 8.4.1.1 run here, so the device
 * never sees mvd).  VLC decoding is one 16-bit-peek table lookup per
 * symbol; the LUTs are built in Python from the same spec tables the
 * encoder uses (bitstream/cavlc_luts.py) and passed in as one buffer.
 *
 * Scope (mirrors decode/decoder.py's CAVLC support, which is pinned
 * bit-exactly to stock FFmpeg in tests): I + P slices, I16x16 / I_NxN /
 * P_Skip / P_L0_16x16 / 16x8 / 8x16 / P_8x8(+ref0) with all sub_mb_types,
 * multi-ref, per-MB qp_delta.  Unsupported syntax returns a negative
 * code and the caller falls back to the Python decoder: B slices (-2),
 * I_PCM (-3), 8x8 transform (-4), parse errors (-5).
 */
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------ bit reader */
typedef struct {
    const uint8_t *buf;
    long nbytes;
    long pos;          /* bit position */
    long stop;         /* bit index of the rbsp_stop_one_bit */
    int error;
} BR;

static void br_init(BR *r, const uint8_t *buf, long nbytes, long bitpos)
{
    r->buf = buf;
    r->nbytes = nbytes;
    r->pos = bitpos;
    r->error = 0;
    long i = nbytes - 1;
    while (i >= 0 && buf[i] == 0)
        i--;
    if (i < 0) {
        r->stop = 0;
    } else {
        int b = buf[i], k = 0;
        while (!((b >> k) & 1))
            k++;
        r->stop = 8 * i + (7 - k);
    }
}

/* 32-bit window starting at bit pos (zero-padded past the buffer end).
 * Fast path: one unaligned 8-byte load + bswap; tail: byte loop. */
static inline uint32_t br_peek32(BR *r)
{
    long byte = r->pos >> 3;
    int off = (int)(r->pos & 7);
    if (byte + 8 <= r->nbytes) {
        uint64_t v;
        memcpy(&v, r->buf + byte, 8);
        v = __builtin_bswap64(v);
        return (uint32_t)(v >> (32 - off));
    }
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t b = (byte + i < r->nbytes) ? r->buf[byte + i] : 0;
        v = (v << 8) | b;
    }
    return (uint32_t)(v >> (32 - off));
}

static inline unsigned br_peek16(BR *r)
{
    return br_peek32(r) >> 16;
}

static unsigned br_u(BR *r, int n)
{
    unsigned v = 0;
    while (n > 0) {
        int take = n > 16 ? 16 : n;
        v = (v << take) | (br_peek16(r) >> (16 - take));
        r->pos += take;
        n -= take;
    }
    if (r->pos > 8 * r->nbytes)
        r->error = 1;
    return v;
}

/* count zeros before the next 1 bit and consume through that 1 bit;
 * returns the zero count or -1 (sets error) past maxz / buffer end */
static inline int br_zeros(BR *r, int maxz)
{
    int zeros = 0;
    for (;;) {
        uint32_t w = br_peek32(r);
        if (w) {
            int z = __builtin_clz(w);
            zeros += z;
            r->pos += z + 1;
            if (zeros > maxz || r->pos > 8 * r->nbytes) {
                r->error = 1;
                return -1;
            }
            return zeros;
        }
        zeros += 32;
        r->pos += 32;
        if (zeros > maxz) {
            r->error = 1;
            return -1;
        }
    }
}

static unsigned br_ue(BR *r)
{
    int zeros = br_zeros(r, 31);
    if (zeros <= 0)
        return 0;
    return (1u << zeros) - 1 + br_u(r, zeros);
}

static int br_se(BR *r)
{
    unsigned k = br_ue(r);
    return (k & 1) ? (int)((k + 1) >> 1) : -(int)(k >> 1);
}

static int br_more(BR *r)
{
    return r->pos < r->stop;
}

/* ------------------------------------------------------------ VLC tables */
/* layout documented in bitstream/cavlc_luts.py */
#define LUT_CT0 0
#define LUT_CT_CDC 3
#define LUT_TZ 4       /* + total_coeff - 1 (1..15) */
#define LUT_TZC 19     /* + total_coeff - 1 (1..3) */
#define LUT_RB 22      /* + min(zeros_left,7) - 1 */

static int read_vlc(BR *r, const uint16_t *luts, int table)
{
    unsigned e = luts[((long)table << 16) | br_peek16(r)];
    int len = e & 31;
    if (!len) {
        r->error = 1;
        return 0;
    }
    r->pos += len;
    return (int)(e >> 5);
}

/* level_prefix + level_suffix (9.2.2.1) */
static int decode_level(BR *r, int sl)
{
    int prefix = br_zeros(r, 32);
    if (prefix < 0)
        return 0;
    int suffix_size;
    if (prefix == 14 && sl == 0)
        suffix_size = 4;
    else if (prefix >= 15)
        suffix_size = prefix - 3;
    else
        suffix_size = sl;
    int suffix = suffix_size ? (int)br_u(r, suffix_size) : 0;
    int lc = ((prefix < 15 ? prefix : 15) << sl) + suffix;
    if (prefix >= 15 && sl == 0)
        lc += 15;
    if (prefix >= 16)
        lc += (1 << (prefix - 3)) - 4096;
    return lc;
}

/* decode one residual block into out[maxc] (zigzag order) */
static void residual_block(BR *r, const uint16_t *luts, int nC, int maxc,
                           int16_t *out)
{
    memset(out, 0, (size_t)maxc * sizeof(int16_t));
    int tc, t1;
    if (nC >= 8) {
        int code = (int)br_u(r, 6);
        if (code == 3) {
            tc = 0;
            t1 = 0;
        } else {
            tc = code / 4 + 1;
            t1 = code % 4;
        }
    } else {
        int table = nC == -1 ? LUT_CT_CDC : (nC < 2 ? 0 : (nC < 4 ? 1 : 2));
        int res = read_vlc(r, luts, table);
        tc = res >> 2;
        t1 = res & 3;
    }
    if (r->error || tc == 0)
        return;

    int32_t lvls[16];
    for (int i = 0; i < t1; i++)
        lvls[i] = br_u(r, 1) ? -1 : 1;
    int sl = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int k = t1; k < tc; k++) {
        int lc = decode_level(r, sl);
        if (k == t1 && t1 < 3)
            lc += 2;
        int lv = (lc % 2 == 0) ? ((lc + 2) >> 1) : -((lc + 1) >> 1);
        lvls[k] = lv;
        if (sl == 0)
            sl = 1;
        int alv = lv < 0 ? -lv : lv;
        if (alv > (3 << (sl - 1)) && sl < 6)
            sl++;
    }
    int total_zeros = 0;
    if (tc < maxc) {
        int table = (nC == -1) ? LUT_TZC + tc - 1 : LUT_TZ + tc - 1;
        total_zeros = read_vlc(r, luts, table);
    }
    if (r->error)
        return;
    int zeros_left = total_zeros;
    int pos = tc + total_zeros - 1;
    for (int k = 0; k < tc; k++) {
        if (pos < 0 || pos >= maxc
            || lvls[k] > 32767 || lvls[k] < -32768) {
            r->error = 1;            /* out-of-profile level: fall back */
            return;
        }
        out[pos] = (int16_t)lvls[k];
        if (k == tc - 1)
            break;
        int run = 0;
        if (zeros_left > 0) {
            int zl = zeros_left < 7 ? zeros_left : 7;
            run = read_vlc(r, luts, LUT_RB + zl - 1);
        }
        zeros_left -= run;
        pos -= run + 1;
    }
}

/* --------------------------------------------------------- parser state */
#define MAXW 512
#define MAXH 512
static _Thread_local uint8_t g_tc_luma[4 * MAXH * 4 * MAXW];
static _Thread_local uint8_t g_tc_cu[2 * MAXH * 2 * MAXW];
static _Thread_local uint8_t g_tc_cv[2 * MAXH * 2 * MAXW];
static _Thread_local int8_t g_i4m[4 * MAXH * 4 * MAXW];     /* -1 = non-I4 */
static _Thread_local uint8_t g_dec[MAXH * MAXW];            /* MB decoded */
static _Thread_local int32_t g_mvx[4 * MAXH * 4 * MAXW];
static _Thread_local int32_t g_mvy[4 * MAXH * 4 * MAXW];
static _Thread_local int8_t g_ref[4 * MAXH * 4 * MAXW];     /* -1 intra, -2 undecoded */

static const int BLKX[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLKY[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
/* raster (by*4+bx) -> decode index */
static const int R2B[16] = {0,1,4,5,2,3,6,7,8,9,12,13,10,11,14,15};
/* cbp me() decode: codeNum -> (intra, inter) */
static const uint8_t CBPI[48] = {47,31,15,0,23,27,29,30,7,11,13,14,39,43,45,
    46,16,3,5,10,12,19,21,26,28,35,37,42,44,1,2,4,8,17,18,20,24,6,9,22,25,
    32,33,34,36,40,38,41};
static const uint8_t CBPP[48] = {0,16,1,2,4,8,32,3,5,10,12,15,47,7,11,13,14,
    6,9,31,35,37,42,44,33,34,36,40,39,43,45,46,17,18,20,24,19,21,26,28,23,
    27,29,30,22,25,38,41};

typedef struct {
    int mbh, mbw, gw;
    int nref;
} Ctx;

static int nc_luma(Ctx *c, int gx, int gy)
{
    int availA = gx > 0 && g_dec[(gy / 4) * c->mbw + (gx - 1) / 4];
    int availB = gy > 0 && g_dec[((gy - 1) / 4) * c->mbw + gx / 4];
    int a = availA ? g_tc_luma[gy * c->gw + gx - 1] : 0;
    int b = availB ? g_tc_luma[(gy - 1) * c->gw + gx] : 0;
    if (availA && availB)
        return (a + b + 1) >> 1;
    return availA ? a : (availB ? b : 0);
}

static int nc_chroma(Ctx *c, uint8_t *tc, int gx, int gy)
{
    int cw = 2 * c->mbw;
    int availA = gx > 0 && g_dec[(gy / 2) * c->mbw + (gx - 1) / 2];
    int availB = gy > 0 && g_dec[((gy - 1) / 2) * c->mbw + gx / 2];
    int a = availA ? tc[gy * cw + gx - 1] : 0;
    int b = availB ? tc[(gy - 1) * cw + gx] : 0;
    if (availA && availB)
        return (a + b + 1) >> 1;
    return availA ? a : (availB ? b : 0);
}

static int count_nz(const int16_t *v, int n)
{
    int c = 0;
    for (int i = 0; i < n; i++)
        c += v[i] != 0;
    return c;
}

/* neighbour fetch for mv prediction: returns avail; mv forced 0 when the
 * block is intra (ref -1), matching 8.4.1.3 */
static int mvnb(Ctx *c, int bx, int by, int32_t mv[2], int *ref)
{
    mv[0] = mv[1] = 0;
    *ref = -1;
    if (bx < 0 || by < 0 || bx >= c->gw || by >= 4 * c->mbh)
        return 0;
    int r = g_ref[by * c->gw + bx];
    if (r == -2)
        return 0;
    *ref = r;
    if (r >= 0) {
        mv[0] = g_mvx[by * c->gw + bx];
        mv[1] = g_mvy[by * c->gw + bx];
    }
    return 1;
}

static int32_t med3(int32_t a, int32_t b, int32_t cc)
{
    int32_t mx = a > b ? a : b, mn = a < b ? a : b;
    if (cc > mx) return mx;
    if (cc < mn) return mn;
    return cc;
}

/* 8.4.1.3 median MV prediction; part coords/sizes in 4-pel units */
static void mv_pred(Ctx *c, int mx, int my, int px, int py, int pw, int ph,
                    int ref_idx, int32_t out[2])
{
    int gx = 4 * mx + px, gy = 4 * my + py;
    int32_t mvA[2], mvB[2], mvC[2];
    int refA, refB, refC;
    int aA = mvnb(c, gx - 1, gy, mvA, &refA);
    int aB = mvnb(c, gx, gy - 1, mvB, &refB);
    int aC = mvnb(c, gx + pw, gy - 1, mvC, &refC);
    if (!aC)
        aC = mvnb(c, gx - 1, gy - 1, mvC, &refC);

    if (pw == 4 && ph == 2) {          /* 16x8 */
        if (py == 0 && aB && refB == ref_idx) { out[0]=mvB[0]; out[1]=mvB[1]; return; }
        if (py == 2 && aA && refA == ref_idx) { out[0]=mvA[0]; out[1]=mvA[1]; return; }
    } else if (pw == 2 && ph == 4) {   /* 8x16 */
        if (px == 0 && aA && refA == ref_idx) { out[0]=mvA[0]; out[1]=mvA[1]; return; }
        if (px == 2 && aC && refC == ref_idx) { out[0]=mvC[0]; out[1]=mvC[1]; return; }
    }
    if (aA && !aB && !aC) { out[0] = mvA[0]; out[1] = mvA[1]; return; }
    int m0 = aA && refA == ref_idx, m1 = aB && refB == ref_idx,
        m2 = aC && refC == ref_idx;
    if (m0 + m1 + m2 == 1) {
        const int32_t *sel = m0 ? mvA : (m1 ? mvB : mvC);
        out[0] = sel[0];
        out[1] = sel[1];
        return;
    }
    if (!aA) mvA[0] = mvA[1] = 0;
    if (!aB) mvB[0] = mvB[1] = 0;
    if (!aC) mvC[0] = mvC[1] = 0;
    out[0] = med3(mvA[0], mvB[0], mvC[0]);
    out[1] = med3(mvA[1], mvB[1], mvC[1]);
}

static void set_motion(Ctx *c, int mx, int my, int px, int py, int pw, int ph,
                       int32_t vx, int32_t vy, int ref)
{
    int gx = 4 * mx + px, gy = 4 * my + py;
    for (int dy = 0; dy < ph; dy++)
        for (int dx = 0; dx < pw; dx++) {
            long o = (long)(gy + dy) * c->gw + gx + dx;
            g_mvx[o] = vx;
            g_mvy[o] = vy;
            g_ref[o] = (int8_t)ref;
        }
}

/* 8.3.1.1 predIntra4x4PredMode for block decode-index blk, given the
 * in-progress raster mode canvas (g_i4m on the global 4x4 grid) */
static int i4_pred_mode(Ctx *c, int mx, int my, int blk)
{
    int bx = BLKX[blk], by = BLKY[blk];
    int gx = 4 * mx + bx, gy = 4 * my + by;
    int mA, mB;
    if (gx == 0 || !(bx > 0 || g_dec[my * c->mbw + mx - 1]))
        return 2;
    if (gy == 0 || !(by > 0 || g_dec[(my - 1) * c->mbw + mx]))
        return 2;
    mA = g_i4m[gy * c->gw + gx - 1];
    mB = g_i4m[(gy - 1) * c->gw + gx];
    if (mA < 0) mA = 2;
    if (mB < 0) mB = 2;
    return mA < mB ? mA : mB;
}

/* read a list-0 ref_idx */
static int read_ref(BR *r, int nref)
{
    if (nref == 1)
        return 0;
    if (nref == 2)
        return 1 - (int)br_u(r, 1);
    return (int)br_ue(r);
}

/* chroma residuals: DC(u), DC(v), AC(u)x4, AC(v)x4 */
static void chroma_residuals(BR *r, const uint16_t *luts, Ctx *c, int mx,
                             int my, int cbp_c, int16_t *cdc, int16_t *cac)
{
    int cw = 2 * c->mbw;
    if (cbp_c) {
        residual_block(r, luts, -1, 4, cdc);
        residual_block(r, luts, -1, 4, cdc + 4);
    }
    if (cbp_c == 2) {
        for (int pl = 0; pl < 2; pl++) {
            uint8_t *tc = pl ? g_tc_cv : g_tc_cu;
            for (int sb = 0; sb < 4; sb++) {
                int gx = 2 * mx + (sb & 1), gy = 2 * my + (sb >> 1);
                int nc = nc_chroma(c, tc, gx, gy);
                residual_block(r, luts, nc, 15, cac + (pl * 4 + sb) * 15);
                tc[gy * cw + gx] =
                    (uint8_t)count_nz(cac + (pl * 4 + sb) * 15, 15);
            }
        }
    } else {
        for (int pl = 0; pl < 2; pl++) {
            uint8_t *tc = pl ? g_tc_cv : g_tc_cu;
            for (int dy = 0; dy < 2; dy++)
                for (int dx = 0; dx < 2; dx++)
                    tc[(2 * my + dy) * cw + 2 * mx + dx] = 0;
        }
    }
}

/* returns number of MBs parsed (== n on success) or a negative code */
long cavlc_parse_slice(
    const uint8_t *rbsp, long nbytes, long bitpos,
    int slice_type /* 0 = P, 2 = I */, int mbh, int mbw,
    int qp_init, int nref, int transform_8x8,
    const uint16_t *luts,
    int32_t *mb_kind, int32_t *qp_map,
    int32_t *i16mode, int32_t *cmode,
    int8_t *i4modes,                   /* (n,16) decode order */
    int32_t *cbp_luma, int32_t *cbp_chroma,
    int16_t *dc16,                     /* (n,16) I16 luma DC */
    int16_t *ac15,                     /* (n,16,15) I16 luma AC */
    int16_t *lvl16,                    /* (n,16,16) I4/inter luma */
    int16_t *cdc,                      /* (n,2,4) */
    int16_t *cac,                      /* (n,2,4,15) */
    int16_t *mv4,                      /* (n,16,2) raster 4x4 grid */
    int8_t *ref4,                      /* (n,16) raster, -1 intra */
    int32_t *flags,                    /* (n,) bit0: has sub-8x8 parts */
    /* optional RAW-syntax outputs (entropy transcode: the CABAC host
     * coder re-codes the exact syntax elements, so it needs the values
     * as parsed, not the resolved motion field).  All nullable. */
    int16_t *mvdq,                     /* (n,4,2) quadrant-raster mvd */
    int8_t *refq,                      /* (n,4) per-quadrant ref_idx */
    int8_t *part,                      /* (n,) 0..3 P partition, -1 other */
    uint8_t *i4prev,                   /* (n,16) prev_..._pred_mode_flag */
    int8_t *i4rem,                     /* (n,16) rem mode, -1 when prev */
    int8_t *qpd,                       /* (n,) raw mb_qp_delta */
    uint8_t *t8out)                    /* (n,) transform_size_8x8_flag */
{
    if (mbh > MAXH || mbw > MAXW)
        return -6;
    if (slice_type != 0 && slice_type != 2)
        return -2;
    Ctx ctx = {mbh, mbw, 4 * mbw, nref};
    Ctx *c = &ctx;
    long n = (long)mbh * mbw;
    memset(g_dec, 0, (size_t)n);
    memset(g_i4m, -1, (size_t)(16 * n));
    memset(g_ref, -2, (size_t)(16 * n));
    memset(g_tc_luma, 0, (size_t)(16 * n));
    memset(g_tc_cu, 0, (size_t)(4 * n));
    memset(g_tc_cv, 0, (size_t)(4 * n));
    if (part)
        memset(part, -1, (size_t)n);
    BR br, *r = &br;
    br_init(r, rbsp, nbytes, bitpos);
    int qp = qp_init;
    int inter = slice_type == 0;
    long k = 0;
    while (k < n) {
        int mx = (int)(k % mbw), my = (int)(k / mbw);
        if (inter) {
            long run = br_ue(r);
            if (r->error)
                return -5;
            while (run-- > 0 && k < n) {
                mx = (int)(k % mbw);
                my = (int)(k / mbw);
                /* P_Skip (8.4.1.1) */
                int32_t mvA[2], mvB[2], mv[2] = {0, 0};
                int refA, refB;
                int aA = mvnb(c, 4 * mx - 1, 4 * my, mvA, &refA);
                int aB = mvnb(c, 4 * mx, 4 * my - 1, mvB, &refB);
                if (aA && aB
                    && !(refA == 0 && mvA[0] == 0 && mvA[1] == 0)
                    && !(refB == 0 && mvB[0] == 0 && mvB[1] == 0))
                    mv_pred(c, mx, my, 0, 0, 4, 4, 0, mv);
                g_dec[k] = 1;
                set_motion(c, mx, my, 0, 0, 4, 4, mv[0], mv[1], 0);
                mb_kind[k] = 0;
                qp_map[k] = qp;
                for (int b = 0; b < 16; b++) {
                    mv4[(k * 16 + b) * 2] = (int16_t)mv[0];
                    mv4[(k * 16 + b) * 2 + 1] = (int16_t)mv[1];
                    ref4[k * 16 + b] = 0;
                }
                k++;
            }
            if (k >= n)
                break;
            if (!br_more(r))
                break;
            mx = (int)(k % mbw);
            my = (int)(k / mbw);
        }
        unsigned mbt = br_ue(r);
        if (r->error)
            return -5;
        int intra_off = inter ? 5 : 0;
        if ((long)mbt >= intra_off + 25)
            return -3;                          /* I_PCM */
        if (inter && mbt < 5) {
            /* ---- P macroblock ---- */
            g_dec[k] = 1;
            int kind;
            if (mbt == 0) {
                kind = 1;
                int ref = read_ref(r, nref);
                int32_t pmv[2], mv[2];
                mv_pred(c, mx, my, 0, 0, 4, 4, ref, pmv);
                int dx = br_se(r), dy = br_se(r);
                mv[0] = pmv[0] + dx;
                mv[1] = pmv[1] + dy;
                set_motion(c, mx, my, 0, 0, 4, 4, mv[0], mv[1], ref);
                if (part)
                    part[k] = 0;
                if (mvdq) {
                    mvdq[k * 8] = (int16_t)dx;
                    mvdq[k * 8 + 1] = (int16_t)dy;
                }
                if (refq)
                    for (int q = 0; q < 4; q++)
                        refq[k * 4 + q] = (int8_t)ref;
            } else if (mbt == 1 || mbt == 2) {
                kind = mbt == 1 ? 2 : 3;
                int refs[2] = {read_ref(r, nref), read_ref(r, nref)};
                if (part)
                    part[k] = (int8_t)mbt;  /* 1 = 16x8, 2 = 8x16 */
                for (int p = 0; p < 2; p++) {
                    int px = mbt == 2 ? p * 2 : 0;
                    int py = mbt == 1 ? p * 2 : 0;
                    int pw = mbt == 2 ? 2 : 4;
                    int ph = mbt == 1 ? 2 : 4;
                    int32_t pmv[2], mv[2];
                    mv_pred(c, mx, my, px, py, pw, ph, refs[p], pmv);
                    int dx = br_se(r), dy = br_se(r);
                    mv[0] = pmv[0] + dx;
                    mv[1] = pmv[1] + dy;
                    set_motion(c, mx, my, px, py, pw, ph, mv[0], mv[1],
                               refs[p]);
                    /* quadrant slot: (py/2)*2 + px/2 */
                    int sl = (py >> 1) * 2 + (px >> 1);
                    if (mvdq) {
                        mvdq[k * 8 + 2 * sl] = (int16_t)dx;
                        mvdq[k * 8 + 2 * sl + 1] = (int16_t)dy;
                    }
                    if (refq) {
                        refq[k * 4 + sl] = (int8_t)refs[p];
                        /* fill the partition's second quadrant too */
                        int sl2 = mbt == 1 ? sl + 1 : sl + 2;
                        refq[k * 4 + sl2] = (int8_t)refs[p];
                    }
                }
            } else {
                kind = 4;
                int subt[4], refs[4] = {0, 0, 0, 0};
                for (int sb = 0; sb < 4; sb++) {
                    subt[sb] = (int)br_ue(r);
                    if (subt[sb] > 3)
                        return -5;
                    if (subt[sb] != 0)
                        flags[k] |= 1;
                }
                if (mbt == 3)
                    for (int sb = 0; sb < 4; sb++)
                        refs[sb] = read_ref(r, nref);
                if (part)
                    part[k] = 3;
                static const int SP[4][4][4] = {
                    {{0,0,2,2},{-1,0,0,0},{-1,0,0,0},{-1,0,0,0}},
                    {{0,0,2,1},{0,1,2,1},{-1,0,0,0},{-1,0,0,0}},
                    {{0,0,1,2},{1,0,1,2},{-1,0,0,0},{-1,0,0,0}},
                    {{0,0,1,1},{1,0,1,1},{0,1,1,1},{1,1,1,1}}};
                static const int NP[4] = {1, 2, 2, 4};
                for (int sb = 0; sb < 4; sb++) {
                    int sbx = (sb & 1) * 2, sby = (sb >> 1) * 2;
                    if (refq)
                        refq[k * 4 + sb] = (int8_t)refs[sb];
                    for (int pi = 0; pi < NP[subt[sb]]; pi++) {
                        const int *pp = SP[subt[sb]][pi];
                        int px = sbx + pp[0], py = sby + pp[1];
                        int pw = pp[2], ph = pp[3];
                        int32_t pmv[2], mv[2];
                        mv_pred(c, mx, my, px, py, pw, ph, refs[sb], pmv);
                        int dx = br_se(r), dy = br_se(r);
                        mv[0] = pmv[0] + dx;
                        mv[1] = pmv[1] + dy;
                        set_motion(c, mx, my, px, py, pw, ph, mv[0], mv[1],
                                   refs[sb]);
                        if (mvdq && subt[sb] == 0 && pi == 0) {
                            mvdq[k * 8 + 2 * sb] = (int16_t)dx;
                            mvdq[k * 8 + 2 * sb + 1] = (int16_t)dy;
                        }
                    }
                }
            }
            mb_kind[k] = kind;
            for (int b = 0; b < 16; b++) {
                long o = (long)(4 * my + b / 4) * c->gw + 4 * mx + (b & 3);
                mv4[(k * 16 + b) * 2] = (int16_t)g_mvx[o];
                mv4[(k * 16 + b) * 2 + 1] = (int16_t)g_mvy[o];
                ref4[k * 16 + b] = g_ref[o];
            }
            /* residual tail */
            unsigned code = br_ue(r);
            if (code > 47 || r->error)
                return -5;
            int cbp = CBPP[code];
            int cl = cbp & 15, cc = cbp >> 4;
            cbp_luma[k] = cl;
            cbp_chroma[k] = cc;
            if (transform_8x8 && cl) {
                int t8v = (int)br_u(r, 1);
                if (t8v && !t8out)
                    return -4;  /* decode fast path: no 8x8 recon yet */
                if (t8out)
                    t8out[k] = (uint8_t)t8v;
            }
            if (cbp) {
                int d = br_se(r);
                qp += d;
                if (qpd)
                    qpd[k] = (int8_t)d;
            }
            qp_map[k] = qp;
            for (int blk = 0; blk < 16; blk++) {
                int bx = BLKX[blk], by = BLKY[blk];
                int gx = 4 * mx + bx, gy = 4 * my + by;
                if (cl & (1 << (blk / 4))) {
                    int nc = nc_luma(c, gx, gy);
                    int16_t *dst = lvl16 + (k * 16 + blk) * 16;
                    residual_block(r, luts, nc, 16, dst);
                    g_tc_luma[gy * c->gw + gx] = (uint8_t)count_nz(dst, 16);
                } else
                    g_tc_luma[gy * c->gw + gx] = 0;
            }
            chroma_residuals(r, luts, c, mx, my, cc, cdc + k * 8,
                             cac + k * 120);
        } else {
            /* ---- intra macroblock ---- */
            int it = (int)mbt - intra_off;
            g_dec[k] = 1;
            for (int b = 0; b < 16; b++)
                ref4[k * 16 + b] = -1;
            /* intra blocks are "available, ref -1, mv 0" for prediction */
            set_motion(c, mx, my, 0, 0, 4, 4, 0, 0, -1);
            if (it == 0) {
                /* I_NxN */
                mb_kind[k] = 6;
                if (transform_8x8 && br_u(r, 1))
                    return -4;
                for (int blk = 0; blk < 16; blk++) {
                    int pred = i4_pred_mode(c, mx, my, blk);
                    int m;
                    if (br_u(r, 1)) {
                        m = pred;
                        if (i4prev)
                            i4prev[k * 16 + blk] = 1;
                        if (i4rem)
                            i4rem[k * 16 + blk] = -1;
                    } else {
                        int rem = (int)br_u(r, 3);
                        m = rem < pred ? rem : rem + 1;
                        if (i4rem)
                            i4rem[k * 16 + blk] = (int8_t)rem;
                    }
                    i4modes[k * 16 + blk] = (int8_t)m;
                    int gx = 4 * mx + BLKX[blk], gy = 4 * my + BLKY[blk];
                    g_i4m[gy * c->gw + gx] = (int8_t)m;
                }
                cmode[k] = (int)br_ue(r);
                unsigned code = br_ue(r);
                if (code > 47 || r->error)
                    return -5;
                int cbp = CBPI[code];
                int cl = cbp & 15, cc = cbp >> 4;
                cbp_luma[k] = cl;
                cbp_chroma[k] = cc;
                if (cbp) {
                    int d = br_se(r);
                    qp += d;
                    if (qpd)
                        qpd[k] = (int8_t)d;
                }
                qp_map[k] = qp;
                for (int blk = 0; blk < 16; blk++) {
                    int bx = BLKX[blk], by = BLKY[blk];
                    int gx = 4 * mx + bx, gy = 4 * my + by;
                    if (cl & (1 << (blk / 4))) {
                        int nc = nc_luma(c, gx, gy);
                        int16_t *dst = lvl16 + (k * 16 + blk) * 16;
                        residual_block(r, luts, nc, 16, dst);
                        g_tc_luma[gy * c->gw + gx] =
                            (uint8_t)count_nz(dst, 16);
                    } else
                        g_tc_luma[gy * c->gw + gx] = 0;
                }
            } else {
                /* I16x16: it in 1..24 */
                mb_kind[k] = 5;
                it -= 1;
                i16mode[k] = it % 4;
                int cc = (it / 4) % 3;
                int cl = (it >= 12) ? 15 : 0;
                cbp_luma[k] = cl;
                cbp_chroma[k] = cc;
                cmode[k] = (int)br_ue(r);
                {
                    int d = br_se(r);
                    qp += d;
                    if (qpd)
                        qpd[k] = (int8_t)d;
                }
                qp_map[k] = qp;
                int nc = nc_luma(c, 4 * mx, 4 * my);
                residual_block(r, luts, nc, 16, dc16 + k * 16);
                for (int blk = 0; blk < 16; blk++) {
                    int bx = BLKX[blk], by = BLKY[blk];
                    int gx = 4 * mx + bx, gy = 4 * my + by;
                    if (cl) {
                        int nc2 = nc_luma(c, gx, gy);
                        int16_t *dst = ac15 + (k * 16 + blk) * 15;
                        residual_block(r, luts, nc2, 15, dst);
                        g_tc_luma[gy * c->gw + gx] =
                            (uint8_t)count_nz(dst, 15);
                    } else
                        g_tc_luma[gy * c->gw + gx] = 0;
                }
            }
            chroma_residuals(r, luts, c, mx, my, cbp_chroma[k], cdc + k * 8,
                             cac + k * 120);
        }
        if (r->error)
            return -5;
        k++;
        if (!inter && k < n && !br_more(r))
            return -5;
    }
    if (r->error)
        return -5;
    return k;
}

/* ----------------------------------------------------------------------
 * B-slice raw-syntax parser (entropy transcode support).
 *
 * Scope = exactly the B syntax this framework's encoder emits
 * (encode/device.py encode_b_frame): B_Skip / B_Direct_16x16 /
 * B_{L0,L1,Bi}_16x16, one reference per list (no ref_idx bits), no
 * partitions.  Motion is NOT resolved (the CABAC re-coder needs raw mvd
 * only); residual nc contexts reuse the slice-global total_coeff maps.
 * Returns n on success; -2 on unsupported mb_type, -5 on parse error.
 */
long cavlc_parse_b_slice(
    const uint8_t *rbsp, long nbytes, long bitpos,
    int mbh, int mbw, int qp_init,
    const uint16_t *luts,
    int8_t *mode,                      /* (n,) -1 skip, 0..3 otherwise */
    int16_t *mvd0, int16_t *mvd1,      /* (n,2) raw mvd per list */
    int32_t *cbp_luma, int32_t *cbp_chroma,
    int16_t *lvl16,                    /* (n,16,16) block decode order */
    int16_t *cdc,                      /* (n,2,4) */
    int16_t *cac,                      /* (n,2,4,15) */
    int8_t *qpd,                       /* (n,) raw mb_qp_delta */
    int transform_8x8, uint8_t *t8out)
{
    if (mbh > MAXH || mbw > MAXW)
        return -6;
    Ctx ctx = {mbh, mbw, 4 * mbw, 1};
    Ctx *c = &ctx;
    long n = (long)mbh * mbw;
    memset(g_dec, 0, (size_t)n);
    memset(g_tc_luma, 0, (size_t)(16 * n));
    memset(g_tc_cu, 0, (size_t)(4 * n));
    memset(g_tc_cv, 0, (size_t)(4 * n));
    BR br, *r = &br;
    br_init(r, rbsp, nbytes, bitpos);
    int qp = qp_init;
    long k = 0;
    while (k < n) {
        long run = br_ue(r);
        if (r->error)
            return -5;
        while (run-- > 0 && k < n) {
            mode[k] = -1;           /* B_Skip */
            g_dec[k] = 1;
            k++;
        }
        if (k >= n)
            break;
        if (!br_more(r))
            break;
        int mx = (int)(k % mbw), my = (int)(k / mbw);
        unsigned mbt = br_ue(r);
        if (r->error)
            return -5;
        if (mbt > 3)
            return -2;              /* partitions / intra-in-B: fall back */
        g_dec[k] = 1;
        mode[k] = (int8_t)mbt;
        if (mbt == 1 || mbt == 3) {
            mvd0[k * 2] = (int16_t)br_se(r);
            mvd0[k * 2 + 1] = (int16_t)br_se(r);
        }
        if (mbt == 2 || mbt == 3) {
            mvd1[k * 2] = (int16_t)br_se(r);
            mvd1[k * 2 + 1] = (int16_t)br_se(r);
        }
        unsigned code = br_ue(r);
        if (code > 47 || r->error)
            return -5;
        int cbp = CBPP[code];
        int cl = cbp & 15, cc = cbp >> 4;
        cbp_luma[k] = cl;
        cbp_chroma[k] = cc;
        if (transform_8x8 && cl) {
            int t8v = (int)br_u(r, 1);
            if (t8out)
                t8out[k] = (uint8_t)t8v;
        }
        if (cbp) {
            int d = br_se(r);
            qp += d;
            qpd[k] = (int8_t)d;
        }
        for (int blk = 0; blk < 16; blk++) {
            int bx = BLKX[blk], by = BLKY[blk];
            int gx = 4 * mx + bx, gy = 4 * my + by;
            if (cl & (1 << (blk / 4))) {
                int nc = nc_luma(c, gx, gy);
                int16_t *dst = lvl16 + (k * 16 + blk) * 16;
                residual_block(r, luts, nc, 16, dst);
                g_tc_luma[gy * c->gw + gx] = (uint8_t)count_nz(dst, 16);
            } else
                g_tc_luma[gy * c->gw + gx] = 0;
        }
        chroma_residuals(r, luts, c, mx, my, cc, cdc + k * 8, cac + k * 120);
        if (r->error)
            return -5;
        k++;
    }
    if (r->error)
        return -5;
    return k;
}
