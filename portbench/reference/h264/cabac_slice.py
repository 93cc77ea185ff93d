# Frozen copy of x264vfw_tpu_torch/bitstream/cabac_slice.py at commit 4a379f6, the benchmark's
# reference decoder: its imports are rewritten to this folder, and its
# three unbounded unary loops raise past the largest value a conforming
# stream codes (a damaged slice raises instead of reading forever).
"""CABAC slice coding: binarization + context modeling (§9.3.2/9.3.3).

Covers the syntax the encoder emits, 4:2:0: I slices of I_16x16 and
I_NxN macroblocks, P slices of P_Skip and P_L0 16x16 / 16x8 / 8x16 /
8x8 macroblocks with ref_idx and mb_qp_delta, B slices of B_Skip,
B_Direct_16x16 and 16x16 L0 / L1 / Bi macroblocks (the reader also the
8x8 transform and sub-8x8 partitions).

Design: every syntax routine is written ONCE against a bin-IO abstraction
(`_Writer` / `_Reader`) and therefore serves both the encoder and the
decoder — the two directions are symmetric by construction, so the decoder
(validated against stock libavcodec on real x264 CABAC streams) proves the
encoder's context modeling.

Capability replaced: libx264's CABAC entropy coder and the FFmpeg decoder's
CABAC parse (SURVEY §2c).  In the port it is the host decoder's CABAC
reader (decode/decoder.py) and, writing, the plain version of the C
coder (bitstream/cabac_native.py) that the encoder's CABAC paths call;
only the tests write with it.
"""

from __future__ import annotations

import numpy as np

from .cabac import CabacDecoder, CabacEncoder, init_contexts

# ctxBlockCat offsets
CBF_OFF = {0: 0, 1: 4, 2: 8, 3: 12, 4: 16}       # + 85
SIG_OFF = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}     # + 105 / + 166
ABS_OFF = {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}     # + 227

# cat-5 (luma 8x8) position->ctx maps, frame-coded (Table 9-43);
# significant_coeff at 402 + map, last_significant at 417 + map,
# coeff_abs_level at 426; no coded_block_flag for cat 5
SIG8_MAP = np.array([
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12],
    dtype=np.int32)
LAST8_MAP = np.array([
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8],
    dtype=np.int32)

# luma 4x4 block coding order -> raster (bx, by) within MB
BLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])

# P sub_mb_type -> partition list (ox, oy, w, h) in 4x4 units within the
# 8x8 sub-block (Table 7-17)
_PSUB_PARTS = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (0, 1, 2, 1)],
    2: [(0, 0, 1, 2), (1, 0, 1, 2)],
    3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
}


class _Writer:
    def __init__(self, enc: CabacEncoder):
        self.enc = enc

    def decision(self, ctx, val):
        self.enc.decision(ctx, int(val))
        return int(val)

    def bypass(self, val):
        self.enc.bypass(int(val))
        return int(val)

    def terminate(self, val):
        self.enc.terminate(int(val))
        return int(val)


class _Reader:
    def __init__(self, dec: CabacDecoder):
        self.dec = dec

    def decision(self, ctx, val=None):
        return self.dec.decision(ctx)

    def bypass(self, val=None):
        return self.dec.bypass()

    def terminate(self, val=None):
        return self.dec.terminate()


def _ueg(io, ctxs, k, ucoff, value=None, signed=True):
    """UEGk: TU prefix (ctx-coded) + EGk bypass suffix + optional sign.
    Writer: pass signed `value`. Reader: value=None, returns signed value."""
    write = value is not None
    mag = abs(value) if write else None
    v = 0
    while v < ucoff:
        b = io.decision(ctxs[min(v, len(ctxs) - 1)],
                        (1 if (write and mag > v) else 0) if write else None)
        if not b:
            break
        v += 1
    if v == ucoff:
        kk = k
        while True:
            b = io.bypass((1 if (write and mag - v >= (1 << kk)) else 0)
                          if write else None)
            if not b:
                break
            v += 1 << kk
            kk += 1
            if kk > 32:
                raise ValueError("UEGk suffix past 32 bits")
        rem = (mag - v) if write else 0
        for i in range(kk - 1, -1, -1):
            bit = io.bypass((rem >> i) & 1 if write else None)
            if not write:
                v += bit << i
        if write:
            v = mag
    if signed and v:
        s = io.bypass(int(value < 0) if write else None)
        return -v if s else v
    return v


class CabacSliceBase:
    """Shared context maps + syntax routines (direction-agnostic)."""

    def __init__(self, io, qp: int, intra: bool, mbh: int, mbw: int):
        self.io = io
        self.intra = intra
        self.mbh, self.mbw = mbh, mbw
        self.skip = np.zeros((mbh, mbw), bool)
        self.coded = np.zeros((mbh, mbw), bool)
        self.cbp_luma = np.zeros((mbh, mbw), np.int32)
        self.cbp_chroma = np.zeros((mbh, mbw), np.int32)
        # mvd/ref neighbour maps: the mvd/ref ctxIdxInc reads the
        # partition covering the neighbouring 4x4 block, so the maps are
        # 4x4-block granularity (sub-8x8 partitions have distinct mvds;
        # >=8x8 partitions write their full extent so neighbor reads are
        # identical to the old 8x8-granular maps)
        self.mvd = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)   # list 0
        self.mvd1 = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)  # list 1
        self.ref8 = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.ref81 = np.zeros((4 * mbh, 4 * mbw), np.int32)    # list 1
        self.direct = np.zeros((mbh, mbw), bool)           # B_Skip/B_Direct
        self.cbf4 = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.cbf_dc = np.zeros((mbh, mbw), np.int32)
        self.is_i16 = np.zeros((mbh, mbw), bool)
        self.cbf_cdc = np.zeros((mbh, mbw, 2), np.int32)
        self.cbf_cac = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
        self.cmode = np.zeros((mbh, mbw), np.int32)
        self.is_inxn = np.zeros((mbh, mbw), bool)
        self.is_intra = np.zeros((mbh, mbw), bool)
        self.t8 = np.zeros((mbh, mbw), bool)   # transform_size_8x8_flag
        self.prev_qp_delta_nz = 0

    def t8_flag(self, mx, my, val=None):
        """transform_size_8x8_flag (ctx 399 + neighbor flags)."""
        def cond(x, y):
            if not self.avail(x, y) or not self.coded[y, x]:
                return 0
            return int(self.t8[y, x])
        v = self.io.decision(399 + cond(mx - 1, my) + cond(mx, my - 1),
                             val)
        self.t8[my, mx] = bool(v)
        return v

    def avail(self, mx, my):
        # neighbor availability is slice-scoped (§6.4.9): a fresh
        # reader/writer is created per slice, so everything before
        # first_mb belongs to another slice
        return (0 <= mx < self.mbw and my >= 0
                and my * self.mbw + mx >= getattr(self, "first_mb", 0))

    # ---------------- residual block ----------------
    def residual(self, cat, cbf_inc, coeffs=None, n=None):
        """Writer: pass coeffs (scan order). Reader: pass n; returns array.

        cat 5 (luma 8x8, High profile) has no coded_block_flag and uses
        position-MAPPED significance contexts (Table 9-43)."""
        io = self.io
        write = coeffs is not None
        if write:
            n = len(coeffs)
        if cat == 5:
            cbf = 1
            def sig_ctx(i):
                return 402 + int(SIG8_MAP[i])
            def last_ctx(i):
                return 417 + int(LAST8_MAP[i])
            abs_base = 426
        else:
            cbf = io.decision(85 + CBF_OFF[cat] + cbf_inc,
                              int((coeffs != 0).any()) if write else None)
            def sig_ctx(i):
                return 105 + SIG_OFF[cat] + i
            def last_ctx(i):
                return 166 + SIG_OFF[cat] + i
            abs_base = 227 + ABS_OFF[cat]
        out = np.zeros(n, np.int32)
        if not cbf:
            return (0, coeffs if write else out)
        if write:
            nz = coeffs != 0
            last = int(np.max(np.nonzero(nz)[0]))
        sig = np.zeros(n, bool)
        lastpos = n - 1
        for i in range(n - 1):
            s = io.decision(sig_ctx(i),
                            int(nz[i]) if write else None)
            sig[i] = bool(s)
            if s:
                l_ = io.decision(last_ctx(i),
                                 int(i == last) if write else None)
                if l_:
                    lastpos = i
                    break
        else:
            sig[n - 1] = True
        if write:
            lastpos = last
        else:
            sig[lastpos] = True
        num_eq1 = num_gt1 = 0
        for i in range(lastpos, -1, -1):
            if not (nz[i] if write else sig[i]):
                continue
            c0 = abs_base + (0 if num_gt1 else min(4, 1 + num_eq1))
            c1 = abs_base + 5 + min(4, num_gt1)
            v = _ueg(self.io, [c0, c1], 0, 14,
                     value=(int(coeffs[i]) - (1 if coeffs[i] > 0 else -1))
                     if write else None, signed=False)
            # magnitude-1 coded; sign separate (always present)
            s = io.bypass(int(coeffs[i] < 0) if write else None)
            mag = v + 1
            out[i] = -mag if s else mag
            if v == 0:
                num_eq1 += 1
            else:
                num_gt1 += 1
        return (1, coeffs if write else out)

    # ---------------- cbf ctx increments (§9.3.3.1.1.9) ----------------
    # unavailable neighbors (picture edge OR other slice) read as coded
    # when the current MB is intra, uncoded otherwise
    def cbf_inc_luma4(self, mx, my, bx, by, intra_mb):
        gx, gy = 4 * mx + bx, 4 * my + by

        def cond(x, y):
            if x < 0 or y < 0 or not self.avail(x // 4, y // 4):
                return 1 if intra_mb else 0
            return int(self.cbf4[y, x])

        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1)

    def cbf_inc_dc(self, mx, my, intra_mb):
        def cond(x, y):
            if x < 0 or y < 0 or not self.avail(x, y):
                return 1 if intra_mb else 0
            if not self.is_i16[y, x]:
                return 0
            return int(self.cbf_dc[y, x])

        return cond(mx - 1, my) + 2 * cond(mx, my - 1)

    def cbf_inc_cdc(self, mx, my, pl, intra_mb):
        def cond(x, y):
            if x < 0 or y < 0 or not self.avail(x, y):
                return 1 if intra_mb else 0
            return int(self.cbf_cdc[y, x, pl])

        return cond(mx - 1, my) + 2 * cond(mx, my - 1)

    def cbf_inc_cac(self, mx, my, sb, pl, intra_mb):
        gx, gy = 2 * mx + (sb & 1), 2 * my + (sb >> 1)

        def cond(x, y):
            if x < 0 or y < 0 or not self.avail(x // 2, y // 2):
                return 1 if intra_mb else 0
            return int(self.cbf_cac[y, x, pl])

        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1)

    # ---------------- element coders ----------------
    def skip_flag(self, mx, my, skipped=None, base=11):
        def cond(x, y):
            if not self.avail(x, y):
                return 0
            return 0 if self.skip[y, x] else 1

        # P: ctx 11..13, B: ctx 24..26; ctxIdxInc = condTermA + condTermB
        v = self.io.decision(base + cond(mx - 1, my) + cond(mx, my - 1),
                             int(skipped) if skipped is not None else None)
        self.skip[my, mx] = bool(v)
        return bool(v)

    def mvd_comp(self, qx, qy, comp, val=None, lst=0):
        """qx/qy: 8x8-grid coords of the partition's first block."""
        mvd_f = self.mvd if lst == 0 else self.mvd1

        def absmvd(x, y):
            if x < 0 or y < 0 or x >= 4 * self.mbw:
                return 0
            return abs(int(mvd_f[y, x, comp]))

        s = absmvd(qx - 1, qy) + absmvd(qx, qy - 1)
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        off = 40 if comp == 0 else 47
        v = _ueg(self.io, [off + inc, off + 3, off + 4, off + 5, off + 6],
                 3, 9, value=val)
        return v

    def ref_idx(self, qx, qy, val=None, lst=0):
        """ref_idx_lX bins (9.3.3.1.1.6): unary, bin0 ctx 54 +
        condA + 2*condB (condTerm = neighbour partition refIdx > 0),
        later bins ctx 58/59."""
        io = self.io
        ref_f = self.ref8 if lst == 0 else self.ref81

        def cond(x, y):
            if x < 0 or y < 0 or x >= 4 * self.mbw:
                return 0
            return 1 if ref_f[y, x] > 0 else 0

        inc = cond(qx - 1, qy) + 2 * cond(qx, qy - 1)
        write = val is not None
        b = io.decision(54 + inc, int(val > 0) if write else None)
        if not b:
            return 0
        v = 1
        while True:
            bit = io.decision(58 if v == 1 else 59,
                              (1 if v < val else 0) if write else None)
            if not bit:
                return v
            v += 1
            if v > 32:
                raise ValueError("ref_idx past 32")

    def b_mb_type(self, mx, my, val=None):
        """B-slice mb_type bins (ctxIdxOffset 27, Table 9-37 shape as
        implemented by x264/FFmpeg).  val: Table 7-14 value to write, or
        None to read.  Returns the value; intra returns ('intra',) and the
        caller reads the intra suffix (ctx base 32)."""
        io = self.io

        def cond(x, y):
            if not self.avail(x, y) or not self.coded[y, x]:
                return 0
            return 0 if (self.skip[y, x] or self.direct[y, x]) else 1

        inc = cond(mx - 1, my) + cond(mx, my - 1)
        write = val is not None
        num = (23 if isinstance(val, tuple) else val) if write else None
        b0 = io.decision(27 + inc, int(num != 0) if write else None)
        if not b0:
            return 0
        b1 = io.decision(27 + 3, int(num > 2) if write else None)
        if not b1:
            b = io.decision(27 + 5, int(num == 2) if write else None)
            return 1 + b
        # 4-bin field (then maybe one more for values 12..21)
        if write:
            if num >= 23:                       # intra suffix follows
                bits = 13
            elif num <= 10:
                bits = num - 3
            elif num == 11:
                bits = 14
            elif num == 22:
                bits = 15
            else:                               # 12..21 -> 5-bin (num+4)
                bits = (num + 4) >> 1
        else:
            bits = 0
        got = io.decision(27 + 4, (bits >> 3) & 1 if write else None) << 3
        got |= io.decision(27 + 5, (bits >> 2) & 1 if write else None) << 2
        got |= io.decision(27 + 5, (bits >> 1) & 1 if write else None) << 1
        got |= io.decision(27 + 5, bits & 1 if write else None)
        if got < 8:
            return got + 3
        if got == 13:
            return ("intra",)
        if got == 14:
            return 11
        if got == 15:
            return 22
        extra = io.decision(27 + 5, ((num + 4) & 1) if write else None)
        return ((got << 1) | extra) - 4

    def b_intra_suffix(self, val=None):
        """Intra mb_type suffix in B slices (ctx base 32)."""
        io = self.io
        b0 = io.decision(32, 1 if val is not None else None)
        if not b0:
            return ("i4",)
        if io.terminate(0 if val is not None else None):
            raise NotImplementedError("I_PCM")
        return ("i16",) + self._i16_type_bins(33, 34, 34, 35, 35, val)

    def p_sub_type(self, val=None):
        """P sub_mb_type bins (Table 9-38, ctx 21-23):
        '1'->8x8, '00'->8x4, '011'->4x8, '010'->4x4."""
        io = self.io
        w = val is not None
        if io.decision(21, (1 if val == 0 else 0) if w else None):
            return 0
        if not io.decision(22, (0 if val == 1 else 1) if w else None):
            return 1
        return 2 if io.decision(23, (1 if val == 2 else 0)
                                if w else None) else 3

    def b_sub_type(self, val=None):
        """B sub_mb_type bins (Table 9-38, ctx 36-39)."""
        io = self.io
        w = val is not None
        if not io.decision(36, (0 if val == 0 else 1) if w else None):
            return 0
        if not io.decision(37, (0 if val in (1, 2) else 1) if w else None):
            return 1 + io.decision(39, (val - 1) if w else None)
        if io.decision(38, (0 if 3 <= val <= 6 else 1) if w else None):
            if io.decision(39, (1 if val >= 11 else 0) if w else None):
                return 11 + io.decision(39, (val - 11) if w else None)
            base = 7
        else:
            base = 3
        hi = io.decision(39, ((val - base) >> 1) & 1 if w else None)
        lo = io.decision(39, (val - base) & 1 if w else None)
        return base + 2 * hi + lo

    def cbp(self, mx, my, cbp_l=None, cbp_c=None):
        io = self.io

        def luma_bit(x, y, b):
            if not self.avail(x, y):
                return None
            return (int(self.cbp_luma[y, x]) >> b) & 1

        cur = 0
        for b in range(4):
            bx, by = b & 1, b >> 1
            la = luma_bit(mx - 1, my, b + 1) if bx == 0 else (cur >> (b - 1)) & 1
            tb = luma_bit(mx, my - 1, b + 2) if by == 0 else (cur >> (b - 2)) & 1
            conda = 0 if la is None else (1 - la)
            condb = 0 if tb is None else (1 - tb)
            bit = io.decision(73 + conda + 2 * condb,
                              ((cbp_l >> b) & 1) if cbp_l is not None else None)
            cur |= bit << b

        def cc(x, y):
            if not self.avail(x, y):
                return 0
            return int(self.cbp_chroma[y, x])

        a, bb = cc(mx - 1, my), cc(mx, my - 1)
        c0 = io.decision(77 + (a != 0) + 2 * (bb != 0),
                         int(cbp_c != 0) if cbp_c is not None else None)
        c = 0
        if c0:
            c = 1 + io.decision(77 + 4 + (a == 2) + 2 * (bb == 2),
                                int(cbp_c == 2) if cbp_c is not None else None)
        return cur, c

    def qp_delta(self, val=None):
        # binarization: mapped-unary TU over |2*qpd| +- ; we only use 0
        b0 = self.io.decision(60 + self.prev_qp_delta_nz,
                              (1 if val else 0) if val is not None else None)
        if not b0:
            self.prev_qp_delta_nz = 0
            return 0
        # value != 0: unary continuation with ctx 62, 63...
        k = 1
        while True:
            b = self.io.decision(62 if k == 1 else 63,
                                 (1 if val is not None and k < _qpd_bins(val)
                                  else 0) if val is not None else None)
            if not b:
                break
            k += 1
            if k > 52:
                raise ValueError("mb_qp_delta past its range")
        self.prev_qp_delta_nz = 1
        # mapped: k -> qpd: odd k -> (k+1)//2, even -> -(k//2)
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def i_mb_type(self, mx, my, val=None):
        """I-slice mb_type (§9.3.2.5 / Table 9-39, ctxIdxOffset 3).

        Writing: pass ("i4",) for I_NxN or (acflag, cbp_c, pred) for
        I16x16.  Reading: returns ("i4",) for I_NxN or ("i16", acflag,
        cbp_c, pred); raises on I_PCM."""
        io = self.io

        def cond(x, y):
            if not self.avail(x, y) or not self.coded[y, x]:
                return 0
            return 0 if self.is_inxn[y, x] else 1

        writing = val is not None
        is_i4_w = writing and len(val) == 1
        b0 = io.decision(3 + cond(mx - 1, my) + cond(mx, my - 1),
                         (0 if is_i4_w else 1) if writing else None)
        if not b0:
            return ("i4",)
        if io.terminate(0 if val is not None else None):
            raise NotImplementedError("I_PCM")
        return ("i16",) + self._i16_type_bins(6, 7, 8, 9, 10, val)

    def _i16_type_bins(self, c_ac, c_c0, c_c1, c_p0, c_p1, val):
        io = self.io
        ac = io.decision(c_ac, int(val[0]) if val is not None else None)
        c0 = io.decision(c_c0, int(val[1] != 0) if val is not None else None)
        cbc = 0
        if c0:
            cbc = 1 + io.decision(c_c1,
                                  int(val[1] == 2) if val is not None else None)
        b5 = io.decision(c_p0, (val[2] >> 1) & 1 if val is not None else None)
        b6 = io.decision(c_p1, val[2] & 1 if val is not None else None)
        return bool(ac), cbc, (b5 << 1) | b6

    def p_intra_suffix(self, val=None):
        """mb_type intra suffix in P slices (ctxIdxOffset 17)."""
        io = self.io
        b0 = io.decision(17, 1 if val is not None else None)
        if not b0:
            return ("i4",)
        if io.terminate(0 if val is not None else None):
            raise NotImplementedError("I_PCM")
        return ("i16",) + self._i16_type_bins(18, 19, 19, 20, 20, val)

    def i4_pred_bins(self, prev=None, rem=None):
        """One block's intra4x4 mode bins: prev_intra4x4_pred_mode_flag
        (ctx 68) + rem_intra4x4_pred_mode (3 FL bins, ctx 69, LSB first)."""
        io = self.io
        p = io.decision(68, int(prev) if prev is not None else None)
        if p:
            return True, 0
        r = 0
        for i in range(3):
            r |= io.decision(69, ((rem >> i) & 1) if rem is not None else None) << i
        return False, r

    def chroma_pred_mode(self, mx, my, val=None):
        io = self.io

        def cond(x, y):
            if not self.avail(x, y) or not self.coded[y, x]:
                return 0
            return int(self.cmode[y, x] != 0)

        inc = cond(mx - 1, my) + cond(mx, my - 1)
        v = 0
        while v < 3:
            b = io.decision(64 + inc if v == 0 else 67,
                            (1 if val is not None and val > v else 0)
                            if val is not None else None)
            if not b:
                break
            v += 1
        self.cmode[my, mx] = v
        return v


def _qpd_bins(val):
    # mapped unary bin count for qp_delta value
    return 2 * abs(val) - (1 if val > 0 else 0)


class CabacSlice(CabacSliceBase):
    """Encoder-facing wrapper (keeps the original write API)."""

    def __init__(self, qp, intra, mbh, mbw, cabac_init_idc=0):
        st, mps = init_contexts(intra, qp, cabac_init_idc)
        self.enc = CabacEncoder(st, mps)
        super().__init__(_Writer(self.enc), qp, intra, mbh, mbw)

    def p_mb(self, mx, my, skipped, mv_d, cbp_l, cbp_c, levels16,
             dc_u, dc_v, ac_u, ac_v, qpd=0, part=0, ref=0, nref=1):
        """mv_d: (2,) for 16x16 or (4, 2) quadrant-raster mvd slots
        with part in {0:16x16, 1:16x8, 2:8x16, 3:P_8x8}."""
        self.coded[my, mx] = True
        if self.skip_flag(mx, my, skipped):
            self.prev_qp_delta_nz = 0
            return
        io = self.io
        mv4 = np.zeros((4, 2), np.int32)
        mv_d = np.asarray(mv_d, np.int32)
        if mv_d.size == 2:
            mv4[0] = mv_d
        else:
            mv4 = mv_d.reshape(4, 2)
        # mb_type bins (Table 9-37 strings 000/011/010/001)
        io.decision(14, 0)
        if part in (0, 3):
            io.decision(15, 0)
            io.decision(16, int(part == 3))
        else:
            io.decision(15, 1)
            io.decision(17, int(part == 1))
        if part == 3:
            for _ in range(4):
                io.decision(21, 1)       # sub_mb_type P_L0_8x8
        POS = {0: [(0, 0)], 1: [(0, 0), (0, 1)],
               2: [(0, 0), (1, 0)], 3: [(0, 0), (1, 0), (0, 1), (1, 1)]}
        SIZ = {0: (4, 4), 1: (4, 2), 2: (2, 4), 3: (2, 2)}
        bx0, by0 = 4 * mx, 4 * my
        if nref > 1:
            pw, ph = SIZ[part] if part != 3 else (2, 2)
            for (ox, oy) in POS[part]:
                qx, qy = bx0 + 2 * ox, by0 + 2 * oy
                self.ref_idx(qx, qy, int(ref))
                self.ref8[qy:qy + ph, qx:qx + pw] = int(ref)
        for (ox, oy) in POS[part]:
            sl = oy * 2 + ox
            vx, vy = int(mv4[sl, 0]), int(mv4[sl, 1])
            qx, qy = bx0 + 2 * ox, by0 + 2 * oy
            self.mvd_comp(qx, qy, 0, vx)
            self.mvd_comp(qx, qy, 1, vy)
            pw, ph = SIZ[part]
            self.mvd[qy:qy + ph, qx:qx + pw] = (vx, vy)
            self.ref8[qy:qy + ph, qx:qx + pw] = int(ref)
        self.cbp(mx, my, cbp_l, cbp_c)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return
        self.qp_delta(int(qpd))
        for blk in range(16):
            if not (cbp_l >> (blk // 4)) & 1:
                continue
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            inc = self.cbf_inc_luma4(mx, my, bx, by, False)
            cbf, _ = self.residual(2, inc, coeffs=levels16[blk])
            self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._chroma_res(mx, my, cbp_c, False,
                         dc_u=dc_u, dc_v=dc_v, ac_u=ac_u, ac_v=ac_v)

    def b_mb(self, mx, my, skipped, mode, mvd0, mvd1, cbp_l, cbp_c,
             levels16, dc_u, dc_v, ac_u, ac_v):
        """One B macroblock: B_Skip / B_Direct_16x16 / B_{L0,L1,Bi}_16x16.
        mode: 0=direct, 1=L0, 2=L1, 3=Bi (Table 7-14)."""
        self.coded[my, mx] = True
        if self.skip_flag(mx, my, skipped, base=24):
            self.direct[my, mx] = True
            self.prev_qp_delta_nz = 0
            return
        io = self.io
        self.b_mb_type(mx, my, mode)
        self.direct[my, mx] = mode == 0
        if mode in (1, 3):
            self.mvd_comp(4 * mx, 4 * my, 0, int(mvd0[0]), lst=0)
            self.mvd_comp(4 * mx, 4 * my, 1, int(mvd0[1]), lst=0)
            self.mvd[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = mvd0
        if mode in (2, 3):
            self.mvd_comp(4 * mx, 4 * my, 0, int(mvd1[0]), lst=1)
            self.mvd_comp(4 * mx, 4 * my, 1, int(mvd1[1]), lst=1)
            self.mvd1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = mvd1
        self.cbp(mx, my, cbp_l, cbp_c)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return
        self.qp_delta(0)
        for blk in range(16):
            if not (cbp_l >> (blk // 4)) & 1:
                continue
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            inc = self.cbf_inc_luma4(mx, my, bx, by, False)
            cbf, _ = self.residual(2, inc, coeffs=levels16[blk])
            self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._chroma_res(mx, my, cbp_c, False,
                         dc_u=dc_u, dc_v=dc_v, ac_u=ac_u, ac_v=ac_v)

    def i4_mb(self, mx, my, prevs, rems, cmode, cbp_l, cbp_c,
              levels16, dc_u, dc_v, ac_u, ac_v, qpd=0):
        """One I_NxN macroblock (write side, mirror of read_i4_mb_body):
        prevs (16,) prev_intra4x4_pred_mode_flag, rems (16,)
        rem_intra4x4_pred_mode (used where prevs is 0), levels16 (16, 16)
        zigzag decode-order luma blocks."""
        self.i_mb_type(mx, my, ("i4",))
        self.coded[my, mx] = True
        self.is_intra[my, mx] = True
        self.is_inxn[my, mx] = True
        for b in range(16):
            p = bool(prevs[b])
            self.i4_pred_bins(prev=p, rem=None if p else int(rems[b]))
        self.chroma_pred_mode(mx, my, int(cmode))
        self.cbp(mx, my, int(cbp_l), int(cbp_c))
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return
        self.qp_delta(int(qpd))
        for blk in range(16):
            if not (cbp_l >> (blk // 4)) & 1:
                continue
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            inc = self.cbf_inc_luma4(mx, my, bx, by, True)
            cbf, _ = self.residual(2, inc, coeffs=levels16[blk])
            self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._chroma_res(mx, my, cbp_c, True,
                         dc_u=dc_u, dc_v=dc_v, ac_u=ac_u, ac_v=ac_v)

    def i16_mb(self, mx, my, pred, cmode, ac_flag, cbp_c, dc16,
               ac, dc_u, dc_v, ac_u, ac_v):
        self.i_mb_type(mx, my, (ac_flag, cbp_c, pred))
        self.coded[my, mx] = True
        self.is_intra[my, mx] = True
        self.is_i16[my, mx] = True
        self.cbp_luma[my, mx] = 15 if ac_flag else 0
        self.cbp_chroma[my, mx] = cbp_c
        self.chroma_pred_mode(mx, my, cmode)
        self.qp_delta(0)
        cbf, _ = self.residual(0, self.cbf_inc_dc(mx, my, True), coeffs=dc16)
        self.cbf_dc[my, mx] = cbf
        if ac_flag:
            for blk in range(16):
                bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
                inc = self.cbf_inc_luma4(mx, my, bx, by, True)
                cbf, _ = self.residual(1, inc, coeffs=ac[blk])
                self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._chroma_res(mx, my, cbp_c, True,
                         dc_u=dc_u, dc_v=dc_v, ac_u=ac_u, ac_v=ac_v)

    def _chroma_res(self, mx, my, cbp_c, intra_mb, dc_u, dc_v, ac_u, ac_v):
        if cbp_c >= 1:
            for pl, dc in ((0, dc_u), (1, dc_v)):
                inc = self.cbf_inc_cdc(mx, my, pl, intra_mb)
                cbf, _ = self.residual(3, inc, coeffs=dc)
                self.cbf_cdc[my, mx, pl] = cbf
        if cbp_c == 2:
            for pl, acp in ((0, ac_u), (1, ac_v)):
                for sb in range(4):
                    inc = self.cbf_inc_cac(mx, my, sb, pl, intra_mb)
                    cbf, _ = self.residual(4, inc, coeffs=acp[sb])
                    gy, gx = 2 * my + (sb >> 1), 2 * mx + (sb & 1)
                    self.cbf_cac[gy, gx, pl] = cbf

    def end_mb(self, last: bool) -> None:
        self.io.terminate(int(last))

    def payload(self) -> bytes:
        return self.enc.bytes()


class CabacSliceReader(CabacSliceBase):
    """Decoder-facing mirror: same routines in read mode."""

    def __init__(self, qp, intra, mbh, mbw, data: bytes, cabac_init_idc=0):
        st, mps = init_contexts(intra, qp, cabac_init_idc)
        self.dec = CabacDecoder(st, mps, data)
        super().__init__(_Reader(self.dec), qp, intra, mbh, mbw)

    def read_p_mb(self, mx, my):
        """Returns dict with skip/mvd/cbp/levels arrays."""
        self.coded[my, mx] = True
        if self.skip_flag(mx, my):
            self.prev_qp_delta_nz = 0
            return {"skip": True}
        io = self.io
        b0 = io.decision(14)
        if b0:
            t = self.p_intra_suffix()
            out = self._read_intra_common(mx, my, t)
            out["intra"] = True
            out["skip"] = False
            return out
        b1 = io.decision(15)
        b2 = io.decision(16 if b1 == 0 else 17)
        # Table 9-37 strings 000/011/010/001 -> 16x16/16x8/8x16/P_8x8
        part = (0 if not b2 else 3) if b1 == 0 else (1 if b2 else 2)
        subt = [0, 0, 0, 0]
        if part == 3:
            subt = [self.p_sub_type() for _ in range(4)]
        nref = getattr(self, "num_ref_l0", 1)
        POS = {0: [(0, 0)], 1: [(0, 0), (0, 1)],
               2: [(0, 0), (1, 0)], 3: [(0, 0), (1, 0), (0, 1), (1, 1)]}
        SIZ = {0: (4, 4), 1: (4, 2), 2: (2, 4), 3: (2, 2)}
        bx0, by0 = 4 * mx, 4 * my
        refs4 = np.zeros(4, np.int32)
        if nref > 1:
            pw, ph = SIZ[part] if part != 3 else (2, 2)
            for (ox, oy) in POS[part]:
                qx, qy = bx0 + 2 * ox, by0 + 2 * oy
                refs4[oy * 2 + ox] = self.ref_idx(qx, qy)
                self.ref8[qy:qy + ph, qx:qx + pw] = refs4[oy * 2 + ox]
        mvd4 = np.zeros((4, 2), np.int32)
        mvd_sub = None
        if part == 3 and any(subt):
            # sub-8x8 partitions: per-part mvds at 4x4 ctx granularity
            mvd_sub = [[] for _ in range(4)]
            for sb in range(4):
                sbx, sby = bx0 + 2 * (sb & 1), by0 + 2 * (sb >> 1)
                self.ref8[sby:sby + 2, sbx:sbx + 2] = refs4[sb]
                for (ox, oy, pw, ph) in _PSUB_PARTS[subt[sb]]:
                    qx, qy = sbx + ox, sby + oy
                    d = np.array([self.mvd_comp(qx, qy, 0),
                                  self.mvd_comp(qx, qy, 1)], np.int32)
                    mvd_sub[sb].append(d)
                    self.mvd[qy:qy + ph, qx:qx + pw] = d
            mvd4[:] = [m[0] for m in mvd_sub]
        else:
            for (ox, oy) in POS[part]:
                sl = oy * 2 + ox
                qx, qy = bx0 + 2 * ox, by0 + 2 * oy
                mvd4[sl, 0] = self.mvd_comp(qx, qy, 0)
                mvd4[sl, 1] = self.mvd_comp(qx, qy, 1)
                pw, ph = SIZ[part]
                self.mvd[qy:qy + ph, qx:qx + pw] = mvd4[sl]
                self.ref8[qy:qy + ph, qx:qx + pw] = refs4[sl]
        mvd = mvd4[0]
        cbp_l, cbp_c = self.cbp(mx, my)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        out = {"skip": False, "intra": False, "mvd": mvd,
               "part": part, "mvd4": mvd4, "refs4": refs4,
               "subt": (subt if part == 3 and any(subt) else None),
               "mvd_sub": mvd_sub,
               "cbp_l": cbp_l, "cbp_c": cbp_c,
               "levels": np.zeros((16, 16), np.int32),
               "dc_u": np.zeros(4, np.int32), "dc_v": np.zeros(4, np.int32),
               "ac_u": np.zeros((4, 15), np.int32),
               "ac_v": np.zeros((4, 15), np.int32), "qpd": 0}
        can_t8 = part != 3 or all(st == 0 for st in subt)
        self._inter_luma_tail(mx, my, cbp_l, cbp_c, out, can_t8)
        return out

    def _inter_luma_tail(self, mx, my, cbp_l, cbp_c, out, can_t8):
        """Shared inter residual tail: optional transform_size_8x8_flag,
        qp_delta, luma (4x4 or 8x8) + chroma residuals."""
        t8 = False
        if (cbp_l and getattr(self, "transform_8x8_mode", False)
                and can_t8):
            t8 = bool(self.t8_flag(mx, my))
        out["t8"] = t8
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return
        out["qpd"] = self.qp_delta()
        if t8:
            out["levels8"] = np.zeros((4, 64), np.int32)
            for b8 in range(4):
                if not (cbp_l >> b8) & 1:
                    continue
                _, coeffs = self.residual(5, 0, n=64)
                out["levels8"][b8] = coeffs
                bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
                self.cbf4[4 * my + by:4 * my + by + 2,
                          4 * mx + bx:4 * mx + bx + 2] = int(coeffs.any())
        else:
            for blk in range(16):
                if not (cbp_l >> (blk // 4)) & 1:
                    continue
                bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
                inc = self.cbf_inc_luma4(mx, my, bx, by, False)
                cbf, coeffs = self.residual(2, inc, n=16)
                out["levels"][blk] = coeffs
                self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._read_chroma(mx, my, cbp_c, False, out)

    def read_b_mb(self, mx, my):
        """Returns dict for one B MB (16x16 modes + direct/skip; intra)."""
        self.coded[my, mx] = True
        if self.skip_flag(mx, my, base=24):
            self.direct[my, mx] = True
            self.prev_qp_delta_nz = 0
            return {"skip": True}
        t = self.b_mb_type(mx, my)
        if isinstance(t, tuple):
            it = self.b_intra_suffix()
            out = self._read_intra_common(mx, my, it)
            out["intra"] = True
            out["skip"] = False
            return out
        if t > 3:
            return self._read_b_parts(mx, my, t)
        self.direct[my, mx] = t == 0
        out = {"skip": False, "intra": False, "mode": t,
               "mvd0": np.zeros(2, np.int32), "mvd1": np.zeros(2, np.int32),
               "levels": np.zeros((16, 16), np.int32),
               "dc_u": np.zeros(4, np.int32), "dc_v": np.zeros(4, np.int32),
               "ac_u": np.zeros((4, 15), np.int32),
               "ac_v": np.zeros((4, 15), np.int32), "qpd": 0}
        out["ref0"] = out["ref1"] = 0
        nref = (getattr(self, "num_ref_l0", 1), getattr(self, "num_ref_l1", 1))
        if t in (1, 3) and nref[0] > 1:
            out["ref0"] = self.ref_idx(4 * mx, 4 * my, lst=0)
            self.ref8[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = out["ref0"]
        if t in (2, 3) and nref[1] > 1:
            out["ref1"] = self.ref_idx(4 * mx, 4 * my, lst=1)
            self.ref81[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = out["ref1"]
        if t in (1, 3):
            out["mvd0"] = np.array([self.mvd_comp(4 * mx, 4 * my, 0, lst=0),
                                    self.mvd_comp(4 * mx, 4 * my, 1, lst=0)], np.int32)
            self.mvd[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = out["mvd0"]
        if t in (2, 3):
            out["mvd1"] = np.array([self.mvd_comp(4 * mx, 4 * my, 0, lst=1),
                                    self.mvd_comp(4 * mx, 4 * my, 1, lst=1)], np.int32)
            self.mvd1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = out["mvd1"]
        cbp_l, cbp_c = self.cbp(mx, my)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        out["cbp_l"], out["cbp_c"] = cbp_l, cbp_c
        # 16x16 modes (t <= 3): 8x8 transform always permitted —
        # B_Direct_16x16 needs direct_8x8_inference, which x264 sets
        self._inter_luma_tail(mx, my, cbp_l, cbp_c, out, True)
        return out

    # Table 7-14 list usage for two-partition B types 4..21 (same data as
    # the host decoder's _B2_COMBO; spec-table constants)
    _B2_COMBO = {
        4: ((1, 0), (1, 0)), 5: ((1, 0), (1, 0)),
        6: ((0, 1), (0, 1)), 7: ((0, 1), (0, 1)),
        8: ((1, 0), (0, 1)), 9: ((1, 0), (0, 1)),
        10: ((0, 1), (1, 0)), 11: ((0, 1), (1, 0)),
        12: ((1, 0), (1, 1)), 13: ((1, 0), (1, 1)),
        14: ((0, 1), (1, 1)), 15: ((0, 1), (1, 1)),
        16: ((1, 1), (1, 0)), 17: ((1, 1), (1, 0)),
        18: ((1, 1), (0, 1)), 19: ((1, 1), (0, 1)),
        20: ((1, 1), (1, 1)), 21: ((1, 1), (1, 1)),
    }
    _BSUB_LISTS = {1: (1, 0), 2: (0, 1), 3: (1, 1)}

    def _read_b_parts(self, mx, my, t):
        """Partitioned B MB syntax: two-partition types 4..21 and B_8x8
        (22, 8x8 subs only — x264 never emits smaller B sub-parts)."""
        nref = (getattr(self, "num_ref_l0", 1), getattr(self, "num_ref_l1", 1))
        bx0, by0 = 4 * mx, 4 * my
        out = {"skip": False, "intra": False, "mode": t,
               "levels": np.zeros((16, 16), np.int32),
               "dc_u": np.zeros(4, np.int32), "dc_v": np.zeros(4, np.int32),
               "ac_u": np.zeros((4, 15), np.int32),
               "ac_v": np.zeros((4, 15), np.int32), "qpd": 0}
        if t == 22:
            subt = [self.b_sub_type() for _ in range(4)]
            if any(1 <= s <= 12 and s > 3 for s in subt):
                raise NotImplementedError(
                    f"B sub_mb_type {subt} below 8x8 in CABAC")
            refs = [[0, 0] for _ in range(4)]
            for x in (0, 1):
                for sb in range(4):
                    if subt[sb] != 0 and self._BSUB_LISTS[subt[sb]][x] \
                            and nref[x] > 1:
                        qx, qy = bx0 + 2 * (sb & 1), by0 + 2 * (sb >> 1)
                        refs[sb][x] = self.ref_idx(qx, qy, lst=x)
                        rf = self.ref8 if x == 0 else self.ref81
                        rf[qy:qy + 2, qx:qx + 2] = refs[sb][x]
            mvds = [[None] * 4, [None] * 4]
            for x in (0, 1):
                mvd_f = self.mvd if x == 0 else self.mvd1
                for sb in range(4):
                    if subt[sb] == 0 or not self._BSUB_LISTS[subt[sb]][x]:
                        continue
                    qx, qy = bx0 + 2 * (sb & 1), by0 + 2 * (sb >> 1)
                    d = np.array([self.mvd_comp(qx, qy, 0, lst=x),
                                  self.mvd_comp(qx, qy, 1, lst=x)], np.int32)
                    mvds[x][sb] = d
                    mvd_f[qy:qy + 2, qx:qx + 2] = d
            out["subt"] = subt
            out["refs"] = refs
            out["mvds"] = mvds
        else:
            combo = self._B2_COMBO[t]
            vert = t & 1                     # odd -> 8x16
            # partition extents on the 4x4 grid
            exts = ([(bx0, by0, 2, 4), (bx0 + 2, by0, 2, 4)] if vert
                    else [(bx0, by0, 4, 2), (bx0, by0 + 2, 4, 2)])
            refs = [[0, 0], [0, 0]]
            for x in (0, 1):
                rf = self.ref8 if x == 0 else self.ref81
                for p in (0, 1):
                    if combo[p][x] and nref[x] > 1:
                        qx, qy, qw, qh = exts[p]
                        refs[p][x] = self.ref_idx(qx, qy, lst=x)
                        rf[qy:qy + qh, qx:qx + qw] = refs[p][x]
            mvds = [[None, None], [None, None]]
            for x in (0, 1):
                mvd_f = self.mvd if x == 0 else self.mvd1
                for p in (0, 1):
                    if not combo[p][x]:
                        continue
                    qx, qy, qw, qh = exts[p]
                    d = np.array([self.mvd_comp(qx, qy, 0, lst=x),
                                  self.mvd_comp(qx, qy, 1, lst=x)], np.int32)
                    mvds[x][p] = d
                    mvd_f[qy:qy + qh, qx:qx + qw] = d
            out["combo"] = combo
            out["refs2"] = refs
            out["mvds2"] = mvds
        cbp_l, cbp_c = self.cbp(mx, my)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        out["cbp_l"], out["cbp_c"] = cbp_l, cbp_c
        # t==22 reaches here with 8x8-only subs (smaller subs raise
        # upstream), so the 8x8 transform is always permitted
        self._inter_luma_tail(mx, my, cbp_l, cbp_c, out, True)
        return out

    def read_i16_mb_body(self, mx, my, ac_flag, cbp_c):
        """After mb_type bins were read by the caller."""
        out = {"dc": np.zeros(16, np.int32), "ac": np.zeros((16, 15), np.int32),
               "dc_u": np.zeros(4, np.int32), "dc_v": np.zeros(4, np.int32),
               "ac_u": np.zeros((4, 15), np.int32),
               "ac_v": np.zeros((4, 15), np.int32)}
        out["cmode"] = self.chroma_pred_mode(mx, my)
        out["qpd"] = self.qp_delta()
        cbf, out["dc"] = self.residual(0, self.cbf_inc_dc(mx, my, True), n=16)
        self.cbf_dc[my, mx] = cbf
        if ac_flag:
            for blk in range(16):
                bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
                inc = self.cbf_inc_luma4(mx, my, bx, by, True)
                cbf, coeffs = self.residual(1, inc, n=15)
                out["ac"][blk] = coeffs
                self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._read_chroma(mx, my, cbp_c, True, out)
        return out

    def read_i_mb(self, mx, my):
        t = self.i_mb_type(mx, my)
        return self._read_intra_common(mx, my, t)

    def _read_intra_common(self, mx, my, t):
        self.coded[my, mx] = True
        self.is_intra[my, mx] = True
        if t[0] == "i4":
            self.is_inxn[my, mx] = True
            if getattr(self, "transform_8x8_mode", False) \
                    and self.t8_flag(mx, my):
                return self.read_i8_mb_body(mx, my)
            return self.read_i4_mb_body(mx, my)
        ac, cbc, pred = t[1:]
        self.is_i16[my, mx] = True
        self.cbp_luma[my, mx] = 15 if ac else 0
        self.cbp_chroma[my, mx] = cbc
        out = self.read_i16_mb_body(mx, my, ac, cbc)
        out.update(kind="i16", ac_flag=ac, cbp_c=cbc, pred=pred)
        return out

    def read_i8_mb_body(self, mx, my):
        """I_NxN with transform_size_8x8_flag == 1: 4 mode pairs + cat-5
        residual per coded 8x8 block."""
        out = {"kind": "i8",
               "modes_bins8": [self.i4_pred_bins() for _ in range(4)]}
        out["cmode"] = self.chroma_pred_mode(mx, my)
        cbp_l, cbp_c = self.cbp(mx, my)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        out.update(cbp_l=cbp_l, cbp_c=cbp_c, qpd=0,
                   levels8=np.zeros((4, 64), np.int32),
                   dc_u=np.zeros(4, np.int32), dc_v=np.zeros(4, np.int32),
                   ac_u=np.zeros((4, 15), np.int32),
                   ac_v=np.zeros((4, 15), np.int32))
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return out
        out["qpd"] = self.qp_delta()
        for b8 in range(4):
            if not (cbp_l >> b8) & 1:
                continue
            _, coeffs = self.residual(5, 0, n=64)
            out["levels8"][b8] = coeffs
            # neighbor cbf contexts read the covering 8x8's coded flag
            bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
            self.cbf4[4 * my + by:4 * my + by + 2,
                      4 * mx + bx:4 * mx + bx + 2] = int(coeffs.any())
        self._read_chroma(mx, my, cbp_c, True, out)
        return out

    def read_i4_mb_body(self, mx, my):
        out = {"kind": "i4",
               "modes_bins": [self.i4_pred_bins() for _ in range(16)]}
        out["cmode"] = self.chroma_pred_mode(mx, my)
        cbp_l, cbp_c = self.cbp(mx, my)
        self.cbp_luma[my, mx] = cbp_l
        self.cbp_chroma[my, mx] = cbp_c
        out.update(cbp_l=cbp_l, cbp_c=cbp_c, qpd=0,
                   levels=np.zeros((16, 16), np.int32),
                   dc_u=np.zeros(4, np.int32), dc_v=np.zeros(4, np.int32),
                   ac_u=np.zeros((4, 15), np.int32),
                   ac_v=np.zeros((4, 15), np.int32))
        if cbp_l == 0 and cbp_c == 0:
            self.prev_qp_delta_nz = 0
            return out
        out["qpd"] = self.qp_delta()
        for blk in range(16):
            if not (cbp_l >> (blk // 4)) & 1:
                continue
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            inc = self.cbf_inc_luma4(mx, my, bx, by, True)
            cbf, coeffs = self.residual(2, inc, n=16)
            out["levels"][blk] = coeffs
            self.cbf4[4 * my + by, 4 * mx + bx] = cbf
        self._read_chroma(mx, my, cbp_c, True, out)
        return out

    def _read_chroma(self, mx, my, cbp_c, intra_mb, out):
        if cbp_c >= 1:
            for pl, key in ((0, "dc_u"), (1, "dc_v")):
                inc = self.cbf_inc_cdc(mx, my, pl, intra_mb)
                cbf, out[key] = self.residual(3, inc, n=4)
                self.cbf_cdc[my, mx, pl] = cbf
        if cbp_c == 2:
            for pl, key in ((0, "ac_u"), (1, "ac_v")):
                for sb in range(4):
                    inc = self.cbf_inc_cac(mx, my, sb, pl, intra_mb)
                    cbf, coeffs = self.residual(4, inc, n=15)
                    out[key][sb] = coeffs
                    gy, gx = 2 * my + (sb >> 1), 2 * mx + (sb & 1)
                    self.cbf_cac[gy, gx, pl] = cbf

    def end_mb(self) -> int:
        return self.io.terminate()
