# Frozen copy of x264vfw_tpu_torch/ops/transform_np.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""H.264 integer transform + quantization — exact numpy host implementation.

This is the spec-derived golden model (ITU-T H.264 §8.5) and the host-side
reconstruction path of the oracle decoder (decode/decoder.py).  The
device implementations in `transform.py` compute the same integers.

Capability replaced: libx264's dct/quant (reference forwards `--trellis`,
`--8x8dct` etc. to it, reference codec.c:904-906) and FFmpeg's IDCT on
the decode side (reference codec.c:2223-2238).

All arithmetic is int32-exact; float never touches sample data.
"""

from __future__ import annotations

import numpy as np

# --- quantization tables (H.264 Table 8-15 normAdjust / x264 MF tables) ---

# Dequant scale V[qp%6][class], classes: a=(0,0)-like, b=(1,1)-like, c=other
DEQUANT_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Forward quant multipliers MF[qp%6][class] (2^15 * 2^4 / (V*16) scaled)
QUANT_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# position class for each (i, j) in a 4x4 block
_POS_CLASS = np.array([
    [0, 2, 0, 2],
    [2, 1, 2, 1],
    [0, 2, 0, 2],
    [2, 1, 2, 1],
], dtype=np.int32)

# per-position tables indexed [qp%6, i, j]
DEQUANT_TABLE = DEQUANT_V[:, _POS_CLASS]          # (6, 4, 4)
QUANT_TABLE = QUANT_MF[:, _POS_CLASS]             # (6, 4, 4)

# chroma QP mapping (H.264 Table 8-12): qPi 30..51 -> QPc
_CHROMA_QP_TABLE = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
     37, 37, 37, 38, 38, 38, 39, 39, 39, 39], dtype=np.int32)

# zigzag scan for 4x4 blocks (§8.5.6): raster index of k-th scan position
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      dtype=np.int32)

# 8x8 zigzag scan (§8.5.8), for the High-profile 8x8 transform
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


def chroma_qp(qp_luma: np.ndarray | int, chroma_qp_offset: int = 0) -> np.ndarray | int:
    """Luma QP -> chroma QP (Table 8-12)."""
    qpi = np.clip(np.asarray(qp_luma) + chroma_qp_offset, 0, 51)
    idx = np.clip(qpi - 30, 0, 21)
    return np.where(qpi < 30, qpi, _CHROMA_QP_TABLE[idx]).astype(np.int32)


# --- forward 4x4 core transform (encoder-side, x264/JM convention) ---

_CF = np.array([
    [1, 1, 1, 1],
    [2, 1, -1, -2],
    [1, -1, -1, 1],
    [1, -2, 2, -1],
], dtype=np.int64)


def fdct4x4(x: np.ndarray) -> np.ndarray:
    """Forward 4x4 integer transform W = Cf X Cf^T. x: (..., 4, 4) int."""
    x = x.astype(np.int64)
    w = np.einsum("ij,...jk,lk->...il", _CF, x, _CF)
    return w.astype(np.int32)


def idct4x4_dequant_add(coef: np.ndarray, pred: np.ndarray, qp: np.ndarray | int,
                        dc_from_separate: np.ndarray | None = None) -> np.ndarray:
    """Dequant + inverse 4x4 transform + add to prediction + clip (§8.5.12).

    coef: (..., 4, 4) quantized levels (int); pred: (..., 4, 4) uint8-range;
    qp: scalar or broadcastable; dc_from_separate: optional (...,) already-
    scaled DC values (for Intra_16x16 / chroma DC paths) that REPLACE the
    dequantized position (0,0).
    Returns reconstructed samples (..., 4, 4) int32 in [0, 255].
    """
    qp = np.asarray(qp, dtype=np.int32)
    d = dequant4x4(coef, qp)
    if dc_from_separate is not None:
        d = d.copy()
        d[..., 0, 0] = dc_from_separate
    r = idct4x4_core(d)
    rec = pred.astype(np.int32) + r
    return np.clip(rec, 0, 255)


def dequant4x4(coef: np.ndarray, qp: np.ndarray | int) -> np.ndarray:
    """Spec dequant with flat scaling lists: d = c * V[qp%6][pos] << (qp/6).

    qp: scalar or array broadcastable against coef.shape[:-2].
    """
    qp = np.asarray(qp, dtype=np.int32)
    v = DEQUANT_TABLE[qp % 6].astype(np.int64)  # qp.shape + (4, 4)
    shift = (qp // 6).astype(np.int64)
    d = coef.astype(np.int64) * v
    if np.ndim(shift):
        d = d << shift[..., None, None]
    else:
        d = d << int(shift)
    return d.astype(np.int32)


def idct4x4_core(d: np.ndarray) -> np.ndarray:
    """Inverse 4x4 transform butterflies + (x+32)>>6 (§8.5.12.2).

    Stage order matters: the spec transforms each ROW first (mixing
    columns), then each column.  The >>1 floors make the opposite order
    differ by ±1 on knife-edge inputs whenever qP/6 < 2 (d not a multiple
    of 4) — caught against stock FFmpeg at QP<12."""
    d = d.astype(np.int64)
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    g0, g1, g2, g3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    h0 = g0 + g2
    h1 = g0 - g2
    h2 = (g1 >> 1) - g3
    h3 = g1 + (g3 >> 1)
    r = np.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3], axis=-2)
    return ((r + 32) >> 6).astype(np.int32)


def quant4x4(w: np.ndarray, qp: np.ndarray | int, intra: bool,
             dc_mode: bool = False) -> np.ndarray:
    """Forward quant (JM/x264 dead-zone): sign * ((|w|*MF + f) >> qbits).

    qp: scalar or array broadcastable against w.shape[:-2].
    dc_mode: use position-(0,0) MF for all positions and qbits+1 (DC paths).
    """
    qp = np.asarray(qp, dtype=np.int32)
    qbits = 15 + (qp // 6).astype(np.int64)
    if dc_mode:
        mf = QUANT_MF[qp % 6, 0].astype(np.int64)  # qp.shape scalar-per-qp
        if np.ndim(mf):
            mf = mf[..., None, None]
        qbits = qbits + 1
    else:
        mf = QUANT_TABLE[qp % 6].astype(np.int64)  # qp.shape + (4, 4)
    f = (np.int64(1) << qbits) // (3 if intra else 6)
    if np.ndim(qbits):
        f = f[..., None, None]
        qbits = qbits[..., None, None]
    w64 = w.astype(np.int64)
    level = (np.abs(w64) * mf + f) >> qbits
    if not dc_mode:
        # dynamic-range discipline: keep dequantized coefficients within
        # int16 so decoder IDCT intermediates meet the spec's 16-bit
        # constraint (§8.5 bitstream conformance). Binds only on
        # adversarial content at very low QP.
        v = DEQUANT_TABLE[qp % 6].astype(np.int64) << np.expand_dims(
            np.expand_dims((qp // 6).astype(np.int64), -1), -1) if np.ndim(qp) \
            else DEQUANT_TABLE[qp % 6].astype(np.int64) << int(qp // 6)
        level = np.minimum(level, 32767 // v)
    return (np.sign(w64) * level).astype(np.int32)


# --- Intra 16x16 luma DC path (§8.5.10) ---

_H4 = np.array([
    [1, 1, 1, 1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
], dtype=np.int64)


def hadamard4x4(x: np.ndarray) -> np.ndarray:
    """4x4 Hadamard H X H^T (self-inverse up to x16)."""
    return np.einsum("ij,...jk,lk->...il", _H4, x.astype(np.int64), _H4).astype(np.int64)


def luma_dc_fwd_quant(dc: np.ndarray, qp: np.ndarray | int, intra: bool = True) -> np.ndarray:
    """Encoder: Hadamard + DC quant of the 16 luma DC coefficients.

    dc: (..., 4, 4) raw DC coefficients from fdct4x4 of the 16 sub-blocks.
    """
    w = hadamard4x4(dc) // 2  # JM: (w)/2 before DC quant
    return quant4x4(w, qp, intra=intra, dc_mode=True)


def luma_dc_dequant(levels: np.ndarray, qp: np.ndarray | int) -> np.ndarray:
    """Decoder §8.5.10: inverse Hadamard then scale. Returns (..., 4, 4) DC
    values to inject into each sub-block before idct4x4_core."""
    qp = np.asarray(qp, dtype=np.int32)
    f = hadamard4x4(levels)
    ls = (16 * DEQUANT_V[qp % 6, 0]).astype(np.int64)  # LevelScale(qp%6,0,0)
    qp6 = int(np.asarray(qp // 6)) if np.ndim(qp) == 0 else None
    if qp6 is not None:
        if int(qp) >= 36:
            dc = (f * ls) << (qp6 - 6)
        else:
            dc = (f * ls + (1 << (5 - qp6))) >> (6 - qp6)
    else:
        qp6v = (qp // 6).astype(np.int64)[..., None, None]
        lsv = np.asarray(ls).reshape(qp.shape + (1, 1))
        hi = (f * lsv) * (1 << np.maximum(qp6v - 6, 0))
        lo = (f * lsv + (1 << np.maximum(5 - qp6v, 0))) >> np.maximum(6 - qp6v, 0)
        dc = np.where(qp[..., None, None] >= 36, hi, lo)
    return dc.astype(np.int32)


# --- chroma DC path (§8.5.11) ---

_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)


def hadamard2x2(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,...jk,lk->...il", _H2, x.astype(np.int64), _H2).astype(np.int64)


def chroma_dc_fwd_quant(dc: np.ndarray, qp: np.ndarray | int, intra: bool) -> np.ndarray:
    """Encoder: 2x2 Hadamard + DC quant. dc: (..., 2, 2)."""
    w = hadamard2x2(dc)
    return quant4x4(w, qp, intra=intra, dc_mode=True)


def chroma_dc_dequant(levels: np.ndarray, qp: np.ndarray | int) -> np.ndarray:
    """Decoder §8.5.11: f = H c H; dcC = ((f * LevelScale) << (qp/6)) >> 5."""
    qp = np.asarray(qp, dtype=np.int32)
    f = hadamard2x2(levels)
    ls = (16 * DEQUANT_V[qp % 6, 0]).astype(np.int64)
    qp6 = (qp // 6).astype(np.int64)
    if qp.ndim:
        ls = ls.reshape(qp.shape + (1, 1))
        qp6 = qp6[..., None, None]
    dc = ((f * ls) << qp6) >> 5
    return dc.astype(np.int32)


# --- scan helpers ---

def zigzag_scan(blocks: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 16) in zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 16)
    return flat[..., ZIGZAG_4x4]


def zigzag_unscan(scanned: np.ndarray) -> np.ndarray:
    """(..., 16) zigzag order -> (..., 4, 4) raster."""
    out = np.zeros_like(scanned)
    out[..., ZIGZAG_4x4] = scanned
    return out.reshape(*scanned.shape[:-1], 4, 4)


# --- 8x8 transform (High profile, §8.5.12.3/8.5.13) ---

# dequant scale values per qp%6 (6 distinct values; position class below)
_DEQUANT8_INIT = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int64)

# position -> class for the 8x8 weight matrix: class of raster position
# i (0..63) is _D8_SCAN[((i >> 1) & 12) | (i & 3)]
_D8_SCAN = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                    dtype=np.int64)
_D8_CLASS = _D8_SCAN[((np.arange(64) >> 1) & 12) | (np.arange(64) & 3)]

# (6, 8, 8) LevelScale8x8 = weightScale(=16, flat lists) x normAdjust8x8
DEQUANT8_TABLE = (_DEQUANT8_INIT[:, _D8_CLASS] * 16).reshape(6, 8, 8)


def dequant8x8(coef: np.ndarray, qp: np.ndarray | int) -> np.ndarray:
    """8x8 dequant with flat scaling lists (§8.5.13.1).

    coef: (..., 8, 8) levels; qp scalar or broadcastable.
    """
    qp = np.asarray(qp, dtype=np.int32)
    ls = DEQUANT8_TABLE[qp % 6].astype(np.int64)
    c = coef.astype(np.int64)
    div = (qp // 6).astype(np.int64)
    if np.ndim(div):
        div_ = div[..., None, None]
        hi = (c * ls) << np.maximum(div_ - 6, 0)
        sh = np.maximum(6 - div_, 0)
        lo = (c * ls + (np.int64(1) << np.maximum(5 - div_, 0))) >> sh
        return np.where(div_ >= 6, hi, lo).astype(np.int32)
    dv = int(div)
    if dv >= 6:
        return ((c * ls) << (dv - 6)).astype(np.int32)
    return ((c * ls + (1 << (5 - dv))) >> (6 - dv)).astype(np.int32)


def _idct8_1d(p, axis_last: bool):
    """One 8-point inverse stage over the last (row) or second-to-last
    (column) axis; p: (..., 8, 8) int64."""
    ix = (lambda k: p[..., :, k]) if axis_last else (lambda k: p[..., k, :])
    p0, p1, p2, p3 = ix(0), ix(1), ix(2), ix(3)
    p4, p5, p6, p7 = ix(4), ix(5), ix(6), ix(7)
    a0 = p0 + p4
    a2 = p0 - p4
    a4 = (p2 >> 1) - p6
    a6 = (p6 >> 1) + p2
    b0 = a0 + a6
    b2 = a2 + a4
    b4 = a2 - a4
    b6 = a0 - a6
    a1 = -p3 + p5 - p7 - (p7 >> 1)
    a3 = p1 + p7 - p3 - (p3 >> 1)
    a5 = -p1 + p7 + p5 + (p5 >> 1)
    a7 = p3 + p5 + p1 + (p1 >> 1)
    b1 = (a7 >> 2) + a1
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    b7 = a7 - (a1 >> 2)
    outs = [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7]
    ax = -1 if axis_last else -2
    return np.stack(outs, axis=ax)


def idct8x8_core(d: np.ndarray) -> np.ndarray:
    """Inverse 8x8 transform (§8.5.12.3): rows, then columns, (x+32)>>6."""
    d = d.astype(np.int64)
    f = _idct8_1d(d, axis_last=True)    # horizontal (each row)
    r = _idct8_1d(f, axis_last=False)   # vertical (each column)
    return ((r + 32) >> 6).astype(np.int32)


def zigzag8x8_unscan(scanned: np.ndarray) -> np.ndarray:
    """(..., 64) scan order -> (..., 8, 8) raster."""
    out = np.zeros(scanned.shape[:-1] + (64,), dtype=scanned.dtype)
    out[..., ZIGZAG_8x8] = scanned
    return out.reshape(scanned.shape[:-1] + (8, 8))


def zigzag8x8_scan(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) raster -> (..., 64) scan order."""
    flat = blocks.reshape(blocks.shape[:-2] + (64,))
    return flat[..., ZIGZAG_8x8]


# --- 8x8 forward transform + quant (High profile encode side) ---

def _fdct8_1d(x: np.ndarray, axis_last: bool) -> np.ndarray:
    """One 8-point forward stage of the H.264 8x8 integer transform (the
    published JM/x264 butterfly; conformance depends only on the INVERSE
    §8.5.12.3 — this forward is the matched encoder-side choice)."""
    ix = (lambda k: x[..., :, k]) if axis_last else (lambda k: x[..., k, :])
    p = [ix(k) for k in range(8)]
    s07, s16, s25, s34 = p[0] + p[7], p[1] + p[6], p[2] + p[5], p[3] + p[4]
    a0, a1, a2, a3 = s07 + s34, s16 + s25, s07 - s34, s16 - s25
    d07, d16, d25, d34 = p[0] - p[7], p[1] - p[6], p[2] - p[5], p[3] - p[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    outs = [a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
            a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7]
    return np.stack(outs, axis=-1 if axis_last else -2)


def fdct8x8(x: np.ndarray) -> np.ndarray:
    """Forward 8x8 integer transform. x: (..., 8, 8) int residual."""
    w = _fdct8_1d(x.astype(np.int64), True)
    return _fdct8_1d(w, False).astype(np.int32)


def _derive_quant8_mf() -> np.ndarray:
    """MF8[qp%6][class] = round(2^24 / (n_c * V8[m][c])) where n_c is the
    per-class diagonal of (forward o linear-inverse) — computed here
    numerically, so the quantizer is derived, not transcribed.  With the
    DEQUANT8_TABLE's x16 weightScale and the idct's >>6, the composite
    gain is exactly 1 (verified by test_transform.test_quant8_roundtrip)."""
    lin = np.zeros((64, 64))
    idx = np.arange(8)
    for p in range(64):
        e = np.zeros((8, 8))
        e.flat[p] = 1.0
        # float version of the inverse stages (halves are exact dyadics)
        def one(q, axis_last):
            ixf = (lambda k: q[..., :, k]) if axis_last else \
                (lambda k: q[..., k, :])
            c = [ixf(k) for k in range(8)]
            a0 = c[0] + c[4]
            a2 = c[0] - c[4]
            a4 = c[2] / 2 - c[6]
            a6 = c[6] / 2 + c[2]
            b0, b2, b4, b6 = a0 + a6, a2 + a4, a2 - a4, a0 - a6
            a1 = -c[3] + c[5] - c[7] - c[7] / 2
            a3 = c[1] + c[7] - c[3] - c[3] / 2
            a5 = -c[1] + c[7] + c[5] + c[5] / 2
            a7 = c[3] + c[5] + c[1] + c[1] / 2
            b1 = a7 / 4 + a1
            b3 = a3 + a5 / 4
            b5 = a3 / 4 - a5
            b7 = a7 - a1 / 4
            return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                             b6 - b1, b4 - b3, b2 - b5, b0 - b7],
                            axis=-1 if axis_last else -2)

        def fone(q, axis_last):
            ixf = (lambda k: q[..., :, k]) if axis_last else \
                (lambda k: q[..., k, :])
            c = [ixf(k) for k in range(8)]
            s07, s16, s25, s34 = c[0] + c[7], c[1] + c[6], c[2] + c[5], \
                c[3] + c[4]
            a0, a1, a2, a3 = s07 + s34, s16 + s25, s07 - s34, s16 - s25
            d07, d16, d25, d34 = c[0] - c[7], c[1] - c[6], c[2] - c[5], \
                c[3] - c[4]
            a4 = d16 + d25 + (d07 + d07 / 2)
            a5 = d07 - d34 - (d25 + d25 / 2)
            a6 = d07 + d34 - (d16 + d16 / 2)
            a7 = d16 - d25 + (d34 + d34 / 2)
            return np.stack(
                [a0 + a1, a4 + a7 / 4, a2 + a3 / 2, a5 + a6 / 4,
                 a0 - a1, a6 - a5 / 4, a2 / 2 - a3, a4 / 4 - a7],
                axis=-1 if axis_last else -2)

        y = fone(fone(one(one(e, True), False), True), False)
        lin[:, p] = y.ravel()
    del idx
    n_pos = np.diag(lin)                       # exactly diagonal
    n_cls = np.array([n_pos[_D8_CLASS == c][0] for c in range(6)])
    v8 = DEQUANT8_TABLE.reshape(6, 64)[:, [int(np.nonzero(_D8_CLASS == c)[0][0])
                                           for c in range(6)]] / 16.0
    return np.round((1 << 24) / (n_cls[None, :] * v8)).astype(np.int32)


QUANT8_MF = _derive_quant8_mf()                 # (6, 6) [qp%6][class]
QUANT8_TABLE = QUANT8_MF[:, _D8_CLASS].reshape(6, 8, 8)


def quant8x8(w: np.ndarray, qp: np.ndarray | int, intra: bool) -> np.ndarray:
    """Forward 8x8 quant (JM dead-zone): sign * ((|w|*MF8 + f) >> qbits8),
    qbits8 = 16 + qp/6; levels clamped so dequantized coefficients stay
    within the decoder's 16-bit IDCT range."""
    qp = np.asarray(qp, dtype=np.int32)
    qbits = 16 + (qp // 6).astype(np.int64)
    mf = QUANT8_TABLE[qp % 6].astype(np.int64)
    f = (np.int64(1) << qbits) // (3 if intra else 6)
    if np.ndim(qbits):
        f = f[..., None, None]
        qbits = qbits[..., None, None]
    w64 = w.astype(np.int64)
    level = (np.abs(w64) * mf + f) >> qbits
    ls = DEQUANT8_TABLE[qp % 6].astype(np.int64)
    dv = (qp // 6).astype(np.int64)
    if np.ndim(dv):
        dv = dv[..., None, None]
        gain = np.where(dv >= 6, ls << np.maximum(dv - 6, 0),
                        np.maximum(ls >> np.maximum(6 - dv, 0), 1))
    else:
        gain = (ls << (int(dv) - 6)) if int(dv) >= 6 else \
            np.maximum(ls >> (6 - int(dv)), 1)
    level = np.minimum(level, 32767 // np.maximum(gain, 1))
    return (np.sign(w64) * level).astype(np.int32)
