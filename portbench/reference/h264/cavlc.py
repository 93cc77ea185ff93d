# Frozen copy of x264vfw_tpu_torch/bitstream/cavlc.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""CAVLC residual block coding (ITU-T H.264 §9.2).

Scalar reference implementation of encode + decode for one transform block.
This is the conformance model; the production encoder path uses the
numpy-vectorized implementation in `cavlc_vec.py` (validated against this),
and a C++ port is planned for the host finalization stage.

A "block" here is the zigzag-ordered level array:
  * 16 entries for luma 4x4 / chroma AC=0 case (max_coeffs=16)
  * 15 entries for Intra16x16 AC / chroma AC blocks (max_coeffs=15)
  * 4 entries for chroma DC 2x2 (max_coeffs=4, nC=-1)
"""

from __future__ import annotations

import numpy as np

from .bitstream import BitReader, BitWriter
from .cavlc_tables import (
    COEFF_TOKEN,
    COEFF_TOKEN_DEC,
    RUN_BEFORE,
    RUN_BEFORE_DEC,
    TOTAL_ZEROS,
    TOTAL_ZEROS_CHROMA_DC,
    TOTAL_ZEROS_CHROMA_DC_DEC,
    TOTAL_ZEROS_DEC,
    coeff_token_ctx,
)


def level_code(level: int, first: bool, trailing_ones: int) -> int:
    """Map a signed level to levelCode (inverse of §9.2.2.1)."""
    lc = 2 * abs(level) - 2 if level > 0 else -2 * level - 1
    if first and trailing_ones < 3:
        lc -= 2
    return lc


def encode_level(w: BitWriter, lc: int, suffix_length: int) -> None:
    """Write level_prefix + level_suffix for levelCode lc (§9.2.2.1 inverse)."""
    sl = suffix_length
    if sl == 0:
        if lc < 14:
            w.u(lc + 1, 1)  # unary: lc zeros + 1
            return
        if lc < 30:
            w.u(15, 1)      # prefix 14
            w.u(4, lc - 14)
            return
        rem = lc - 30
    else:
        if lc < (15 << sl):
            prefix = lc >> sl
            w.u(prefix + 1, 1)
            w.u(sl, lc & ((1 << sl) - 1))
            return
        rem = lc - (15 << sl)
    # escape: prefix >= 15, suffix size = prefix - 3
    p = 15
    off = 0
    while rem >= off + (1 << (p - 3)):
        off += 1 << (p - 3)
        p += 1
    w.u(p + 1, 1)  # p zeros then stop bit
    w.u(p - 3, rem - off)


def decode_level(r: BitReader, suffix_length: int) -> int:
    """Read one level (§9.2.2.1). Returns the signed level value."""
    # level_prefix: count zeros
    prefix = 0
    while r.u(1) == 0:
        prefix += 1
        if prefix > 32:
            raise ValueError("invalid level_prefix")
    sl = suffix_length
    if prefix == 14 and sl == 0:
        suffix_size = 4
    elif prefix >= 15:
        suffix_size = prefix - 3
    else:
        suffix_size = sl
    suffix = r.u(suffix_size) if suffix_size else 0
    lc = (min(15, prefix) << sl) + suffix
    if prefix >= 15 and sl == 0:
        lc += 15
    if prefix >= 16:
        lc += (1 << (prefix - 3)) - 4096
    return lc


def level_from_code(lc: int, first: bool, trailing_ones: int) -> int:
    if first and trailing_ones < 3:
        lc += 2
    if lc % 2 == 0:
        return (lc + 2) >> 1
    return -((lc + 1) >> 1)


def _read_vlc(r: BitReader, dec_map: dict, max_len: int = 16) -> tuple:
    """Match a (length, value) code from a decode map."""
    v = 0
    for ln in range(1, max_len + 1):
        v = (v << 1) | r.u(1)
        hit = dec_map.get((ln, v))
        if hit is not None:
            return hit
    raise ValueError("no VLC match")


def encode_residual_block(w: BitWriter, levels: np.ndarray, nC: int,
                          max_coeffs: int) -> None:
    """Encode one zigzag-ordered level array (§9.2)."""
    levels = np.asarray(levels)
    nz = np.nonzero(levels)[0]
    total_coeff = int(nz.size)

    # trailing ones: up to 3 consecutive +-1 at the high-frequency end
    t1 = 0
    while t1 < min(3, total_coeff) and abs(int(levels[nz[total_coeff - 1 - t1]])) == 1:
        t1 += 1

    ctx = coeff_token_ctx(nC)
    if ctx == 4:  # FLC
        if total_coeff == 0:
            w.u(6, 0b000011)
        else:
            w.u(6, 4 * (total_coeff - 1) + t1)
    else:
        v, ln = COEFF_TOKEN[ctx][(t1, total_coeff)]
        w.u(ln, v)

    if total_coeff == 0:
        return

    # trailing one signs, highest frequency first
    for i in range(t1):
        lv = int(levels[nz[total_coeff - 1 - i]])
        w.u(1, 1 if lv < 0 else 0)

    # remaining levels
    sl = 1 if (total_coeff > 10 and t1 < 3) else 0
    for k in range(t1, total_coeff):
        lv = int(levels[nz[total_coeff - 1 - k]])
        lc = level_code(lv, first=(k == t1), trailing_ones=t1)
        encode_level(w, lc, sl)
        if sl == 0:
            sl = 1
        if abs(lv) > (3 << (sl - 1)) and sl < 6:
            sl += 1

    # total_zeros
    total_zeros = int(nz[-1]) + 1 - total_coeff
    if total_coeff < max_coeffs:
        if nC == -1:
            v, ln = TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros]
        else:
            v, ln = TOTAL_ZEROS[total_coeff][total_zeros]
        w.u(ln, v)

    # run_before for each coeff except the lowest-frequency one
    zeros_left = total_zeros
    for k in range(total_coeff - 1):
        if zeros_left <= 0:
            break
        hi = int(nz[total_coeff - 1 - k])
        lo = int(nz[total_coeff - 2 - k])
        run = hi - lo - 1
        v, ln = RUN_BEFORE[min(zeros_left, 7)][run]
        w.u(ln, v)
        zeros_left -= run


def decode_residual_block(r: BitReader, nC: int, max_coeffs: int) -> np.ndarray:
    """Decode one block -> zigzag-ordered int32 levels of size max_coeffs."""
    out = np.zeros(max_coeffs, dtype=np.int32)
    ctx = coeff_token_ctx(nC)
    if ctx == 4:
        code = r.u(6)
        if code == 0b000011:
            total_coeff, t1 = 0, 0
        else:
            total_coeff, t1 = code // 4 + 1, code % 4
    else:
        t1, total_coeff = _read_vlc(r, COEFF_TOKEN_DEC[ctx])

    if total_coeff == 0:
        return out

    lvls = np.zeros(total_coeff, dtype=np.int32)  # highest freq first
    for i in range(t1):
        lvls[i] = -1 if r.u(1) else 1

    sl = 1 if (total_coeff > 10 and t1 < 3) else 0
    for k in range(t1, total_coeff):
        lc = decode_level(r, sl)
        lv = level_from_code(lc, first=(k == t1), trailing_ones=t1)
        lvls[k] = lv
        if sl == 0:
            sl = 1
        if abs(lv) > (3 << (sl - 1)) and sl < 6:
            sl += 1

    if total_coeff < max_coeffs:
        if nC == -1:
            total_zeros = _read_vlc(r, TOTAL_ZEROS_CHROMA_DC_DEC[total_coeff])
        else:
            total_zeros = _read_vlc(r, TOTAL_ZEROS_DEC[total_coeff])
    else:
        total_zeros = 0

    # place coefficients
    zeros_left = total_zeros
    pos = total_coeff + total_zeros - 1  # position of highest-freq coeff
    for k in range(total_coeff):
        out[pos] = lvls[k]
        if k == total_coeff - 1:
            break
        if zeros_left > 0:
            run = _read_vlc(r, RUN_BEFORE_DEC[min(zeros_left, 7)])
        else:
            run = 0
        zeros_left -= run
        pos -= run + 1
    return out
