# Frozen copy of x264vfw_tpu_torch/ops/intra_np.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""H.264 intra prediction — exact numpy implementation (ITU-T H.264 §8.3).

Golden model / host decode path.  The device (JAX) mirror lives in
`intra.py`.  Capability replaced: intra prediction inside libx264
(encode side, option `--i16x16/--i4x4` partitions via
reference codec.c:887) and FFmpeg's H.264 decoder (decode side).

Conventions: all predictors take explicit neighbor arrays + availability
flags; samples are int32 in [0,255]; clip is the caller's job only where
noted (plane modes clip internally).
"""

from __future__ import annotations

import numpy as np

# Intra_16x16 pred modes (§8.3.3)
I16_V, I16_H, I16_DC, I16_P = 0, 1, 2, 3
# Intra chroma pred modes (§8.3.4)  — note different numbering vs I16!
IC_DC, IC_H, IC_V, IC_P = 0, 1, 2, 3
# Intra_4x4 pred modes (§8.3.1)
I4_V, I4_H, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)


def _clip(x):
    return np.clip(x, 0, 255)


def pred16x16(mode: int, top: np.ndarray | None, left: np.ndarray | None,
              topleft: int | None) -> np.ndarray:
    """Intra_16x16 prediction. top/left are length-16 int arrays or None."""
    if mode == I16_V:
        assert top is not None
        return np.broadcast_to(top.reshape(1, 16), (16, 16)).astype(np.int32)
    if mode == I16_H:
        assert left is not None
        return np.broadcast_to(left.reshape(16, 1), (16, 16)).astype(np.int32)
    if mode == I16_DC:
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, dtype=np.int32)
    if mode == I16_P:
        assert top is not None and left is not None and topleft is not None
        xs = np.arange(8)
        # H: sum (x'+1) * (p[8+x', -1] - p[6-x', -1]); p[-1,-1] = topleft
        tl_row = np.concatenate([[topleft], top]).astype(np.int64)  # p[x,-1], x=-1..15
        lf_col = np.concatenate([[topleft], left]).astype(np.int64)
        H = int(sum((x + 1) * (tl_row[9 + x] - tl_row[7 - x]) for x in xs))
        V = int(sum((y + 1) * (lf_col[9 + y] - lf_col[7 - y]) for y in xs))
        a = 16 * (int(left[15]) + int(top[15]))
        b = (5 * H + 32) >> 6
        c = (5 * V + 32) >> 6
        yy, xx = np.mgrid[0:16, 0:16]
        return _clip((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5).astype(np.int32)
    raise ValueError(mode)


def pred_chroma8x8(mode: int, top: np.ndarray | None, left: np.ndarray | None,
                   topleft: int | None) -> np.ndarray:
    """Intra chroma 8x8 prediction (§8.3.4)."""
    if mode == IC_H:
        assert left is not None
        return np.broadcast_to(left.reshape(8, 1), (8, 8)).astype(np.int32)
    if mode == IC_V:
        assert top is not None
        return np.broadcast_to(top.reshape(1, 8), (8, 8)).astype(np.int32)
    if mode == IC_DC:
        out = np.zeros((8, 8), dtype=np.int32)
        # per-4x4-quadrant DC (§8.3.4.1)
        for qy in (0, 1):
            for qx in (0, 1):
                t = top[qx * 4:qx * 4 + 4] if top is not None else None
                l = left[qy * 4:qy * 4 + 4] if left is not None else None
                if qx == qy:
                    # corner quadrants use both if available
                    if t is not None and l is not None:
                        dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                elif qx == 1 and qy == 0:
                    # top-right: prefer top
                    if t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                else:  # qx == 0, qy == 1: prefer left
                    if l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    else:
                        dc = 128
                out[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = dc
        return out
    if mode == IC_P:
        assert top is not None and left is not None and topleft is not None
        tl_row = np.concatenate([[topleft], top]).astype(np.int64)
        lf_col = np.concatenate([[topleft], left]).astype(np.int64)
        H = int(sum((x + 1) * (tl_row[5 + x] - tl_row[3 - x]) for x in range(4)))
        V = int(sum((y + 1) * (lf_col[5 + y] - lf_col[3 - y]) for y in range(4)))
        a = 16 * (int(left[7]) + int(top[7]))
        b = (17 * H + 16) >> 5
        c = (17 * V + 16) >> 5
        yy, xx = np.mgrid[0:8, 0:8]
        return _clip((a + b * (xx - 3) + c * (yy - 3) + 16) >> 5).astype(np.int32)
    raise ValueError(mode)


def pred4x4(mode: int, top: np.ndarray | None, topright: np.ndarray | None,
            left: np.ndarray | None, topleft: int | None) -> np.ndarray:
    """Intra_4x4 prediction (§8.3.1.2). top/topright/left are length-4.

    Caller must already apply §8.3.1.2.1's substitution for unavailable
    top-right (replicate top[3]) — or pass topright=None and it is applied
    here when top is available.
    """
    if top is not None and topright is None:
        topright = np.full(4, top[3], dtype=np.int64)
    t = np.concatenate([top, topright]).astype(np.int64) if top is not None else None
    l = left.astype(np.int64) if left is not None else None
    tl = int(topleft) if topleft is not None else None
    out = np.zeros((4, 4), dtype=np.int64)

    if mode == I4_V:
        return np.broadcast_to(t[:4].reshape(1, 4), (4, 4)).astype(np.int32)
    if mode == I4_H:
        return np.broadcast_to(l.reshape(4, 1), (4, 4)).astype(np.int32)
    if mode == I4_DC:
        if t is not None and l is not None:
            dc = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
        elif t is not None:
            dc = (int(t[:4].sum()) + 2) >> 2
        elif l is not None:
            dc = (int(l.sum()) + 2) >> 2
        else:
            dc = 128
        return np.full((4, 4), dc, dtype=np.int32)
    # helpers honoring p[-1] == topleft
    def pt(j):  # top row p[j, -1], j may be -1 (topleft)
        return tl if j < 0 else t[j]

    def pl(j):  # left col p[-1, j], j may be -1 (topleft)
        return tl if j < 0 else l[j]

    if mode == I4_DDL:
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    out[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    out[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_DDR:
        for y in range(4):
            for x in range(4):
                if x > y:
                    out[y, x] = (pt(x - y - 2) + 2 * pt(x - y - 1) + pt(x - y) + 2) >> 2
                elif x < y:
                    out[y, x] = (pl(y - x - 2) + 2 * pl(y - x - 1) + pl(y - x) + 2) >> 2
                else:
                    out[y, x] = (t[0] + 2 * tl + l[0] + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_VR:  # §8.3.1.2.6
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    out[y, x] = (pt(i - 1) + pt(i) + 1) >> 1
                elif z >= 0:
                    out[y, x] = (pt(i - 2) + 2 * pt(i - 1) + pt(i) + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    out[y, x] = (pl(y - 1) + 2 * pl(y - 2) + pl(y - 3) + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_HD:  # §8.3.1.2.7
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    out[y, x] = (pl(i - 1) + pl(i) + 1) >> 1
                elif z >= 0:
                    out[y, x] = (pl(i - 2) + 2 * pl(i - 1) + pl(i) + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    out[y, x] = (pt(x - 1) + 2 * pt(x - 2) + pt(x - 3) + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_VL:
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    out[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    out[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_HU:
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 5 and z % 2 == 0:
                    i = y + (x >> 1)
                    out[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 5:
                    i = y + (x >> 1)
                    out[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 5:
                    out[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    out[y, x] = l[3]
        return out.astype(np.int32)
    raise ValueError(mode)


def _pref(arr, tl, j):
    """Reference sample with index -1 meaning the top-left p'[-1,-1]."""
    return tl if j < 0 else arr[j]


def _filter_ref8x8(top: np.ndarray | None, left: np.ndarray | None,
                   topleft: int | None):
    """Intra_8x8 reference sample filtering (§8.3.2.2.1).

    top: length-16 (top + top-right, caller already substituted an
    unavailable top-right by replicating top[7]); left: length-8;
    topleft: sample or None.  Returns (top', left', topleft')."""
    ft = fl = ftl = None
    if top is not None:
        t = top.astype(np.int64)
        ft = np.empty(16, np.int64)
        if topleft is not None:
            ft[0] = (topleft + 2 * t[0] + t[1] + 2) >> 2
        else:
            ft[0] = (3 * t[0] + t[1] + 2) >> 2
        ft[1:15] = (t[:14] + 2 * t[1:15] + t[2:16] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if left is not None:
        l_ = left.astype(np.int64)
        fl = np.empty(8, np.int64)
        if topleft is not None:
            fl[0] = (topleft + 2 * l_[0] + l_[1] + 2) >> 2
        else:
            fl[0] = (3 * l_[0] + l_[1] + 2) >> 2
        fl[1:7] = (l_[:6] + 2 * l_[1:7] + l_[2:8] + 2) >> 2
        fl[7] = (l_[6] + 3 * l_[7] + 2) >> 2
    if topleft is not None:
        tl = int(topleft)
        if top is not None and left is not None:
            ftl = (int(top[0]) + 2 * tl + int(left[0]) + 2) >> 2
        elif top is not None:
            ftl = (3 * tl + int(top[0]) + 2) >> 2
        elif left is not None:
            ftl = (3 * tl + int(left[0]) + 2) >> 2
        else:
            ftl = tl
    return ft, fl, ftl


def pred8x8(mode: int, top: np.ndarray | None, topright: np.ndarray | None,
            left: np.ndarray | None, topleft: int | None) -> np.ndarray:
    """Intra_8x8 luma prediction (§8.3.2.2).  Same 9 modes as Intra_4x4
    but on filtered reference samples.  top/topright length-8, left
    length-8, all UNfiltered; substitution for an unavailable top-right
    (replicate top[7]) happens here."""
    if top is not None:
        tr = (topright if topright is not None
              else np.full(8, top[7], dtype=np.int64))
        raw_t = np.concatenate([np.asarray(top, np.int64),
                                np.asarray(tr, np.int64)])
    else:
        raw_t = None
    t, l, tl = _filter_ref8x8(raw_t, left, topleft)
    out = np.zeros((8, 8), dtype=np.int64)

    if mode == I4_V:
        return np.broadcast_to(t[:8].reshape(1, 8), (8, 8)).astype(np.int32)
    if mode == I4_H:
        return np.broadcast_to(l.reshape(8, 1), (8, 8)).astype(np.int32)
    if mode == I4_DC:
        if t is not None and l is not None:
            dc = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif t is not None:
            dc = (int(t[:8].sum()) + 4) >> 3
        elif l is not None:
            dc = (int(l.sum()) + 4) >> 3
        else:
            dc = 128
        return np.full((8, 8), dc, dtype=np.int32)
    if mode == I4_DDL:
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    out[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    out[y, x] = (t[x + y] + 2 * t[x + y + 1]
                                 + t[x + y + 2] + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_DDR:
        for y in range(8):
            for x in range(8):
                if x > y:
                    out[y, x] = (_pref(t, tl, x - y - 2)
                                 + 2 * _pref(t, tl, x - y - 1)
                                 + t[x - y] + 2) >> 2
                elif x < y:
                    out[y, x] = (_pref(l, tl, y - x - 2)
                                 + 2 * _pref(l, tl, y - x - 1)
                                 + l[y - x] + 2) >> 2
                else:
                    out[y, x] = (t[0] + 2 * tl + l[0] + 2) >> 2
        return out.astype(np.int32)
    # index -1 refers to the (filtered) top-left sample p'[-1,-1]
    def pt(j):
        return tl if j < 0 else t[j]

    def pl(j):
        return tl if j < 0 else l[j]

    if mode == I4_VR:
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    out[y, x] = (pt(x - (y >> 1) - 1) + pt(x - (y >> 1))
                                 + 1) >> 1
                elif z >= 0:
                    out[y, x] = (pt(x - (y >> 1) - 2)
                                 + 2 * pt(x - (y >> 1) - 1)
                                 + pt(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    out[y, x] = (pl(y - 2 * x - 1) + 2 * pl(y - 2 * x - 2)
                                 + pl(y - 2 * x - 3) + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_HD:
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    out[y, x] = (pl(y - (x >> 1) - 1) + pl(y - (x >> 1))
                                 + 1) >> 1
                elif z >= 0:
                    out[y, x] = (pl(y - (x >> 1) - 2)
                                 + 2 * pl(y - (x >> 1) - 1)
                                 + pl(y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    out[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    out[y, x] = (pt(x - 2 * y - 1) + 2 * pt(x - 2 * y - 2)
                                 + pt(x - 2 * y - 3) + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_VL:
        for y in range(8):
            for x in range(8):
                if y % 2 == 0:
                    out[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1]
                                 + 1) >> 1
                else:
                    out[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                                 + t[x + (y >> 1) + 2] + 2) >> 2
        return out.astype(np.int32)
    if mode == I4_HU:
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z < 13 and z % 2 == 0:
                    out[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1]
                                 + 1) >> 1
                elif z < 13:
                    out[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                                 + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 13:
                    out[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    out[y, x] = l[7]
        return out.astype(np.int32)
    raise ValueError(mode)
