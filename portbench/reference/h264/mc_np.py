# Frozen copy of x264vfw_tpu_torch/ops/mc_np.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""Inter motion compensation — exact numpy implementation (§8.4.2.2).

Quarter-pel luma (6-tap [1,-5,20,20,-5,1] halfpel + averaging) and
eighth-pel bilinear chroma, with spec-conformant edge clamping.
Golden model for the device (JAX) MC in `mc.py`.
"""

from __future__ import annotations

import numpy as np


def _filter6(w: np.ndarray, axis: int) -> np.ndarray:
    """6-tap [1,-5,20,20,-5,1] along axis; output length = len-5."""
    s = [slice(None)] * w.ndim

    def sl(i):
        t = list(s)
        n = w.shape[axis]
        t[axis] = slice(i, n - 5 + i)
        return w[tuple(t)]

    return (sl(0) - 5 * sl(1) + 20 * sl(2) + 20 * sl(3) - 5 * sl(4) + sl(5))


def luma_mc(ref: np.ndarray, x0: int, y0: int, mvx: int, mvy: int,
            w: int, h: int) -> np.ndarray:
    """Predict a w x h luma block at (x0, y0) displaced by quarter-pel MV."""
    H, W = ref.shape
    xi = x0 + (mvx >> 2)
    yi = y0 + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3

    ys = np.clip(np.arange(yi - 2, yi + h + 3), 0, H - 1)
    xs = np.clip(np.arange(xi - 2, xi + w + 3), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)  # (h+5, w+5)

    G = win[2:2 + h, 2:2 + w]
    if xf == 0 and yf == 0:
        return G.astype(np.int32)

    # horizontal halfpel (intermediate b1 at all rows), vertical halfpel
    b1 = _filter6(win, axis=1)            # (h+5, w)
    b = np.clip((b1 + 16) >> 5, 0, 255)   # rows at integer y
    h1 = _filter6(win, axis=0)            # (h, w+5)
    hh = np.clip((h1 + 16) >> 5, 0, 255)
    # center j from vertical filter applied to b1
    j1 = _filter6(b1, axis=0)             # (h, w)
    j = np.clip((j1 + 512) >> 10, 0, 255)

    b_mid = b[2:2 + h, :]
    b_below = b[3:3 + h, :]
    h_mid = hh[:, 2:2 + w]
    h_right = hh[:, 3:3 + w]
    G_right = win[2:2 + h, 3:3 + w]
    G_below = win[3:3 + h, 2:2 + w]

    if (xf, yf) == (2, 0):
        out = b_mid
    elif (xf, yf) == (0, 2):
        out = h_mid
    elif (xf, yf) == (2, 2):
        out = j
    elif (xf, yf) == (1, 0):
        out = (G + b_mid + 1) >> 1
    elif (xf, yf) == (3, 0):
        out = (G_right + b_mid + 1) >> 1
    elif (xf, yf) == (0, 1):
        out = (G + h_mid + 1) >> 1
    elif (xf, yf) == (0, 3):
        out = (G_below + h_mid + 1) >> 1
    elif (xf, yf) == (1, 1):
        out = (b_mid + h_mid + 1) >> 1
    elif (xf, yf) == (3, 1):
        out = (b_mid + h_right + 1) >> 1
    elif (xf, yf) == (1, 3):
        out = (b_below + h_mid + 1) >> 1
    elif (xf, yf) == (3, 3):
        out = (b_below + h_right + 1) >> 1
    elif (xf, yf) == (2, 1):
        out = (b_mid + j + 1) >> 1
    elif (xf, yf) == (2, 3):
        out = (b_below + j + 1) >> 1
    elif (xf, yf) == (1, 2):
        out = (h_mid + j + 1) >> 1
    elif (xf, yf) == (3, 2):
        out = (h_right + j + 1) >> 1
    else:  # pragma: no cover
        raise AssertionError((xf, yf))
    return out.astype(np.int32)


def chroma_mc(ref: np.ndarray, cx0: int, cy0: int, mvx: int, mvy: int,
              w: int, h: int) -> np.ndarray:
    """Predict a w x h chroma block; MV is the luma quarter-pel MV
    (chroma displacement = mv/2 with eighth-pel fraction)."""
    H, W = ref.shape
    xi = cx0 + (mvx >> 3)
    yi = cy0 + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    ys = np.clip(np.arange(yi, yi + h + 1), 0, H - 1)
    xs = np.clip(np.arange(xi, xi + w + 1), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)
    A = win[:h, :w]
    B = win[:h, 1:w + 1]
    C = win[1:h + 1, :w]
    D = win[1:h + 1, 1:w + 1]
    out = ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B
           + (8 - xf) * yf * C + xf * yf * D + 32) >> 6
    return out.astype(np.int32)
