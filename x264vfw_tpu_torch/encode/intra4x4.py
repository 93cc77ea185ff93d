"""Intra_4x4 encode: all 9 prediction modes with exact recon feedback
(PyTorch).

Port of x264vfw_tpu/encode/intra4x4.py: the per-MB-batch I4x4 encode run
inside the slope-2 intra wavefront (encode/intra_wavefront.py) when
--partitions has i4x4.

Every 4x4 prediction sample is (w[i1] + 2*w[i2] + w[i3] + 2) >> 2 over a
13-sample neighbour vector w = [tl, t0..t7, l0..l3]: 3-tap filters use
(i1, i2, i3) directly, a 2-tap (a+b+1)>>1 becomes (a, b, a) and a copy
(a, a, a).  So the 8 directional modes are one gather and one expression
over the MB batch; only DC has its own (availability-dependent) formula.
The index tables come from the §8.3.1.2.1-9 formulas at import.

The 16 blocks of an MB chain through their decode-order dependencies
(the top-right recon feeds DDL/VL): a Python loop of 16 steps batched
over the wavefront's MB slots, each reading its neighbours from a
bordered canvas of the MB's recon.  The top-right block follows the spec
decode order: raster (by, bx) in _TR_DEAD never sees a decoded
above-right block and uses the p[3,-1] substitution.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import transform as tj

BIG = 1 << 29

# decode order of 4x4 luma blocks (as encode/device.py)
BLK_X = np.asarray([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.asarray([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])

# raster (by, bx) whose above-right block is not decoded yet in the spec's
# decode order (its top-right samples are substituted by p[3,-1]): decode
# indices 3, 7, 11, 13, 15
_TR_DEAD = {(1, 1), (3, 1), (1, 3), (2, 3), (3, 3)}


def _sample_ids(m: int, x: int, y: int):
    """(i1, i2, i3) into w = [tl, t0..t7, l0..l3] for mode m, pixel (x, y),
    from the §8.3.1.2 formulas (2-tap as (a, b, a), copy as (a, a, a))."""
    def T(i):
        return 0 if i == -1 else 1 + i

    def L(j):
        return 0 if j == -1 else 9 + j

    if m == 0:                                    # Vertical
        return (T(x), T(x), T(x))
    if m == 1:                                    # Horizontal
        return (L(y), L(y), L(y))
    if m == 3:                                    # Diagonal Down-Left
        if x == 3 and y == 3:
            return (T(6), T(7), T(7))
        return (T(x + y), T(x + y + 1), T(x + y + 2))
    if m == 4:                                    # Diagonal Down-Right
        if x > y:
            return (T(x - y - 2), T(x - y - 1), T(x - y))
        if x < y:
            return (L(y - x - 2), L(y - x - 1), L(y - x))
        return (T(0), 0, L(0))
    if m == 5:                                    # Vertical-Right
        z = 2 * x - y
        if z >= 0:
            if z % 2 == 0:
                a, b = T(x - (y >> 1) - 1), T(x - (y >> 1))
                return (a, b, a)
            return (T(x - (y >> 1) - 2), T(x - (y >> 1) - 1), T(x - (y >> 1)))
        if z == -1:
            return (L(0), 0, T(0))
        return (L(y - 1), L(y - 2), L(y - 3))
    if m == 6:                                    # Horizontal-Down
        z = 2 * y - x
        if z >= 0:
            if z % 2 == 0:
                a, b = L(y - (x >> 1) - 1), L(y - (x >> 1))
                return (a, b, a)
            return (L(y - (x >> 1) - 2), L(y - (x >> 1) - 1), L(y - (x >> 1)))
        if z == -1:
            return (L(0), 0, T(0))
        return (T(x - 1), T(x - 2), T(x - 3))
    if m == 7:                                    # Vertical-Left
        if y % 2 == 0:
            a, b = T(x + (y >> 1)), T(x + (y >> 1) + 1)
            return (a, b, a)
        return (T(x + (y >> 1)), T(x + (y >> 1) + 1), T(x + (y >> 1) + 2))
    if m == 8:                                    # Horizontal-Up
        z = x + 2 * y
        if z < 5:
            if z % 2 == 0:
                a, b = L(y + (x >> 1)), L(y + (x >> 1) + 1)
                return (a, b, a)
            return (L(y + (x >> 1)), L(y + (x >> 1) + 1), L(y + (x >> 1) + 2))
        if z == 5:
            return (L(2), L(3), L(3))
        return (L(3), L(3), L(3))
    raise ValueError(m)


def _build_tables():
    """(8, 16, 3) index tables for the directional modes
    [0, 1, 3, 4, 5, 6, 7, 8]."""
    dirs = [0, 1, 3, 4, 5, 6, 7, 8]
    t = np.zeros((8, 16, 3), np.int64)
    for mi, m in enumerate(dirs):
        for y in range(4):
            for x in range(4):
                t[mi, 4 * y + x] = _sample_ids(m, x, y)
    return dirs, t


_DIR_MODES, _IDX = _build_tables()

# per block in decode order, where its top-right samples come from:
# 0 = the MB row above (available with the top MB), 1 = the MB above-right,
# 2 = a decoded block of this MB (always available), 3 = never available
_TRCODE = [(0 if bx < 3 else 1) if by == 0
           else (3 if (by, bx) in _TR_DEAD else 2)
           for bx, by in zip(BLK_X.tolist(), BLK_Y.tolist())]

# the neighbours each mode 0..8 reads: V/DDL/VL need the top, H/HU the
# left, the diagonal-down family both; DC is always legal
_TNEED = np.asarray([1, 0, 0, 1, 1, 1, 1, 1, 0], bool)
_LNEED = np.asarray([0, 1, 0, 0, 1, 1, 1, 0, 1], bool)


def _satd4(res: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (...) SATD (sum |H r H^T| >> 1)."""
    return tj.hadamard4x4(res).abs().sum(dim=(-1, -2), dtype=torch.int32) >> 1


def encode_i4x4_batch(src_mb, top_row, tr4_row, left_col, tl_pix,
                      top_modes, left_modes, availT, availL, availTR,
                      qp: int, lam: int):
    """Full I4x4 encode of a batch of MBs (the wavefront's slots).

    src_mb (n, 16, 16) int32; top_row (n, 16) recon bottom row of the MB
    above; tr4_row (n, 4) recon bottom-left 4 of the MB above-right;
    left_col (n, 16) recon right column of the MB left; tl_pix (n,)
    corner; top_modes/left_modes (n, 4) neighbour-MB border block modes
    (2 where the neighbour is not I_NxN); availT/availL/availTR (n,) bool;
    lam the SATD-domain lambda.

    Canvas P (n, 17, 21) holds [tl | top_row | tr4] in row 0, left_col in
    column 0 and the recon inside as it grows; canvas M (n, 5, 5) holds
    the neighbour and own block modes the §8.3.1.1 predictor reads.

    Returns dict: modes (n, 16) decode order, levels (n, 16, 16) zigzag in
    decode order, recon (n, 16, 16), prev (n, 16) bool and rem (n, 16)
    (prev_intra4x4_pred_mode_flag / rem_intra4x4_pred_mode), cbp_luma
    (n,) 4-bit, cost (n,) int32 = SATD + lam * mode bits (without the
    mb_type/cbp overhead), right_modes / bot_modes (n, 4) border modes."""
    n = src_mb.shape[0]
    dev = src_mb.device
    i32 = torch.int32
    idx = torch.as_tensor(_IDX, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    a_tr_src = (availT, availTR, ones, torch.zeros_like(ones))
    tneed = torch.as_tensor(_TNEED, device=dev)
    lneed = torch.as_tensor(_LNEED, device=dev)
    mode_ids = torch.arange(9, device=dev)

    P = torch.zeros(n, 17, 21, dtype=i32, device=dev)
    P[:, 0, 0] = tl_pix
    P[:, 0, 1:17] = top_row
    P[:, 0, 17:21] = tr4_row
    P[:, 1:17, 0] = left_col
    M = torch.full((n, 5, 5), 2, dtype=i32, device=dev)
    M[:, 0, 1:5] = top_modes
    M[:, 1:5, 0] = left_modes

    cost_total = torch.zeros(n, dtype=i32, device=dev)
    modes, prevs, rems, levels = [], [], [], []
    for bi in range(16):
        bx, by, trc = int(BLK_X[bi]), int(BLK_Y[bi]), _TRCODE[bi]
        y0, x0 = 1 + 4 * by, 1 + 4 * bx
        sblk = src_mb[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        t4 = P[:, y0 - 1, x0:x0 + 4]
        tr4 = torch.where(a_tr_src[trc][:, None], P[:, y0 - 1, x0 + 4:x0 + 8],
                          t4[:, 3:4].expand(n, 4))
        l4 = P[:, y0:y0 + 4, x0 - 1]
        tl = P[:, y0 - 1, x0 - 1]
        a_t = ones if by > 0 else availT
        a_l = ones if bx > 0 else availL

        w = torch.cat([tl[:, None], t4, tr4, l4], dim=1)        # (n, 13)
        g = w[:, idx]                                           # (n, 8, 16, 3)
        pd = (g[..., 0] + 2 * g[..., 1] + g[..., 2] + 2) >> 2   # (n, 8, 16)
        # DC (§8.3.1.2.3)
        ts = t4.sum(-1, dtype=i32)
        ls = l4.sum(-1, dtype=i32)
        dc = torch.where(a_t & a_l, (ts + ls + 4) >> 3,
                         torch.where(a_t, (ts + 2) >> 2,
                                     torch.where(a_l, (ls + 2) >> 2, 128)))
        preds = torch.cat([pd[:, 0:2], dc[:, None, None].expand(n, 1, 16)
                           .to(i32), pd[:, 2:]], dim=1).reshape(n, 9, 4, 4)

        # mode cost: SATD + lambda * signalling bits
        satd = _satd4(sblk[:, None] - preds)                    # (n, 9)
        allow = ((a_t[:, None] | ~tneed[None, :])
                 & (a_l[:, None] | ~lneed[None, :]))
        mA = M[:, 1 + by, bx]
        mB = M[:, by, 1 + bx]
        pmode = torch.where(a_t & a_l, torch.minimum(mA, mB), 2)
        mbits = torch.where(mode_ids[None, :] == pmode[:, None], 1, 4)
        cost = torch.where(allow, satd + lam * mbits, BIG)
        mode = torch.argmin(cost, dim=1)
        cost_total = cost_total + cost.gather(1, mode[:, None])[:, 0]
        psel = preds[torch.arange(n, device=dev), mode]          # (n, 4, 4)

        # residual of the 16-coefficient block
        q = tj.quant4x4(tj.fdct4x4(sblk - psel), qp, intra=True)
        levels.append(tj.zigzag_scan(q))
        r = tj.idct4x4_core(tj.dequant4x4(q, qp))
        P[:, y0:y0 + 4, x0:x0 + 4] = (psel + r).clamp(0, 255)
        mode = mode.to(i32)
        M[:, 1 + by, 1 + bx] = mode
        modes.append(mode)
        prevs.append(mode == pmode)
        rems.append(mode - (mode > pmode).to(i32))

    levels = torch.stack(levels, dim=1)                          # (n, 16, 16)
    quad_nz = (levels != 0).any(-1).reshape(n, 4, 4).any(-1)     # (n, 4)
    cbp = (quad_nz * torch.tensor([1, 2, 4, 8], dtype=i32, device=dev)) \
        .sum(-1, dtype=i32)
    # a quadrant is coded iff any of its blocks has coefficients, so an
    # uncoded quadrant's residual is already zero: the recon is exact
    return {"modes": torch.stack(modes, dim=1), "levels": levels,
            "recon": P[:, 1:17, 1:17],
            "prev": torch.stack(prevs, dim=1),
            "rem": torch.stack(rems, dim=1),
            "cbp_luma": cbp, "cost": cost_total,
            "right_modes": M[:, 1:5, 4], "bot_modes": M[:, 4, 1:5]}
