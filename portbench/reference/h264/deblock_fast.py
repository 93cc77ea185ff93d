"""The in-loop deblocking filter of deblock_np.deblock_frame (§8.7), with
the same arithmetic (deblock_np's filter_luma_lines and
filter_chroma_lines) over many macroblocks at once.

deblock_np filters MB by MB in raster order: each MB's vertical edges,
then its horizontal edges, each edge reading what the edges before it
wrote.  MB (x, y) reads what MB (x - 1, y), MB (x, y - 1) and MB (x + 1,
y - 1) wrote and nothing of the MBs with the same x + 2y, so the MBs of
one such diagonal are filtered together, diagonal after diagonal: every
sample goes through the same edges in the same order, and the result is
deblock_np's (tests/test_portbench_reference.py holds the two equal).
The boundary strengths follow deblock_np.bs_edge, for the whole picture
at once.
"""

from __future__ import annotations

import numpy as np

from .deblock_np import (ALPHA_TABLE, BETA_TABLE, TC0_TABLE,
                         filter_chroma_lines, filter_luma_lines)
from . import transform_np as tnp


def _close(a, b):
    """Motion vectors that differ by less than 4 quarter pels in both
    components."""
    return (np.abs(a[..., 0] - b[..., 0]) < 4) & (np.abs(a[..., 1] - b[..., 1]) < 4)


def _motion_bs(p, q, refpic, mv0, mv1):
    """bS 1 or 0 of inter/inter block pairs (deblock_np.bs_edge's motion
    rule); p, q: index tuples of the blocks on each side."""
    r0p, r1p = refpic[0][p], refpic[1][p]
    r0q, r1q = refpic[0][q], refpic[1][q]
    m0p, m1p, m0q, m1q = mv0[p], mv1[p], mv0[q], mv1[q]
    np_ = (r0p >= 0).astype(int) + (r1p >= 0)
    nq = (r0q >= 0).astype(int) + (r1q >= 0)
    # one list: the list in use on each side
    idp = np.where(r0p >= 0, r0p, r1p)
    idq = np.where(r0q >= 0, r0q, r1q)
    mp = np.where((r0p >= 0)[..., None], m0p, m1p)
    mq = np.where((r0q >= 0)[..., None], m0q, m1q)
    one = (idp == idq) & _close(mp, mq)
    # two lists: the same pictures, paired as deblock_np pairs them
    same_set = ((np.minimum(r0p, r1p) == np.minimum(r0q, r1q))
                & (np.maximum(r0p, r1p) == np.maximum(r0q, r1q)))
    straight = _close(m0p, m0q) & _close(m1p, m1q)
    crossed = _close(m0p, m1q) & _close(m1p, m0q)
    two = same_set & np.where(r0p == r1p, straight | crossed,
                              np.where(r0p == r0q, straight, crossed))
    ok = np.where(np_ == 1, one, two)
    return np.where((np_ != nq) | ~ok, 1, 0)


def boundary_strengths(sd):
    """(bsV, bsH): bS of each 4x4 block's left and top edge, 0 where the
    edge is not filtered (the picture's border, the inner edges 1 and 3
    of an 8x8-transform MB)."""
    H4, W4 = sd.mbh * 4, sd.mbw * 4
    mbt = sd.mb_type
    intra = np.repeat(np.repeat((mbt >= 0) & (mbt < 100), 4, 0), 4, 1)
    t8 = getattr(sd, "t8x8", None)
    t8c = getattr(sd, "t8_coded", None)
    coded = sd.tc_luma > 0
    if t8 is not None and t8c is not None:
        t8b = np.repeat(np.repeat(t8, 4, 0), 4, 1)
        coded = np.where(t8b, np.repeat(np.repeat(t8c, 2, 0), 2, 1), coded)
    else:
        t8b = np.zeros((H4, W4), bool)
    refpic = getattr(sd, "refpic", None)
    if refpic is None:      # deblock_np's single-list state
        refpic = np.stack([sd.ref.astype(np.int64),
                           np.full((H4, W4), -1, np.int64)])
        mv1 = np.zeros_like(sd.mv)
    else:
        mv1 = getattr(sd, "mv1", None)
        mv1 = np.zeros_like(sd.mv) if mv1 is None else mv1
    out = []
    for axis in (1, 0):     # vertical edges (left neighbour), horizontal
        bs = np.zeros((H4, W4), np.int32)
        if axis == 1:
            q = (slice(None), slice(1, None))
            p = (slice(None), slice(0, -1))
            idx = np.arange(1, W4)[None, :]
        else:
            q = (slice(1, None), slice(None))
            p = (slice(0, -1), slice(None))
            idx = np.arange(1, H4)[:, None]
        mb_edge = idx % 4 == 0
        b = np.where(intra[q] | intra[p], np.where(mb_edge, 4, 3),
                     np.where(coded[q] | coded[p], 2,
                              _motion_bs(p, q, refpic, sd.mv, mv1)))
        # inner edges 1 and 3 of an 8x8-transform MB are not filtered
        b = np.where(t8b[q] & (idx % 4 % 2 == 1), 0, b)
        bs[q] = b
        out.append(bs)
    return out[0], out[1]


def deblock_frame(sd) -> None:
    """deblock_np.deblock_frame over the same decoder state."""
    h = sd.h
    offA = h.slice_alpha_c0_offset_div2 * 2
    offB = h.slice_beta_offset_div2 * 2
    mbh, mbw = sd.mbh, sd.mbw
    bsV, bsH = boundary_strengths(sd)
    qp = sd.qp_map.astype(np.int64)
    off = sd.pps.chroma_qp_index_offset
    cqp = np.vectorize(lambda v: int(tnp.chroma_qp(int(v), off)))(qp) \
        if qp.size else qp
    lines16 = np.arange(16)
    lines8 = np.arange(8)
    taps4 = np.arange(-4, 4)
    taps2 = np.arange(-2, 2)
    for t in range(mbw + 2 * (mbh - 1)):
        my = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        mx = t - 2 * my
        keep = (mx >= 0) & (mx < mbw)
        mx, my = mx[keep], my[keep]
        if not mx.size:
            continue
        for vertical in (True, False):
            bs_map = bsV if vertical else bsH
            for e in range(4):
                # luma: 16 lines per MB across the edge at 4e
                if vertical:
                    rows = (my[:, None] * 16 + lines16).ravel()
                    cols = np.repeat(mx * 16 + 4 * e, 16)
                    bs = bs_map[rows // 4, cols // 4]
                    nb = (mx - 1 if e == 0 else mx)
                    qp_p = qp[my, np.maximum(nb, 0)]
                else:
                    cols = (mx[:, None] * 16 + lines16).ravel()
                    rows = np.repeat(my * 16 + 4 * e, 16)
                    bs = bs_map[rows // 4, cols // 4]
                    nb = (my - 1 if e == 0 else my)
                    qp_p = qp[np.maximum(nb, 0), mx]
                qpav = (qp_p + qp[my, mx] + 1) >> 1
                ia = np.repeat(np.clip(qpav + offA, 0, 51), 16)
                ib = np.repeat(np.clip(qpav + offB, 0, 51), 16)
                _filter(sd.y, rows, cols, vertical, taps4, bs, ia, ib, True)
                if e % 2:
                    continue
                # chroma: edges 0 and 2, 8 lines per MB, the bS of the
                # luma 4-line group each line pair lies in
                if vertical:
                    crows = (my[:, None] * 8 + lines8).ravel()
                    ccols = np.repeat(mx * 8 + 2 * e, 8)
                    cbs = bs_map[crows // 2, np.repeat(mx * 4 + e, 8)]
                    cq_p = cqp[my, np.maximum(nb, 0)]
                else:
                    ccols = (mx[:, None] * 8 + lines8).ravel()
                    crows = np.repeat(my * 8 + 2 * e, 8)
                    cbs = bs_map[np.repeat(my * 4 + e, 8), ccols // 2]
                    cq_p = cqp[np.maximum(nb, 0), mx]
                qpc = (cq_p + cqp[my, mx] + 1) >> 1
                ia = np.repeat(np.clip(qpc + offA, 0, 51), 8)
                ib = np.repeat(np.clip(qpc + offB, 0, 51), 8)
                for plane in (sd.u, sd.v):
                    _filter(plane, crows, ccols, vertical, taps2, cbs, ia, ib,
                            False)


def _filter(plane, rows, cols, vertical, taps, bs, ia, ib, luma) -> None:
    """Filter one edge of many lines in place: line k crosses the edge at
    (rows[k], cols[k])."""
    on = bs > 0
    if not on.any():
        return
    rows, cols, bs, ia, ib = rows[on], cols[on], bs[on], ia[on], ib[on]
    if vertical:
        R = rows[:, None]
        C = cols[:, None] + taps
    else:
        R = rows[:, None] + taps
        C = cols[:, None]
    R, C = np.broadcast_arrays(R, C)
    s = plane[R, C]
    n = taps.size // 2
    alpha, beta = ALPHA_TABLE[ia], BETA_TABLE[ib]
    tc0 = TC0_TABLE[np.clip(bs, 1, 3) - 1, ia]
    fn = filter_luma_lines if luma else filter_chroma_lines
    P, Q = fn(s[:, :n], s[:, n:], bs, alpha, beta, tc0)
    plane[R, C] = np.concatenate([P, Q], axis=1)
