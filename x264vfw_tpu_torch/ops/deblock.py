"""Deblocking support: the §8.7 threshold tables and the edge-parameter maps.

Port of x264vfw_tpu/ops/deblock.py (build_maps and its helpers) with the
tables of x264vfw_tpu/ops/deblock_np.py copied.  Boundary strength,
alpha/beta and tc0 depend only on coding metadata (intra flags, coded 4x4
blocks, motion vectors, QPs), so they are whole-frame maps computed with
plain tensor ops; the pixel filtering that consumes them is
ops/kernels/deblock.py.

Map packing (one int32 per edge line):
    bits 0..2   bS     (0..4)
    bits 3..7   tc0    (0..25; used by the bS < 4 path only)
    bits 8..15  alpha  (0..255)
    bits 16..20 beta   (0..18)

Four maps cover the frame:
    mapsV  (H,      4*mbw) luma vertical edges, per pixel row
    mapsH  (4*mbh,  W)     luma horizontal edges, per pixel column
    mapsVc (H//2,   2*mbw) chroma vertical edges (shared by U and V)
    mapsHc (2*mbh,  W//2)  chroma horizontal edges
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import chroma_qp

ALPHA_TABLE = np.array(
    [0] * 16 +
    [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40,
     45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226,
     255, 255], dtype=np.int32)

BETA_TABLE = np.array(
    [0] * 16 +
    [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
     12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18], dtype=np.int32)

# Table 8-17: tc0 by (bS - 1, indexA)
TC0_TABLE = np.array([
    [0] * 16 + [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0] * 16 + [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17],
    [0] * 16 + [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4,
                4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25],
], dtype=np.int32)

# full luma-QP -> chroma-QP lookup (offset already applied by the caller)
_CQP_FULL = np.array([int(chroma_qp(q, 0)) for q in range(52)], np.int32)


def _pack(bs, tc0, alpha, beta):
    return (bs | (tc0 << 3) | (alpha << 8) | (beta << 16)).to(torch.int32)


def _lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.int32,
                           device=idx.device)[idx.long()]


def _qp_params(qp_p, qp_q, offA: int, offB: int):
    """(alpha, beta, indexA) of the averaged QP pair."""
    qpav = (qp_p + qp_q + 1) >> 1
    ia = (qpav + offA).clamp(0, 51)
    ib = (qpav + offB).clamp(0, 51)
    return _lut(ALPHA_TABLE, ia), _lut(BETA_TABLE, ib), ia


def _tc0(bs, ia):
    """tc0 for bS in 1..3 from Table 8-17, 0 where bS is 0 (bS 4 takes the
    bS 3 row: its strong filter never reads tc0)."""
    row = (bs.clamp(1, 3) - 1).long()
    t = torch.as_tensor(TC0_TABLE, dtype=torch.int32, device=bs.device)
    return torch.where(bs > 0, t[row, ia.long()], 0)


def _prev(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a shifted by one along dim, the first entry repeated."""
    first = a.narrow(dim, 0, 1)
    return torch.cat([first, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def _bs_between(p_intra, q_intra, tc_p, tc_q, mv_p, mv_q, ref_p, ref_q,
                mb_edge):
    intra_any = p_intra | q_intra
    mv_big = ((mv_p[..., 0] - mv_q[..., 0]).abs() >= 4) | \
             ((mv_p[..., 1] - mv_q[..., 1]).abs() >= 4)
    inter_bs = torch.where((tc_p > 0) | (tc_q > 0), 2,
                           torch.where((ref_p != ref_q) | mv_big, 1, 0))
    return torch.where(intra_any, torch.where(mb_edge, 4, 3),
                       inter_bs).to(torch.int32)


def build_maps(intra_mb, tc4, mv4, ref4, qp_map, offA: int, offB: int,
               chroma_qp_offset: int, t8_4=None):
    """Edge-parameter maps for one frame.

    intra_mb (mbh, mbw) bool; tc4 (4mbh, 4mbw) int32 total_coeff per 4x4;
    mv4 (4mbh, 4mbw, 2) int32 quarter-pel; ref4 (4mbh, 4mbw) int32;
    qp_map (mbh, mbw) int32.  offA/offB = 2 * the slice offsets.  t8_4
    (4mbh, 4mbw) bool, optional: the 4x4 blocks of 8x8-transformed MBs,
    whose internal luma edges 1 and 3 are not filtered (§8.7).
    Returns (mapsV, mapsH, mapsVc, mapsHc) int32."""
    mbh, mbw = intra_mb.shape
    dev = intra_mb.device
    rep = torch.repeat_interleave
    intra4 = rep(rep(intra_mb, 4, 0), 4, 1)

    # ---- vertical edges: q block at (by, bx), p at (by, bx - 1) ----
    bx = torch.arange(4 * mbw, device=dev)
    bsv = _bs_between(_prev(intra4, 1), intra4, _prev(tc4, 1), tc4,
                      _prev(mv4, 1), mv4, _prev(ref4, 1), ref4,
                      (bx % 4 == 0)[None, :])
    bsv[:, 0] = 0                                        # frame left edge
    if t8_4 is not None:
        bsv = torch.where(((bx % 4 == 1) | (bx % 4 == 3))[None, :] & t8_4,
                          0, bsv)
    # edge column 4x + e takes the left MB's QP as qp_p only for e == 0
    qq = rep(qp_map, 4, 1)                               # (mbh, 4mbw)
    qp_pv = torch.where((bx % 4 == 0)[None, :], rep(_prev(qp_map, 1), 4, 1),
                        qq)
    alpha_v, beta_v, ia_v = _qp_params(qp_pv, qq, offA, offB)
    alpha_v, beta_v, ia_v = (rep(a, 4, 0) for a in (alpha_v, beta_v, ia_v))
    mapsV = rep(_pack(bsv, _tc0(bsv, ia_v), alpha_v, beta_v), 4, 0)

    # ---- horizontal edges: q block at (by, bx), p at (by - 1, bx) ----
    by = torch.arange(4 * mbh, device=dev)
    bsh = _bs_between(_prev(intra4, 0), intra4, _prev(tc4, 0), tc4,
                      _prev(mv4, 0), mv4, _prev(ref4, 0), ref4,
                      (by % 4 == 0)[:, None])
    bsh[0, :] = 0                                        # frame top edge
    if t8_4 is not None:
        bsh = torch.where(((by % 4 == 1) | (by % 4 == 3))[:, None] & t8_4,
                          0, bsh)
    qq_h = rep(qp_map, 4, 0)                             # (4mbh, mbw)
    qp_ph = torch.where((by % 4 == 0)[:, None], rep(_prev(qp_map, 0), 4, 0),
                        qq_h)
    alpha_h, beta_h, ia_h = _qp_params(qp_ph, qq_h, offA, offB)
    alpha_h, beta_h, ia_h = (rep(a, 4, 1) for a in (alpha_h, beta_h, ia_h))
    mapsH = rep(_pack(bsh, _tc0(bsh, ia_h), alpha_h, beta_h), 4, 1)

    # ---- chroma: bS of the luma edges 0 and 2 of each MB; thresholds
    # from the averaged chroma QP pair ----
    qpc_map = _lut(_CQP_FULL, (qp_map + chroma_qp_offset).clamp(0, 51))

    bsv_c = rep(bsv.reshape(4 * mbh, mbw, 4)[:, :, ::2]
                .reshape(4 * mbh, 2 * mbw), 2, 0)        # (8mbh, 2mbw)
    e0 = (torch.arange(2 * mbw, device=dev) % 2 == 0)[None, :]
    qpc_q_v = rep(qpc_map, 2, 1)                         # (mbh, 2mbw)
    qpc_pv = torch.where(e0, rep(_prev(qpc_map, 1), 2, 1), qpc_q_v)
    al_cv, be_cv, ia_cv = (rep(a, 8, 0) for a in
                           _qp_params(qpc_pv, qpc_q_v, offA, offB))
    mapsVc = _pack(bsv_c, _tc0(bsv_c, ia_cv), al_cv, be_cv)

    bsh_c = rep(bsh.reshape(mbh, 4, 4 * mbw)[:, ::2, :]
                .reshape(2 * mbh, 4 * mbw), 2, 1)        # (2mbh, Wc)
    f0 = (torch.arange(2 * mbh, device=dev) % 2 == 0)[:, None]
    qpc_q_h = rep(qpc_map, 2, 0)                         # (2mbh, mbw)
    qpc_ph = torch.where(f0, rep(_prev(qpc_map, 0), 2, 0), qpc_q_h)
    al_ch, be_ch, ia_ch = (rep(a, 8, 1) for a in
                           _qp_params(qpc_ph, qpc_q_h, offA, offB))
    mapsHc = _pack(bsh_c, _tc0(bsh_c, ia_ch), al_ch, be_ch)
    return mapsV, mapsH, mapsVc, mapsHc
