"""P-frame inter partitions (16x16 / 16x8 / 8x16 / 8x8): ME, MC and mvds.

Port of x264vfw_tpu/encode/inter_partition.py for one reference.  The
motion field lives on the 8x8 grid (2mbh, 2mbw, 2): one vector per
quadrant, repeated within larger partitions.

* One full search (ops/kernels/sad.sad_partition_minima, scales 4/2/2/1)
  gives every partition shape's best integer vector and cost.
* The layout per MB is argmin(cost + lambda * header bits estimate).
* ops/kernels/memc.partition_refine_mc refines each partition by quarter
  pels (its blocks share one delta) and forms the luma prediction.
* Chroma is one 4x4 block per luma 8x8, eighth-pel bilinear.
* partition_mvds derives the §8.4.1.3 predictions (median and the
  directional 16x8 / 8x16 rules) and the P_Skip condition.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.memc import partition_refine_mc
from ..ops.kernels.sad import sad_partition_minima
from .device import _chroma_mc, _edge_pad

# lambda for the header-bit estimate, max(1, round(3.4 * 2^((qp-12)/3)))
# in float32 as the JAX package computes it, one entry per QP
LAMBDA = np.maximum(1, np.round(
    np.float32(3.4) * np.exp2((np.arange(52, dtype=np.float32)
                               - np.float32(12.0)) / np.float32(3.0))
)).astype(np.int32)


def _k_to_mv(k: torch.Tensor, K: int, rng: int) -> torch.Tensor:
    return torch.stack([k % K - rng, torch.div(k, K, rounding_mode="floor")
                        - rng], dim=-1).to(torch.int32)


def partition_decide_from_minima(mins: dict, rng: int, qp: int):
    """Layout decision from the per-shape minima of sad_partition_minima.
    Returns (part (mbh, mbw) int32 in {0: 16x16, 1: 16x8, 2: 8x16,
    3: 8x8}, mv8i (2mbh, 2mbw, 2) int32 full-pel); ties in the layout go
    to the smallest code."""
    K = 2 * rng + 1
    mbh, mbw = mins["v16"].shape
    rep = torch.repeat_interleave
    mv16 = _k_to_mv(mins["k16"], K, rng)                   # (mbh, mbw, 2)
    mv168 = _k_to_mv(mins["k168"], K, rng)                 # (mbh, mbw, 2h, 2)
    mv816 = _k_to_mv(mins["k816"], K, rng)                 # (mbh, mbw, 2v, 2)
    mv8q = _k_to_mv(mins["k8"], K, rng)                    # (2mbh, 2mbw, 2)
    v8m = mins["v8"].reshape(mbh, 2, mbw, 2).sum((1, 3), dtype=torch.int32)
    lam = int(LAMBDA[qp])
    cost = torch.stack([mins["v16"] + lam * 7,
                        mins["v168"].sum(-1, dtype=torch.int32) + lam * 15,
                        mins["v816"].sum(-1, dtype=torch.int32) + lam * 15,
                        v8m + lam * 33])
    part = torch.zeros(mbh, mbw, dtype=torch.int32, device=cost.device)
    best = cost[0]
    for c in (1, 2, 3):                 # strict < keeps the smallest code
        part = torch.where(cost[c] < best, c, part).to(torch.int32)
        best = torch.minimum(cost[c], best)

    f16 = rep(rep(mv16, 2, 0), 2, 1)
    f168 = rep(mv168.permute(0, 2, 1, 3).reshape(2 * mbh, mbw, 2), 2, 1)
    f816 = rep(mv816.reshape(mbh, 2 * mbw, 2), 2, 0)
    p8 = rep(rep(part, 2, 0), 2, 1)[..., None]
    mv8 = torch.where(p8 == 0, f16, torch.where(
        p8 == 1, f168, torch.where(p8 == 2, f816, mv8q)))
    return part, mv8.contiguous()


def partition_search_and_mc(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                            rng: int, qp: int, subpel=2):
    """Full partition ME + MC (exhaustive search at every shape; the JAX
    package also searches exhaustively here whatever the ':hier' suffix).
    Chroma is one 4x4 block per luma 8x8 (JAX: _chroma_mc_8x8).  Returns
    (part (mbh, mbw), mv8 (2mbh, 2mbw, 2) quarter-pel, pred_y, pred_u,
    pred_v) int32."""
    pad = rng + 8
    src8 = src_y.to(torch.uint8).contiguous()
    ref_pad = _edge_pad(ref_y, pad).to(torch.uint8).contiguous()
    mins = sad_partition_minima(src8, ref_pad[8:-8, 8:-8].contiguous(), rng,
                                (4, 2, 2, 1))
    part, mv8i = partition_decide_from_minima(mins, rng, qp)
    sub_lv = 2 if subpel is True else int(subpel)
    mv8, pred_y = partition_refine_mc(src8, ref_pad, mv8i, part, rng, sub_lv)
    pred_u, pred_v = _chroma_mc(mv8, ref_u, ref_v, 4)
    return part, mv8, pred_y, pred_u, pred_v


# --------------------------------------------------------------------------
# MV prediction / mvd derivation (§8.4.1.3) on the 8x8 grid, one reference:
# every available inter neighbour has refIdx 0, so "refIdxN == refIdx"
# reduces to availability.
# --------------------------------------------------------------------------

def _median3(a, b, c):
    return a + b + c - torch.maximum(a, torch.maximum(b, c)) \
        - torch.minimum(a, torch.minimum(b, c))


def _pmv(A, aA, B, aB, C, aC, D, aD):
    """Median rule with the C -> D fallback and the 1-match / A-only
    cases."""
    Ce = torch.where(aC[..., None], C, D)
    aCe = aC | aD
    only_a = aA & ~aB & ~aCe
    n = aA.int() + aB.int() + aCe.int()
    mA = torch.where(aA[..., None], A, 0)
    mB = torch.where(aB[..., None], B, 0)
    mC = torch.where(aCe[..., None], Ce, 0)
    med = _median3(mA, mB, mC)
    one = torch.where(aA[..., None], mA, torch.where(aB[..., None], mB, mC))
    return torch.where(only_a[..., None], mA,
                       torch.where((n == 1)[..., None], one, med))


def _quadmap(v00, v01, v10, v11):
    """Per-MB values of the four quadrants -> the 8x8 grid."""
    q = torch.stack([torch.stack([v00, v01], 2), torch.stack([v10, v11], 2)],
                    2)                                    # (mbh, mbw, 2, 2, ...)
    mbh, mbw = q.shape[:2]
    rest = tuple(q.shape[4:])
    return q.permute(0, 2, 1, 3, *range(4, q.dim())).reshape(
        2 * mbh, 2 * mbw, *rest)


def partition_mvds(mv8, part):
    """mv8 (2mbh, 2mbw, 2) quarter-pel, part (mbh, mbw) in {0..3} ->
    (mvd8 (2mbh, 2mbw, 2): each partition's mvd at its FIRST quadrant
     slot, zeros elsewhere;
     nslot (2mbh, 2mbw) bool: the quadrant slots that carry an mvd;
     skip_zero (mbh, mbw) bool: P_Skip's derived vector is zero)."""
    qh, qw, _ = mv8.shape
    mbh, mbw = qh // 2, qw // 2
    dev = mv8.device
    mv8p = torch.zeros(qh + 4, qw + 4, 2, dtype=mv8.dtype, device=dev)
    mv8p[2:-2, 2:-2] = mv8

    def rd(Y, X):
        """The vector at (2my + Y, 2mx + X) for every MB."""
        return mv8p[Y + 2::2, X + 2::2][:mbh, :mbw]

    my = torch.arange(mbh, device=dev)[:, None].expand(mbh, mbw)
    mx = torch.arange(mbw, device=dev)[None, :].expand(mbh, mbw)
    has_l = mx > 0
    has_t = my > 0
    has_tr = has_t & (mx < mbw - 1)
    has_tl = has_t & has_l
    ones = torch.ones(mbh, mbw, dtype=torch.bool, device=dev)
    nope = ~ones

    q00, q01, q10 = rd(0, 0), rd(0, 1), rd(1, 0)

    # ---- 16x16 ----
    A, B, C, D = rd(0, -1), rd(-1, 0), rd(-1, 2), rd(-1, -1)
    pmv16 = _pmv(A, has_l, B, has_t, C, has_tr, D, has_tl)
    # P_Skip §8.4.1.1: A/B unavailable or a zero vector forces mv 0
    skip_cond = (~has_l) | (~has_t) | (has_l & (A == 0).all(-1)) \
        | (has_t & (B == 0).all(-1))
    skip_zero = (torch.where(skip_cond[..., None], 0, pmv16) == 0).all(-1)

    # ---- 16x8 (§8.4.1.3.1 directional) ----
    p168_t = torch.where(has_t[..., None], B, pmv16)
    A2, D2 = rd(1, -1), rd(0, -1)
    p168_b = torch.where(has_l[..., None], A2,
                         _pmv(A2, has_l, q00, ones, D2, nope, D2, has_l))
    # ---- 8x16 ----
    p816_l = torch.where(has_l[..., None], A,
                         _pmv(A, has_l, B, has_t, rd(-1, 1), has_t, D,
                              has_tl))
    # right partition: the directional rule applies to the EFFECTIVE C
    # (after the D fallback, D = the MB above)
    C2, D2r = rd(-1, 2), rd(-1, 0)
    Ce816 = torch.where(has_tr[..., None], C2, D2r)
    p816_r = torch.where((has_tr | has_t)[..., None], Ce816,
                         _pmv(q00, ones, rd(-1, 1), has_t, C2, has_tr, D2r,
                              has_t))
    # ---- 8x8 sub-blocks: the median rule per sub-block ----
    p8_0 = _pmv(A, has_l, B, has_t, rd(-1, 1), has_t, D, has_tl)
    p8_1 = _pmv(q00, ones, rd(-1, 1), has_t, C, has_tr, rd(-1, 0), has_t)
    p8_2 = _pmv(rd(1, -1), has_l, q00, ones, q01, ones, rd(0, -1), has_l)
    p8_3 = _pmv(q10, ones, q01, ones, torch.zeros_like(q01), nope, q00, ones)

    z2 = torch.zeros_like(q00)
    p8x = torch.repeat_interleave(torch.repeat_interleave(part, 2, 0), 2, 1)
    pm = torch.where(p8x[..., None] == 0, _quadmap(pmv16, z2, z2, z2),
                     torch.where(p8x[..., None] == 1,
                                 _quadmap(p168_t, z2, p168_b, z2),
                                 torch.where(p8x[..., None] == 2,
                                             _quadmap(p816_l, p816_r, z2, z2),
                                             _quadmap(p8_0, p8_1, p8_2,
                                                      p8_3))))
    t, f = ones, nope
    nslot = torch.where(p8x == 0, _quadmap(t, f, f, f), torch.where(
        p8x == 1, _quadmap(t, f, t, f), torch.where(
            p8x == 2, _quadmap(t, t, f, f), _quadmap(t, t, t, t))))
    mvd8 = torch.where(nslot[..., None], mv8 - pm, 0).to(torch.int32)
    return mvd8, nslot, skip_zero
