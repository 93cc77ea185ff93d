"""Wavefront I-frame encode with per-MB intra mode decision (PyTorch).

Port of x264vfw_tpu/encode/intra_wavefront.py: full Intra_16x16 mode
decision (V/H/DC/Plane, §8.3.3) and intra chroma mode decision
(DC/H/V/Plane, §8.3.4) under exact reconstruction feedback, and with
i4x4 the 9-mode I_NxN candidate of every MB (encode/intra4x4.py).

Intra prediction of MB (y, x) needs the reconstructed bottom row of
(y-1, x), the right column of (y, x-1) and the corner pixel of
(y-1, x-1): an anti-diagonal wavefront.  Diagonal d = y + x is one step
of a Python loop over mbh + mbw - 1 steps, batched over a fixed slot per
MB row: slot y processes MB (y, d - y), masked when out of range.  Every
dependency is then a static slot shift of the previous step's outputs:
top border of slot y = bottom row emitted at step d-1 by slot y-1; left
border = right column emitted at step d-1 by slot y; corner = bottom row
at step d-2, slot y-1.  Inputs and outputs move between raster and
(step, slot) order with the skew transforms of ops/skew.py.

I4x4 blocks also read the bottom row of the MB above-right, so with
i4x4 the wavefront runs at slope 2: MB (y, x) at step d = 2y + x, in
2(mbh - 1) + mbw steps, and the borders come from steps d-1 (above-right),
d-2 (top) and d-3 (corner).

Mode decisions use SATD (4x4 Hadamard) + a small lambda-weighted rate
bias for the chroma mode's ue() length, as the JAX code does; an MB takes
I_NxN when its I4x4 cost + lam * 7 is below its best I16 cost + lam * 9.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import transform as tj
from ..ops.skew import skew, unskew

BIG = 1 << 29


def satd_lambda(qp: int) -> int:
    """max(1, round(0.85 * 2^((qp - 12) / 3))) in float32, as the JAX
    code computes the SATD-domain lambda."""
    x = np.float32(0.85) * np.exp2((np.float32(qp) - np.float32(12.0))
                                   / np.float32(3.0))
    return int(max(1, np.round(np.float32(x))))


def _satd(res_blocks: torch.Tensor) -> torch.Tensor:
    """(n, nb, 4, 4) residual blocks -> (n,) SATD (sum |H r H^T| >> 1)."""
    return tj.hadamard4x4(res_blocks).abs().sum(dim=(1, 2, 3),
                                                dtype=torch.int32) >> 1


def _mb_blocks(mbs: torch.Tensor) -> torch.Tensor:
    """(n, S, S) -> (n, (S//4)^2, 4, 4) raster blocks."""
    n, S, _ = mbs.shape
    q = S // 4
    return mbs.reshape(n, q, 4, q, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, q * q, 4, 4)


def _satd_mb(src, pred):
    return _satd(_mb_blocks(src - pred))


def _plane_pred(top, left, tl, size: int):
    """§8.3.3.4 / §8.3.4 plane prediction, batched over slots.

    top/left: (n, size), tl: (n,).  size 16 (luma) or 8 (chroma)."""
    h = size // 2
    dev = top.device
    xs = torch.arange(1, h, dtype=torch.int32, device=dev)     # 1..h-1
    hi = (h - 1 + xs).long()
    lo = (h - 1 - xs).long()
    Hs = (xs * (top[:, hi] - top[:, lo])).sum(-1, dtype=torch.int32) \
        + h * (top[:, size - 1] - tl)
    Vs = (xs * (left[:, hi] - left[:, lo])).sum(-1, dtype=torch.int32) \
        + h * (left[:, size - 1] - tl)
    if size == 16:
        b = (5 * Hs + 32) >> 6
        c = (5 * Vs + 32) >> 6
    else:
        b = (17 * Hs + 16) >> 5
        c = (17 * Vs + 16) >> 5
    a = 16 * (left[:, size - 1] + top[:, size - 1])
    yy = torch.arange(size, dtype=torch.int32, device=dev)
    p = (a[:, None, None] + b[:, None, None] * (yy[None, None, :] - (h - 1))
         + c[:, None, None] * (yy[None, :, None] - (h - 1)) + 16) >> 5
    return p.clamp(0, 255)


def _chroma_dc_pred(top, left, availT, availL):
    """§8.3.4.1 per-4x4-quadrant chroma DC, batched.  top/left (n, 8)."""
    n = top.shape[0]
    t0 = top[:, :4].sum(-1, dtype=torch.int32)
    t1 = top[:, 4:].sum(-1, dtype=torch.int32)
    l0 = left[:, :4].sum(-1, dtype=torch.int32)
    l1 = left[:, 4:].sum(-1, dtype=torch.int32)

    def dc_both(t, l):
        return torch.where(availT & availL, (t + l + 4) >> 3,
                           torch.where(availT, (t + 2) >> 2,
                                       torch.where(availL, (l + 2) >> 2,
                                                   128)))

    def dc_prefer(pref, alt, avail_pref, avail_alt):
        return torch.where(avail_pref, (pref + 2) >> 2,
                           torch.where(avail_alt, (alt + 2) >> 2, 128))

    q00 = dc_both(t0, l0)
    q11 = dc_both(t1, l1)
    q10 = dc_prefer(t1, l0, availT, availL)   # top-right quad: prefer top
    q01 = dc_prefer(l1, t0, availL, availT)   # bottom-left: prefer left
    out = top.new_zeros(n, 8, 8)
    out[:, :4, :4] = q00[:, None, None]
    out[:, :4, 4:] = q10[:, None, None]
    out[:, 4:, :4] = q01[:, None, None]
    out[:, 4:, 4:] = q11[:, None, None]
    return out


def _i16_dc_pred(top, left, availT, availL):
    ts = top.sum(-1, dtype=torch.int32)
    ls = left.sum(-1, dtype=torch.int32)
    dc = torch.where(availT & availL, (ts + ls + 16) >> 5,
                     torch.where(availT, (ts + 8) >> 4,
                                 torch.where(availL, (ls + 8) >> 4, 128)))
    return dc[:, None, None].expand(top.shape[0], 16, 16)


def _select(sel, cands):
    """Per-slot choice among mode candidates (n, S, S) by sel (n,)."""
    out = cands[-1]
    s = sel[:, None, None]
    for m in range(len(cands) - 2, -1, -1):
        out = torch.where(s == m, cands[m], out)
    return out


def encode_i_frame_core_wf(src_y, src_u, src_v, qp: int, qpc: int,
                           i4x4: bool = False):
    """I-frame encode with full I16 + chroma mode decision.

    Returns the syntax-tensor dict plus 'i16_mode' (n,) in
    {0=V,1=H,2=DC,3=Plane} and 'cmode' (n,) in {0=DC,1=H,2=V,3=Plane}
    (§7.4.5 numbering for both), and the recon planes.  With i4x4 also
    'use_i4' (n,) bool, 'i4_modes', 'i4_prev', 'i4_rem' (n, 16) and,
    zeroed where an MB keeps I16, 'levels4' (n, 16, 16) and 'cbp_luma4'
    (n,)."""
    from .device import (mbize, unmbize, _luma_residual_pipeline_i16,
                         _finish_intra_mb)
    from .intra4x4 import encode_i4x4_batch
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    slope = 2 if i4x4 else 1
    steps = slope * (mbh - 1) + mbw
    dev = src_y.device

    sy = skew(mbize(src_y).reshape(mbh, mbw, 16, 16), steps, slope)
    su = skew(mbize(src_u, 8).reshape(mbh, mbw, 8, 8), steps, slope)
    sv = skew(mbize(src_v, 8).reshape(mbh, mbw, 8, 8), steps, slope)

    ys_idx = torch.arange(mbh, dtype=torch.int32, device=dev)
    lam = satd_lambda(qp)

    def shift_down(a):
        """slot y -> value from slot y-1 (slot 0 gets zeros)."""
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]])

    z16 = torch.zeros(mbh, 16, dtype=torch.int32, device=dev)
    z8 = torch.zeros(mbh, 8, dtype=torch.int32, device=dev)
    # bots_*[k] = bottom rows emitted at step d-1-k; the I4x4 border
    # modes: mbots[k] emitted at step d-1-k, mright at step d-1
    bots_y, right_y = (z16,) * (slope + 1), z16
    bots_u, right_u = (z8,) * (slope + 1), z8
    bots_v, right_v = (z8,) * (slope + 1), z8
    zm = torch.full((mbh, 4), 2, dtype=torch.int32, device=dev)
    mbots, mright = (zm, zm), zm
    outs = []
    for d in range(steps):
        smb_y, smb_u, smb_v = sy[d], su[d], sv[d]
        x = d - slope * ys_idx                          # (mbh,)
        availT = ys_idx >= 1                            # top nbr (y-1, x)
        availL = x >= 1                                 # left nbr (y, x-1)
        availTL = availT & availL

        top_y = shift_down(bots_y[slope - 1])           # (mbh, 16)
        tl_y = shift_down(bots_y[slope])[:, 15]         # corner pixel
        left_y = right_y
        # ---- luma I16 mode decision ----
        pV = top_y[:, None, :].expand(mbh, 16, 16)
        pH = left_y[:, :, None].expand(mbh, 16, 16)
        pDC = _i16_dc_pred(top_y, left_y, availT, availL)
        pPL = _plane_pred(top_y, left_y, tl_y, 16)
        costs = torch.stack([
            torch.where(availT, _satd_mb(smb_y, pV), BIG),
            torch.where(availL, _satd_mb(smb_y, pH), BIG),
            _satd_mb(smb_y, pDC),
            torch.where(availTL, _satd_mb(smb_y, pPL), BIG)])
        i16_mode = torch.argmin(costs, dim=0).to(torch.int32)
        pred_y = _select(i16_mode, (pV, pH, pDC, pPL))

        # ---- chroma mode decision (joint over U+V) ----
        top_u = shift_down(bots_u[slope - 1])
        tl_u = shift_down(bots_u[slope])[:, 7]
        left_u = right_u
        top_v = shift_down(bots_v[slope - 1])
        tl_v = shift_down(bots_v[slope])[:, 7]
        left_v = right_v
        cand_u = (_chroma_dc_pred(top_u, left_u, availT, availL),
                  left_u[:, :, None].expand(mbh, 8, 8),
                  top_u[:, None, :].expand(mbh, 8, 8),
                  _plane_pred(top_u, left_u, tl_u, 8))
        cand_v = (_chroma_dc_pred(top_v, left_v, availT, availL),
                  left_v[:, :, None].expand(mbh, 8, 8),
                  top_v[:, None, :].expand(mbh, 8, 8),
                  _plane_pred(top_v, left_v, tl_v, 8))
        avail_c = (torch.ones_like(availT), availL, availT, availTL)
        ue_bits = (1, 3, 3, 5)                          # ue(cmode) lengths
        ccosts = torch.stack([
            torch.where(av, _satd_mb(smb_u, cu) + _satd_mb(smb_v, cv)
                        + lam * (nb - 1), BIG)
            for cu, cv, av, nb in zip(cand_u, cand_v, avail_c, ue_bits)])
        cmode = torch.argmin(ccosts, dim=0).to(torch.int32)
        pred_u = _select(cmode, cand_u)
        pred_v = _select(cmode, cand_v)

        levels, res = _luma_residual_pipeline_i16(smb_y, pred_y, qp)
        out = _finish_intra_mb(smb_y, pred_y, levels, res,
                               smb_u, pred_u, smb_v, pred_v, qp, qpc)
        out["i16_mode"] = i16_mode
        out["cmode"] = cmode

        if i4x4:
            availTR = availT & (x + 1 < mbw) & (x + 1 > 0)
            tr4 = shift_down(bots_y[0])[:, :4]          # (y-1, x+1) bottom
            i4 = encode_i4x4_batch(
                smb_y, top_y, tr4, left_y, tl_y, shift_down(mbots[1]),
                mright, availT, availL, availTR, qp, lam)
            # MB type: total SATD + lambda * signalling bits (I16 ~ 9 bits
            # of ue(mb_type); I_NxN ue(0) = 1 bit + ~6 of coded_block_pattern)
            use_i4 = i4["cost"] + lam * 7 < costs.amin(dim=0) + lam * 9
            u3 = use_i4[:, None, None]
            out["recon_y"] = torch.where(u3, i4["recon"], out["recon_y"])
            out["use_i4"] = use_i4
            out["i4_modes"] = i4["modes"]
            out["i4_prev"] = i4["prev"]
            out["i4_rem"] = i4["rem"]
            out["levels4"] = i4["levels"] * u3
            out["cbp_luma4"] = i4["cbp_luma"] * use_i4
            mbots = (torch.where(use_i4[:, None], i4["bot_modes"], 2),
                     mbots[0])
            mright = torch.where(use_i4[:, None], i4["right_modes"], 2)
        outs.append(out)

        bots_y = (out["recon_y"][:, -1, :],) + bots_y[:-1]
        right_y = out["recon_y"][:, :, -1]
        bots_u = (out["recon_u"][:, -1, :],) + bots_u[:-1]
        right_u = out["recon_u"][:, :, -1]
        bots_v = (out["recon_v"][:, -1, :],) + bots_v[:-1]
        right_v = out["recon_v"][:, :, -1]

    # unskew every output back to MB raster order
    res = {}
    for k in outs[0]:
        st = torch.stack([o[k] for o in outs])          # (steps, mbh, ...)
        res[k] = unskew(st, mbw, slope).reshape((mbh * mbw,) + st.shape[2:])
    res["recon_y"] = unmbize(res["recon_y"], H, W)
    res["recon_u"] = unmbize(res["recon_u"], H // 2, W // 2, 8)
    res["recon_v"] = unmbize(res["recon_v"], H // 2, W // 2, 8)
    return res
