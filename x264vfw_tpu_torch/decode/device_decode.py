"""The decoder's device route: one picture reconstructed from parsed syntax.

Port of x264vfw_tpu/decode/device_decode.py, the decode hot path of
BASELINE config 4 (the reference's decode loop, codec.c:2154-2296, which
delegates the per-MB work to FFmpeg).  The serial entropy stage runs on
the host in C (csrc/host/cavlc_parse.c through bitstream/native_parse.py)
and emits resolved syntax arrays: per-MB kinds, modes, cbp and QP,
per-block zigzag levels, and the per-4x4 motion field with the motion
vector prediction applied.  decode_frame_core turns one picture's syntax,
uploaded to the decoder's device, into its planes:

  A. residual: dequantisation and inverse transform of every coded block,
     all MBs at once (I16 DC Hadamard, chroma DC, 4x4 AC);
  B. inter prediction: quarter-pel luma MC from the half-pel planes and
     eighth-pel bilinear chroma MC, per 4x4 block, by gathers from the
     stack of the references' prepared planes (cached on each Frame);
  C. intra reconstruction on the anti-diagonal wavefront: an intra MB
     reads only its left, top, top-left and top-right neighbours, so the
     MBs on one diagonal d = 2*my + mx are independent, and the diagonals
     in turn give the raster order's result.  Inside a step the I4x4
     blocks run as the 10 block diagonals 2*by + bx;
  D. the loop filter: edge maps from the same syntax (ops/deblock.
     build_maps, the encoder's maps) and ops/kernels/deblock.deblock_apply
     (the sm_90a kernel on a CUDA tensor, its plain version on the CPU).

Departures from the JAX module, each giving the same planes (ROADMAP C):
the JAX package's masked static-shift MC, its intra-MB buckets and its
int8 syntax upload are TPU workarounds and are not ported (gathers are
cheap on the card); its sequential loop over the intra MBs in raster order
is the wavefront of stage C; and its batching of small pictures into one
dispatch (decode_gop_core) is not ported: every eligible picture runs
through decode_frame_core.  Which slices take this route is the JAX
package's rule, parse_slice_syntax, unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import native_parse
from ..encode.device import _edge_pad, _halfpel_planes, _per_pixel, \
    _qpel_operands
from ..encode.intra4x4 import BLK_X, BLK_Y, _DIR_MODES, _IDX, _TRCODE
from ..ops import transform as tj
from ..ops.deblock import build_maps
from ..ops.kernels import deblock as dbk

PAD = 24     # luma reference padding (replication exact for any |mv|: far
             # coords clamp into the constant replicated band, see _mc_luma)
PADC = 16    # chroma reference padding

# quarter-frac (fy*4+fx) -> two (plane, ox, oy) MC operands
_QP1 = np.zeros((16, 3), np.int64)
_QP2 = np.zeros((16, 3), np.int64)
for _fy in range(4):
    for _fx in range(4):
        _QP1[_fy * 4 + _fx], _QP2[_fy * 4 + _fx] = _qpel_operands(_fx, _fy)

# decode-order block index -> raster position tables
_BX4 = np.asarray(BLK_X, np.int64) * 4
_BY4 = np.asarray(BLK_Y, np.int64) * 4
# raster 4x4 position -> decode-order index
_DEC_IDX = np.zeros(16, np.int64)
_DEC_IDX[np.asarray(BLK_Y) * 4 + np.asarray(BLK_X)] = np.arange(16)
# intra mode id -> row of the directional index table (_IDX); DC gated apart
_MODE2DIR = np.zeros(9, np.int64)
for _d, _m in enumerate(_DIR_MODES):
    _MODE2DIR[_m] = _d
# I4x4 block diagonals 2*by + bx (0..9): the decode-order blocks of each
_I4_DIAGS = [np.flatnonzero(2 * BLK_Y + BLK_X == s) for s in range(10)]

# the syntax arrays decode_frame_core reads
SYNTAX_KEYS = ("mb_kind", "qp_map", "i16mode", "cmode", "i4modes", "dc16",
               "ac15", "lvl16", "cdc", "cac", "mv4", "ref4")


_I32 = torch.int32


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def prep_ref_planes(y, u, v):
    """Padded MC planes of one reference picture (int32 planes on the
    decoder's device).

    Returns (luma (4, Hp, Wp) int16: the integer, b, h and j quarter-pel
    operand planes; u_pad, v_pad int16).  Valid luma gather coords:
    [3, dim-4] (the half-pel planes' edges hold wrapped taps); chroma:
    [0, dim-2]."""
    yp = _edge_pad(y.to(torch.int32), PAD)
    b, h, j = _halfpel_planes(yp)
    luma = torch.stack([yp, b, h, j]).to(torch.int16)
    return (luma, _edge_pad(u, PADC).to(torch.int16),
            _edge_pad(v, PADC).to(torch.int16))


def ref_planes(frame, device):
    """A reference Frame's prepared planes, made once and kept on it (from
    its device planes when the device route decoded it, else uploaded)."""
    if getattr(frame, "_dev_ref", None) is None:
        planes = getattr(frame, "_dev_planes", None)
        if planes is None:
            planes = tuple(_t(np.asarray(p, np.int32), device)
                           for p in (frame.y, frame.u, frame.v))
        frame._dev_ref = prep_ref_planes(*planes)
        frame._dev_planes = None
    return frame._dev_ref


# ---------------------------------------------------------------- residual
def _luma_residual(mb_kind, qp_map, dc16, ac15, lvl16):
    """(n, 16, 4, 4) spatial luma residual per decode-order block."""
    n = mb_kind.shape[0]
    dev = mb_kind.device
    i16 = mb_kind == 5
    # I16 blocks: a zero DC slot before the 15 AC levels, then the DC
    # from the Hadamard; other blocks: the 16 levels
    ac16 = torch.cat([torch.zeros(n, 16, 1, dtype=ac15.dtype, device=dev),
                      ac15], dim=-1)
    lv = torch.where(i16[:, None, None], ac16, lvl16)
    d = tj.dequant4x4(tj.zigzag_unscan(lv.reshape(n * 16, 16)),
                      qp_map.repeat_interleave(16)).reshape(n, 16, 4, 4)
    dc_vals = tj.luma_dc_dequant(tj.zigzag_unscan(dc16.to(torch.int32)),
                                 qp_map)                        # (n, 4, 4)
    dc_blk = dc_vals[:, _t(_BY4 // 4, dev), _t(_BX4 // 4, dev)]  # (n, 16)
    d[:, :, 0, 0] = torch.where(i16[:, None], dc_blk, d[:, :, 0, 0])
    return tj.idct4x4_core(d.reshape(n * 16, 4, 4)).reshape(n, 16, 4, 4)


def _chroma_residual(qpc_map, cdc, cac):
    """(n, 2, 4, 4, 4) spatial chroma residual per plane / raster sub-blk."""
    n = qpc_map.shape[0]
    dev = qpc_map.device
    dc_vals = tj.chroma_dc_dequant(
        cdc.reshape(n * 2, 2, 2), qpc_map.repeat_interleave(2)) \
        .reshape(n, 2, 4)
    ac = torch.cat([torch.zeros(n, 2, 4, 1, dtype=cac.dtype, device=dev),
                    cac], dim=-1)
    d = tj.dequant4x4(tj.zigzag_unscan(ac.reshape(n * 8, 16)),
                      qpc_map.repeat_interleave(8)).reshape(n, 2, 4, 4, 4)
    d[:, :, :, 0, 0] = dc_vals
    return tj.idct4x4_core(d.reshape(n * 8, 4, 4)).reshape(n, 2, 4, 4, 4)


def _blocks_to_plane(res, mbh, mbw):
    """(n, 16, 4, 4) decode-order blocks -> (16mbh, 16mbw) plane."""
    raster = res[:, _t(_DEC_IDX, res.device)]
    t = raster.reshape(mbh, mbw, 4, 4, 4, 4)  # (MY, MX, by, bx, py, px)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(16 * mbh, 16 * mbw)


def _cblocks_to_plane(res_c, mbh, mbw):
    """(n, 4, 4, 4) raster sub-blocks -> (8mbh, 8mbw) plane."""
    t = res_c.reshape(mbh, mbw, 2, 2, 4, 4)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(8 * mbh, 8 * mbw)


# ------------------------------------------------------------------- inter
def _mc_luma(luma_planes, mv_grid, ref_grid, mbh, mbw):
    """Quarter-pel luma prediction plane via 2-sample gathers.

    luma_planes (R, 4, Hp, Wp) int16; mv_grid (4mbh, 4mbw, 2) quarter-pel;
    ref_grid (4mbh, 4mbw) (intra = -1, values unused there)."""
    R, _, Hp, Wp = luma_planes.shape
    dev = luma_planes.device
    gh, gw = 16 * mbh, 16 * mbw
    mvp = _per_pixel(mv_grid.to(torch.int64), 4)
    # int64 before the plane-index arithmetic: the parser hands ref4 over
    # as int8, and `refp * Hp` must not wrap (it did at ref_idx 2 in the
    # JAX package's round 3)
    refp = _per_pixel(ref_grid.to(torch.int64), 4).clamp(min=0)
    mvi = mvp >> 2
    fid = (mvp[..., 1] & 3) * 4 + (mvp[..., 0] & 3)
    yy = torch.arange(gh, device=dev)[:, None] + mvi[..., 1] + PAD
    xx = torch.arange(gw, device=dev)[None, :] + mvi[..., 0] + PAD
    flat = luma_planes.reshape(-1)

    def sample(optab):
        op = _t(optab, dev)[fid]                            # (gh, gw, 3)
        cy = (yy + op[..., 2]).clamp(3, Hp - 4)
        cx = (xx + op[..., 1]).clamp(3, Wp - 4)
        idx = ((refp * 4 + op[..., 0]) * Hp + cy) * Wp + cx
        return flat[idx].to(torch.int32)

    return (sample(_QP1) + sample(_QP2) + 1) >> 1


def _mc_chroma(ref_c, mv_grid, ref_grid, mbh, mbw):
    """Eighth-pel bilinear chroma prediction plane (§8.4.2.2.2).

    ref_c (R, Hcp, Wcp) int16; motion per luma 4x4 block = chroma 2x2."""
    R, Hcp, Wcp = ref_c.shape
    dev = ref_c.device
    ch, cw = 8 * mbh, 8 * mbw
    mvp = _per_pixel(mv_grid.to(torch.int64), 2)
    # int64 before `refp * Hcp`: see _mc_luma
    refp = _per_pixel(ref_grid.to(torch.int64), 2).clamp(min=0)
    dx = (mvp[..., 0] & 7).to(torch.int32)
    dy = (mvp[..., 1] & 7).to(torch.int32)
    cy = (torch.arange(ch, device=dev)[:, None] + (mvp[..., 1] >> 3)
          + PADC).clamp(0, Hcp - 2)
    cx = (torch.arange(cw, device=dev)[None, :] + (mvp[..., 0] >> 3)
          + PADC).clamp(0, Wcp - 2)
    flat = ref_c.reshape(-1)
    base = (refp * Hcp + cy) * Wcp + cx
    A, B, C, D = (flat[base + o].to(torch.int32)
                  for o in (0, 1, Wcp, Wcp + 1))
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
            + (8 - dx) * dy * C + dx * dy * D + 32) >> 6


# ------------------------------------------------------------------- intra
def _dc3(aT, aL, sT, sL, both_sh: int, one_sh: int):
    """DC predictor from the top/left sums and their availability."""
    return torch.where(
        aT & aL, (sT + sL + (1 << (both_sh - 1))) >> both_sh,
        torch.where(aT, (sT + (1 << (one_sh - 1))) >> one_sh,
                    torch.where(aL, (sL + (1 << (one_sh - 1))) >> one_sh,
                                torch.full_like(sT, 128))))


def _plane_pred(top, left, tl, size: int, mul: int, sh: int):
    """(B, size, size) plane predictor (§8.3.3.4, §8.3.4.4)."""
    dev = top.device
    h = size // 2
    xs = torch.arange(h, dtype=torch.int32, device=dev)
    t_ext = torch.cat([tl[:, None], top], dim=1)       # p[x, -1], x=-1..
    l_ext = torch.cat([tl[:, None], left], dim=1)
    Hc = ((xs + 1) * (t_ext[:, h + 1 + xs] - t_ext[:, h - 1 - xs])) \
        .sum(1, dtype=_I32)
    Vc = ((xs + 1) * (l_ext[:, h + 1 + xs] - l_ext[:, h - 1 - xs])) \
        .sum(1, dtype=_I32)
    a = 16 * (left[:, -1] + top[:, -1])
    b = (mul * Hc + (1 << (sh - 1))) >> sh
    c = (mul * Vc + (1 << (sh - 1))) >> sh
    r = torch.arange(size, dtype=torch.int32, device=dev) - (h - 1)
    P = (a[:, None, None] + b[:, None, None] * r[None, None, :]
         + c[:, None, None] * r[None, :, None] + 16) >> 5
    return P.clamp(0, 255)


def _i16_pred(top, left, tl, mode, availT, availL):
    """(B, 16, 16) Intra_16x16 prediction; top/left (B, 16), tl (B,)."""
    V = top[:, None, :].expand(-1, 16, 16)
    H = left[:, :, None].expand(-1, 16, 16)
    dc = _dc3(availT, availL, top.sum(1, dtype=_I32),
              left.sum(1, dtype=_I32), 5, 4)
    P = _plane_pred(top, left, tl, 16, 5, 6)
    m = mode[:, None, None]
    return torch.where(m == 0, V, torch.where(
        m == 1, H, torch.where(m == 2, dc[:, None, None], P)))


def _chroma8_pred(top, left, tl, mode, availT, availL):
    """(B, 8, 8) intra chroma prediction; modes 0=DC 1=H 2=V 3=Plane
    (§8.3.4).  top/left (B, 8), tl (B,), mode/availT/availL (B,)."""
    H = left[:, :, None].expand(-1, 8, 8)
    V = top[:, None, :].expand(-1, 8, 8)
    tq = top.reshape(-1, 2, 4).sum(2, dtype=_I32)       # (B, 2) qx
    lq = left.reshape(-1, 2, 4).sum(2, dtype=_I32)      # (B, 2) qy
    aT, aL = availT, availL
    c128 = torch.full_like(tq[:, 0], 128)
    dc00 = _dc3(aT, aL, tq[:, 0], lq[:, 0], 3, 2)
    dc11 = _dc3(aT, aL, tq[:, 1], lq[:, 1], 3, 2)
    # the top-right quadrant prefers the top, the bottom-left the left
    dc01 = torch.where(aT, (tq[:, 1] + 2) >> 2,
                       torch.where(aL, (lq[:, 0] + 2) >> 2, c128))
    dc10 = torch.where(aL, (lq[:, 1] + 2) >> 2,
                       torch.where(aT, (tq[:, 0] + 2) >> 2, c128))
    DC = torch.stack([torch.stack([dc00, dc01], 1),
                      torch.stack([dc10, dc11], 1)], 1)   # (B, 2, 2)
    DC = DC.repeat_interleave(4, 1).repeat_interleave(4, 2)
    P = _plane_pred(top, left, tl, 8, 17, 5)
    m = mode[:, None, None]
    return torch.where(m == 0, DC, torch.where(
        m == 1, H, torch.where(m == 2, V, P)))


class _Wavefront:
    """Stage C: the intra MBs of one picture in anti-diagonal steps.

    The luma canvas is the picture with a zero row above, a zero column to
    its left and 8 zero columns to its right (the I4x4 top-right reads of
    the last MB column); the chroma canvas holds U and V with a zero row
    and column.  Every per-MB index is made once per picture, sorted by
    diagonal, so a step takes slices of it."""

    def __init__(self, y, u, v, res_y, res_u, res_v, kinds, syn, mbh, mbw):
        dev = y.device
        self.mbh, self.mbw = mbh, mbw
        gh, gw = 16 * mbh, 16 * mbw
        ch, cw = 8 * mbh, 8 * mbw
        self.W1, self.Wc1 = 1 + gw + 8, 1 + cw
        self.yc = torch.zeros(1 + gh, self.W1, dtype=torch.int32, device=dev)
        self.yc[1:1 + gh, 1:1 + gw] = y
        self.cc = torch.zeros(2, 1 + ch, self.Wc1, dtype=torch.int32,
                              device=dev)
        self.cc[0, 1:, 1:] = u
        self.cc[1, 1:, 1:] = v
        # intra MBs sorted by diagonal (raster order inside one)
        k = np.flatnonzero(kinds >= 5)
        my, mx = k // mbw, k % mbw
        order = np.argsort(2 * my + mx, kind="stable")
        k, my, mx = k[order], my[order], mx[order]
        diag = 2 * my + mx
        cuts = np.flatnonzero(np.diff(diag)) + 1
        self.steps = [(int(s), int(e)) for s, e in
                      zip(np.r_[0, cuts], np.r_[cuts, k.size])]
        ksort = kinds[k]
        self.has_i16 = [bool((ksort[s:e] == 5).any()) for s, e in self.steps]
        self.has_i4 = [bool((ksort[s:e] == 6).any()) for s, e in self.steps]
        kt = _t(k, dev)
        myt, mxt = _t(my, dev), _t(mx, dev)
        self.availT, self.availL = myt > 0, mxt > 0
        self.availTL = self.availT & self.availL
        self.availTR = self.availT & (mxt < mbw - 1)
        # trc codes 0..3 -> where a block's top-right samples are usable
        self.tr_tab = torch.stack(
            [self.availT, self.availTR, torch.ones_like(self.availT),
             torch.zeros_like(self.availT)], dim=1)
        self.i16 = _t(ksort == 5, dev)
        self.i16mode = syn["i16mode"][kt].to(torch.int64)
        self.cmode = syn["cmode"][kt].to(torch.int64)
        self.i4modes = syn["i4modes"][kt].to(torch.int64)
        # flat canvas offsets of each MB's (17, 25) luma context and (9, 9)
        # chroma context (both planes), and of its interior
        def ar(m):
            return torch.arange(m, device=dev)

        base = (16 * myt) * self.W1 + 16 * mxt
        self.lctx = base[:, None, None] + (ar(17)[:, None] * self.W1
                                           + ar(25))[None]
        self.lin = (base + self.W1 + 1)[:, None, None] + (
            ar(16)[:, None] * self.W1 + ar(16))[None]
        cplane = ar(2)[:, None, None] * (1 + ch) * self.Wc1
        cbase = (8 * myt) * self.Wc1 + 8 * mxt
        self.cctx = cbase[:, None, None, None] + (
            cplane + ar(9)[:, None] * self.Wc1 + ar(9))[None]
        self.cin = (cbase + self.Wc1 + 1)[:, None, None, None] + (
            cplane + ar(8)[:, None] * self.Wc1 + ar(8))[None]
        # each intra MB's residual
        self.res_y = res_y.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3) \
            .reshape(mbh * mbw, 16, 16)[kt]
        res_c = torch.stack([res_u, res_v]).reshape(2, mbh, 8, mbw, 8) \
            .permute(1, 3, 0, 2, 4).reshape(mbh * mbw, 2, 8, 8)
        self.res_c = res_c[kt]
        # per block diagonal: each block's (5, 9) context and (4, 4)
        # interior in the (17, 25) MB canvas, its residual in the MB's
        # (16, 16), and constants
        self.blk = []
        for blocks in _I4_DIAGS:
            bx, by = _BX4[blocks], _BY4[blocks]
            ctx = (by[:, None, None] + np.arange(5)[:, None]) * 25 \
                + bx[:, None, None] + np.arange(9)
            win = (by[:, None, None] + 1 + np.arange(4)[:, None]) * 25 \
                + bx[:, None, None] + 1 + np.arange(4)
            rin = (by[:, None, None] + np.arange(4)[:, None]) * 16 \
                + bx[:, None, None] + np.arange(4)
            self.blk.append((
                _t(blocks, dev), _t(ctx.reshape(-1), dev),
                _t(win.reshape(-1), dev), _t(rin.reshape(-1), dev),
                _t(np.asarray(_TRCODE)[blocks], dev),
                _t(by > 0, dev), _t(bx > 0, dev), len(blocks)))
        self.idx_tab = _t(_IDX, dev)                    # (8, 16, 3)
        self.m2d = _t(_MODE2DIR, dev)

    def run(self):
        for i, (s, e) in enumerate(self.steps):
            self._step(s, e, self.has_i16[i], self.has_i4[i])
        gh, gw = 16 * self.mbh, 16 * self.mbw
        return (self.yc[1:1 + gh, 1:1 + gw], self.cc[0, 1:, 1:],
                self.cc[1, 1:, 1:])

    def _step(self, s: int, e: int, has_i16: bool, has_i4: bool):
        aT, aL, aTL = self.availT[s:e], self.availL[s:e], self.availTL[s:e]
        yflat = self.yc.view(-1)
        Lctx = yflat[self.lctx[s:e]]                    # (B, 17, 25)
        res = self.res_y[s:e]
        zero = torch.zeros((), dtype=torch.int32, device=Lctx.device)
        rec = None
        if has_i16:
            top16 = torch.where(aT[:, None], Lctx[:, 0, 1:17], zero)
            left16 = torch.where(aL[:, None], Lctx[:, 1:17, 0], zero)
            tl = torch.where(aTL, Lctx[:, 0, 0], zero)
            rec = (_i16_pred(top16, left16, tl, self.i16mode[s:e], aT, aL)
                   + res).clamp(0, 255)
        if has_i4:
            rec4 = self._i4_chain(Lctx, res, s, e)
            rec = rec4 if rec is None else torch.where(
                self.i16[s:e, None, None], rec, rec4)
        yflat[self.lin[s:e]] = rec
        # chroma, both planes at once
        cflat = self.cc.view(-1)
        C = cflat[self.cctx[s:e]]                       # (B, 2, 9, 9)
        B = C.shape[0]
        topc = torch.where(aT[:, None, None], C[:, :, 0, 1:9], zero)
        leftc = torch.where(aL[:, None, None], C[:, :, 1:9, 0], zero)
        tlc = torch.where(aTL[:, None], C[:, :, 0, 0], zero)
        pred = _chroma8_pred(
            topc.reshape(2 * B, 8), leftc.reshape(2 * B, 8),
            tlc.reshape(2 * B), self.cmode[s:e].repeat_interleave(2),
            aT.repeat_interleave(2), aL.repeat_interleave(2)) \
            .reshape(B, 2, 8, 8)
        cflat[self.cin[s:e]] = (pred + self.res_c[s:e]).clamp(0, 255)

    def _i4_chain(self, Lctx, res, s: int, e: int):
        """The I4x4 decode chain of the step's MBs on their (17, 25) canvases
        (row 0 the row above the MB from x0-1 to x0+23, column 0 the left
        column, the interior filled block diagonal by block diagonal).
        Returns the (B, 16, 16) reconstructions."""
        B = Lctx.shape[0]
        L = Lctx.clone()
        L[:, 1:, 1:] = 0
        L = L.reshape(B, 17 * 25)
        resf = res.reshape(B, 256)
        modes = self.i4modes[s:e]
        aT, aL = self.availT[s:e], self.availL[s:e]
        tr_tab = self.tr_tab[s:e]
        for blocks, ctx_i, win_i, rin_i, trc, ygt0, xgt0, nb in self.blk:
            ctx = L[:, ctx_i].reshape(B, nb, 5, 9)
            tl = ctx[:, :, 0, 0]
            trow = ctx[:, :, 0, 1:9]                    # t0..t7
            lcol = ctx[:, :, 1:5, 0]
            tr_ok = tr_tab[:, trc]                      # (B, nb)
            t47 = torch.where(tr_ok[..., None], trow[..., 4:8],
                              trow[..., 3:4])
            w = torch.cat([tl[..., None], trow[..., :4], t47, lcol], -1)
            mode = modes[:, blocks]                     # (B, nb)
            tab = self.idx_tab[self.m2d[mode]]          # (B, nb, 16, 3)
            ws = torch.gather(w, 2, tab.reshape(B, nb, 48)) \
                .reshape(B, nb, 16, 3)
            pdir = (ws[..., 0] + 2 * ws[..., 1] + ws[..., 2] + 2) >> 2
            dc = _dc3(aT[:, None] | ygt0, aL[:, None] | xgt0,
                      trow[..., :4].sum(-1, dtype=_I32),
                      lcol.sum(-1, dtype=_I32), 3, 2)
            pred = torch.where(mode[..., None] == 2, dc[..., None], pdir)
            rec = (pred.reshape(B, nb * 16) + resf[:, rin_i]).clamp(0, 255)
            L[:, win_i] = rec
        return L.reshape(B, 17, 25)[:, 1:17, 1:17]


# -------------------------------------------------------------- frame core
def decode_frame_core(syn, kinds, luma_planes, refs_u, refs_v, *,
                      mbh: int, mbw: int, cqpo: int, offA: int, offB: int,
                      deblock: bool):
    """One picture's reconstruction from parsed syntax.

    syn: the parser's arrays (SYNTAX_KEYS) as tensors on the decoder's
    device; kinds: the host copy of syn["mb_kind"], which schedules stage
    C; luma_planes (R, 4, Hp, Wp), refs_u/refs_v (R, Hcp, Wcp): the
    references' prepared planes (prep_ref_planes) stacked, or None for an
    I slice.  Returns (y, u, v) int32 planes at (16mbh, 16mbw)."""
    n = mbh * mbw
    qp_map = syn["qp_map"].to(torch.int32)
    mb_kind = syn["mb_kind"]
    qpc_map = tj.chroma_qp(qp_map, cqpo)

    # ---- stage A: residual planes ----
    res_y = _blocks_to_plane(_luma_residual(
        mb_kind, qp_map, syn["dc16"], syn["ac15"], syn["lvl16"]), mbh, mbw)
    res_c = _chroma_residual(qpc_map, syn["cdc"].reshape(n, 2, 2, 2),
                             syn["cac"])
    res_u = _cblocks_to_plane(res_c[:, 0], mbh, mbw)
    res_v = _cblocks_to_plane(res_c[:, 1], mbh, mbw)

    # ---- stage B: inter prediction + recon ----
    mv_grid = syn["mv4"].reshape(mbh, mbw, 4, 4, 2).permute(0, 2, 1, 3, 4) \
        .reshape(4 * mbh, 4 * mbw, 2)
    ref_grid = syn["ref4"].reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3) \
        .reshape(4 * mbh, 4 * mbw)
    if luma_planes is None:
        y, u, v = (r.clamp(0, 255) for r in (res_y, res_u, res_v))
    else:
        y = (_mc_luma(luma_planes, mv_grid, ref_grid, mbh, mbw)
             + res_y).clamp(0, 255)
        u = (_mc_chroma(refs_u, mv_grid, ref_grid, mbh, mbw)
             + res_u).clamp(0, 255)
        v = (_mc_chroma(refs_v, mv_grid, ref_grid, mbh, mbw)
             + res_v).clamp(0, 255)

    # ---- stage C: intra MBs on the anti-diagonal wavefront ----
    if (kinds >= 5).any():
        y, u, v = _Wavefront(y, u, v, res_y, res_u, res_v, kinds, syn,
                             mbh, mbw).run()

    # ---- stage D: deblock ----
    if deblock:
        intra_mb = (mb_kind >= 5).reshape(mbh, mbw)
        # per-4x4 total_coeff: AC levels for I16, 16-coeff levels otherwise
        # (intra edges take bS 3/4 regardless; inter blocks use lvl16)
        tc_blk = torch.where((mb_kind == 5)[:, None],
                             (syn["ac15"] != 0).sum(-1),
                             (syn["lvl16"] != 0).sum(-1))   # (n, 16) dec order
        tc4 = tc_blk[:, _t(_DEC_IDX, tc_blk.device)] \
            .reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3) \
            .reshape(4 * mbh, 4 * mbw).to(torch.int32)
        maps = build_maps(intra_mb, tc4, mv_grid.to(torch.int32),
                          ref_grid.to(torch.int32), qp_map.reshape(mbh, mbw),
                          offA, offB, cqpo)
        y, u, v = dbk.deblock_apply(y.contiguous(), u.contiguous(),
                                    v.contiguous(),
                                    *(m.contiguous() for m in maps))
    return y, u, v


# --------------------------------------------------------------- host glue
def upload_syntax(syn: dict, device) -> dict:
    """The arrays decode_frame_core reads, on `device`."""
    return {k: _t(syn[k], device) for k in SYNTAX_KEYS}


def pull_planes(y, u, v):
    """Device planes -> host int32 arrays (moved as bytes)."""
    return tuple(p.to(torch.uint8).cpu().numpy().astype(np.int32)
                 for p in (y, u, v))


def try_decode_slice(top, rbsp, bitpos, sps, pps, h, nal_type):
    """The device route for one slice.  Returns a Frame, or None when
    parse_slice_syntax refuses the slice (the caller decodes it on the
    host route).  `top` is the H264Decoder; the references' prepared
    planes are cached on their Frames.

    Decode-session role of the reference: codec.c:2223-2238 (send/receive
    via FFmpeg); here the host parses the entropy coding in C and the
    device does the reconstruction."""
    p = parse_slice_syntax(top, rbsp, bitpos, sps, pps, h, nal_type,
                           len(top.dpb))
    if p is None:
        return None
    syn = p["syn"]
    dev = top.device
    mbh, mbw = sps.mb_height, sps.mb_width
    refs = list(top.dpb[:p["nref"]]) if h.is_p() else []
    luma = ru = rv = None
    if refs:
        planes = [ref_planes(f, dev) for f in refs]
        luma, ru, rv = (torch.stack([q[i] for q in planes]) for i in range(3))
    y, u, v = decode_frame_core(
        upload_syntax(syn, dev), syn["mb_kind"], luma, ru, rv, mbh=mbh,
        mbw=mbw, cqpo=pps.chroma_qp_index_offset, offA=p["offA"],
        offB=p["offB"], deblock=p["deblock"])
    fr = _syntax_frame(syn, mbh, mbw, h, nal_type, refs)
    fr.y, fr.u, fr.v = pull_planes(y, u, v)
    fr._dev_planes = (y, u, v)
    return fr


def parse_slice_syntax(top, rbsp, bitpos, sps, pps, h, nal_type,
                       dpb_depth: int):
    """Phase 1 of the device route: the JAX package's eligibility checks,
    then the C entropy parse.  Returns a dict (syntax + metadata), or None
    for a slice the route does not take: CABAC, B, a slice that does not
    start the picture or does not cover it, constrained intra, explicit
    weights, list modification or MMCO, a DPB shallower than the active
    references, 8x8-transformed MBs, I_PCM.  A parser that cannot be built
    raises."""
    if pps.entropy_coding_mode_flag or not (h.is_p() or h.is_i()):
        return None
    if h.first_mb_in_slice != 0 or pps.constrained_intra_pred_flag:
        return None
    if (pps.weighted_pred_flag and h.is_p()
            and any(w is not None for w in h.luma_weights_l0)):
        return None
    if h.ref_pic_list_mod_l0 or h.mmco_ops:
        return None
    mbh, mbw = sps.mb_height, sps.mb_width
    nref = (h.num_ref_idx_l0_active_minus1 + 1) if h.is_p() else 1
    if h.is_p() and dpb_depth < nref:
        return None
    qp_init = pps.pic_init_qp_minus26 + 26 + h.slice_qp_delta
    syn = native_parse.parse_slice(
        np.asarray(rbsp, np.uint8), bitpos, 0 if h.is_p() else 2,
        mbh, mbw, qp_init, nref, bool(pps.transform_8x8_mode_flag),
        want_raw=False)
    if syn is None:
        return None
    return {"syn": syn, "h": h, "nal_type": nal_type, "nref": nref,
            "deblock": h.disable_deblocking_filter_idc != 1,
            "offA": h.slice_alpha_c0_offset_div2 * 2,
            "offB": h.slice_beta_offset_div2 * 2}


def _syntax_frame(syn, mbh, mbw, h, nal_type, refs):
    """The Frame of a device-route picture, its metadata from the parsed
    syntax (the planes are filled in by the caller)."""
    from .decoder import Frame
    n = mbh * mbw
    mv_grid = syn["mv4"].reshape(mbh, mbw, 4, 4, 2).transpose(
        0, 2, 1, 3, 4).reshape(4 * mbh, 4 * mbw, 2)
    ref_grid = syn["ref4"].reshape(mbh, mbw, 4, 4).transpose(
        0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
    mb_types = np.empty(n, np.int32)
    k = syn["mb_kind"]
    mb_types[k == 0] = 1000
    for kk, mt in ((1, 100), (2, 101), (3, 102), (4, 103)):
        mb_types[k == kk] = mt
    i16sel = k == 5
    mb_types[i16sel] = (1 + syn["i16mode"][i16sel]
                        + 4 * syn["cbp_chroma"][i16sel]
                        + 12 * (syn["cbp_luma"][i16sel] != 0))
    mb_types[k == 6] = 0
    refid0 = np.full(ref_grid.shape, -1, np.int64)
    if refs:
        ids = np.array([id(f) % (1 << 62) for f in refs], np.int64)
        sel = ref_grid >= 0
        refid0[sel] = ids[np.clip(ref_grid[sel], 0, len(refs) - 1)]
    fr = Frame(None, None, None,
               frame_num=h.frame_num, is_idr=nal_type == 5,
               mb_types=mb_types.reshape(mbh, mbw),
               qps=syn["qp_map"].reshape(mbh, mbw).copy(),
               mvs=mv_grid.copy(), refs=ref_grid.copy(), refid0=refid0)
    fr.syntax = None
    return fr
