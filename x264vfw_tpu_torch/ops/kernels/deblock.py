"""In-loop deblocking filter (§8.7) from packed edge maps.

Port of x264vfw_tpu/ops/pallas/deblock.py :: deblock_apply, which computes
what x264vfw_tpu/ops/deblock.py :: deblock_apply_wavefront computes on the
JAX hot path.  On a CUDA tensor the wrapper launches the hand-written
sm_90a kernel in csrc/deblock.cu once per wavefront step; on a CPU tensor
it runs the plain PyTorch version below, which the CPU tests hold against
the JAX package and chip_smoke.py holds the kernel against on the card.

Contract: y (H, W), u/v (H/2, W/2) int32 reconstruction planes at
MB-multiple size; mapsV (H, 4mbw), mapsH (4mbh, W), mapsVc (H/2, 2mbw),
mapsHc (2mbh, W/2) int32 from ops.deblock.build_maps.  Returns the planes
filtered exactly as §8.7 filters them in MB raster order (per MB: the
vertical edges left to right, then the horizontal edges top to bottom).
An edge whose map holds bS = 0 (every frame border) is left as it is.

Order: the filter of MB (r, c) reads and writes the 3 (chroma: 1) pixel
columns of (r, c-1) next to its left edge and the rows of (r-1, c) above
its top edge, which (r-1, c+1)'s left edge wrote before.  MBs on one
anti-diagonal d = 2r + c touch disjoint pixels and depend only on lower
diagonals, so the 2*mbh + mbw - 2 diagonals taken in turn give the raster
order's result.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches since import (or since a caller reset it to 0): one per
#: wavefront diagonal
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("deblock").x264t_deblock_apply
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def diagonals(mbh: int, mbw: int) -> int:
    """Wavefront steps of one frame: d = 2r + c runs over 0..2(mbh-1)+mbw-1."""
    return 2 * (mbh - 1) + mbw


def _check(y, u, v, mapsV, mapsH, mapsVc, mapsHc) -> None:
    H, W = y.shape if y.dim() == 2 else (0, 0)
    if H < 16 or W < 16 or H % 16 or W % 16:
        raise ValueError(f"y must be (H, W) in whole MBs, got "
                         f"{tuple(y.shape)}")
    mbh, mbw = H // 16, W // 16
    want = {"y": (y, (H, W)), "u": (u, (H // 2, W // 2)),
            "v": (v, (H // 2, W // 2)), "mapsV": (mapsV, (H, 4 * mbw)),
            "mapsH": (mapsH, (4 * mbh, W)),
            "mapsVc": (mapsVc, (H // 2, 2 * mbw)),
            "mapsHc": (mapsHc, (2 * mbh, W // 2))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"{name} on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def deblock_apply(y, u, v, mapsV, mapsH, mapsVc, mapsHc):
    """Filtered (y, u, v); the inputs are not modified.  See the module
    doc."""
    global LAUNCHES
    _check(y, u, v, mapsV, mapsH, mapsVc, mapsHc)
    if y.device.type == "cpu":
        return deblock_apply_plain(y, u, v, mapsV, mapsH, mapsVc, mapsHc)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    H, W = y.shape
    oy, ou, ov = y.clone(), u.clone(), v.clone()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = _kernel()(oy.data_ptr(), ou.data_ptr(), ov.data_ptr(), H, W,
                   mapsV.data_ptr(), mapsH.data_ptr(), mapsVc.data_ptr(),
                   mapsHc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"deblock_apply launch failed: CUDA error {rc}")
    LAUNCHES += diagonals(H // 16, W // 16)
    return oy, ou, ov


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _unpack(m):
    return m & 7, (m >> 3) & 31, (m >> 8) & 255, (m >> 16) & 31


def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def luma_filter(p3, p2, p1, p0, q0, q1, q2, q3, m):
    """Elementwise §8.7.2.3/.4 on int32 lines.  Returns (p2', p1', p0',
    q0', q1', q2')."""
    bs, tc0, alpha, beta = _unpack(m)
    act = ((bs > 0) & ((p0 - q0).abs() < alpha)
           & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    tc = tc0 + ap.int() + aq.int()
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    w_p0 = (p0 + delta).clamp(0, 255)
    w_q0 = (q0 - delta).clamp(0, 255)
    dp1 = _clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1)
    dq1 = _clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1)
    w_p1 = torch.where(ap, p1 + dp1, p1)
    w_q1 = torch.where(aq, q1 + dq1, q1)

    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & strong
    s_p0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s_p1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s_p2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq & strong
    s_q0 = torch.where(sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s_q1 = torch.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, q1)
    s_q2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    return (torch.where(act & is4, s_p2, p2),
            torch.where(act, torch.where(is4, s_p1, w_p1), p1),
            torch.where(act, torch.where(is4, s_p0, w_p0), p0),
            torch.where(act, torch.where(is4, s_q0, w_q0), q0),
            torch.where(act, torch.where(is4, s_q1, w_q1), q1),
            torch.where(act & is4, s_q2, q2))


def chroma_filter(p1, p0, q0, q1, m):
    """Elementwise chroma edge filter (tc = tc0 + 1).  Returns (p0', q0')."""
    bs, tc0, alpha, beta = _unpack(m)
    act = ((bs > 0) & ((p0 - q0).abs() < alpha)
           & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    is4 = bs == 4
    return (torch.where(act, torch.where(is4, (2 * p1 + p0 + q1 + 2) >> 2,
                                         (p0 + delta).clamp(0, 255)), p0),
            torch.where(act, torch.where(is4, (2 * q1 + q0 + p1 + 2) >> 2,
                                         (q0 - delta).clamp(0, 255)), q0))


def _filter_tiles(ty, tc, mV, mH, mVc, mHc):
    """Filter a batch of MB tiles in place.  ty (n, 20, 20): the MB at
    [4:, 4:] with 4 rows above and 4 columns left of it; tc (2n, 10, 10):
    U and V tiles with a 2-pixel halo; maps per MB."""
    for e in range(4):                        # luma vertical, left to right
        x = 4 + 4 * e
        cols = [ty[:, 4:, x + k] for k in range(-4, 4)]
        out = luma_filter(*cols, mV[:, :, e])
        for k, o in zip(range(-3, 3), out):
            ty[:, 4:, x + k] = o
    mVc2 = torch.cat([mVc, mVc])
    for e in range(2):                        # chroma vertical
        x = 2 + 4 * e
        p0, q0 = chroma_filter(tc[:, 2:, x - 2], tc[:, 2:, x - 1],
                               tc[:, 2:, x], tc[:, 2:, x + 1], mVc2[:, :, e])
        tc[:, 2:, x - 1] = p0
        tc[:, 2:, x] = q0
    for f in range(4):                        # luma horizontal, top down
        r = 4 + 4 * f
        rows = [ty[:, r + k, 4:] for k in range(-4, 4)]
        out = luma_filter(*rows, mH[:, f, :])
        for k, o in zip(range(-3, 3), out):
            ty[:, r + k, 4:] = o
    mHc2 = torch.cat([mHc, mHc])
    for f in range(2):                        # chroma horizontal
        r = 2 + 4 * f
        p0, q0 = chroma_filter(tc[:, r - 2, 2:], tc[:, r - 1, 2:],
                               tc[:, r, 2:], tc[:, r + 1, 2:], mHc2[:, f, :])
        tc[:, r - 1, 2:] = p0
        tc[:, r, 2:] = q0


def deblock_apply_plain(y, u, v, mapsV, mapsH, mapsVc, mapsHc):
    """Plain PyTorch version: the anti-diagonal wavefront, each step a
    batch of MB tiles gathered with their halo, filtered and scattered
    back (the counterpart of deblock_apply_wavefront)."""
    H, W = y.shape
    mbh, mbw = H // 16, W // 16
    dev = y.device
    # a 4-pixel (chroma: 2) border above and left holds the halo of the
    # first row and column; those edges have bS = 0
    yp = torch.zeros(H + 4, W + 4, dtype=torch.int32, device=dev)
    yp[4:, 4:] = y
    cp = torch.zeros(2, H // 2 + 2, W // 2 + 2, dtype=torch.int32,
                     device=dev)
    cp[0, 2:, 2:] = u
    cp[1, 2:, 2:] = v
    a20 = torch.arange(20, device=dev)
    a10 = torch.arange(10, device=dev)
    a16, a8, a4, a2 = (torch.arange(k, device=dev) for k in (16, 8, 4, 2))
    for d in range(diagonals(mbh, mbw)):
        r = torch.arange(max(0, (d - mbw + 2) // 2), min(mbh - 1, d // 2) + 1,
                         device=dev)
        c = d - 2 * r
        n = r.shape[0]
        ly = (16 * r)[:, None] + a20             # padded rows of the tile
        lx = (16 * c)[:, None] + a20
        ty = yp[ly[:, :, None], lx[:, None, :]]
        cy = (8 * r)[:, None] + a10
        cx = (8 * c)[:, None] + a10
        pl = torch.cat([torch.zeros(n, dtype=torch.long, device=dev),
                        torch.ones(n, dtype=torch.long, device=dev)])
        cy2, cx2 = torch.cat([cy, cy]), torch.cat([cx, cx])
        tc = cp[pl[:, None, None], cy2[:, :, None], cx2[:, None, :]]
        mV = mapsV[((16 * r)[:, None] + a16)[:, :, None],
                   ((4 * c)[:, None] + a4)[:, None, :]]
        mH = mapsH[((4 * r)[:, None] + a4)[:, :, None],
                   ((16 * c)[:, None] + a16)[:, None, :]]
        mVc = mapsVc[((8 * r)[:, None] + a8)[:, :, None],
                     ((2 * c)[:, None] + a2)[:, None, :]]
        mHc = mapsHc[((2 * r)[:, None] + a2)[:, :, None],
                     ((8 * c)[:, None] + a8)[:, None, :]]
        _filter_tiles(ty, tc, mV, mH, mVc, mHc)
        # write back the MB with its left halo, then the top halo (the
        # corner is neither read by a filter nor written)
        yp[ly[:, 4:, None], lx[:, None, :]] = ty[:, 4:, :]
        yp[ly[:, :4, None], lx[:, None, 4:]] = ty[:, :4, 4:]
        cp[pl[:, None, None], cy2[:, 2:, None], cx2[:, None, :]] = \
            tc[:, 2:, :]
        cp[pl[:, None, None], cy2[:, :2, None], cx2[:, None, 2:]] = \
            tc[:, :2, 2:]
    return (yp[4:, 4:].contiguous(), cp[0, 2:, 2:].contiguous(),
            cp[1, 2:, 2:].contiguous())
