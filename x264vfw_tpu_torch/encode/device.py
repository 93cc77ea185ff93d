"""Device encode pipeline (PyTorch): layout helpers, residual pipelines,
integer-pel motion search + motion compensation, and the I / P cores.

Port of x264vfw_tpu/encode/device.py for the slices this package carries:
I16x16 with chroma intra, and with --partitions i4x4 the I_NxN candidate
(encode/intra4x4.py); P with one reference, either P16x16 (found by the
hierarchical or the exhaustive search, then optionally refined to half
or quarter pel) or the 8x8-grid partitions with half/quarter-pel
refinement (encode/inter_partition.py), or P16x16 over a DPB of up to
four references (--ref, _multi_ref_search_and_mc), with per-MB variance
AQ, MB-tree QP offsets, the per-MB 4x4-vs-8x8 transform decision,
explicit weighted prediction and the trellis-lite level refinement
(--trellis, _trellis_adjust); non-reference B with one reference per
list (L0, L1 and Bi 16x16, spatial direct and B_Skip); and the in-loop
deblock of the reconstruction.  Every function is batched
over macroblocks; sample arithmetic is int32 (int16 where the JAX code
keeps pixel data in int16, with the same values).  The outputs are the
same syntax tensors (levels in zigzag + block coding order, CBPs, MVs,
modes, per-MB QPs) and recon planes, bit for bit.

Where the JAX code aligns the reference with masked static shifts (a TPU
cannot gather), the port gathers: each MB's prediction at its own motion
vector (the prediction planes are identical), and the hierarchical
refine's and the sub-pel decision's arrays column by column at the
vector of the MB each column lies in, which is what the masks compute.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import cavlc_dev as cd
from ..ops import transform as tj
from ..ops.kernels.sad import argmin_first as _argmin_first
from ..ops.kernels.sad import sad16_argmin
from ..ops.kernels.sad import window_sads as _window_sads
from ..ops.tables import ZIGZAG_4x4

# luma 4x4 block coding order <-> raster within MB
BLK_X = np.asarray([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.asarray([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
ZZ = np.asarray(ZIGZAG_4x4)
_RAS = BLK_Y * 4 + BLK_X                      # block order -> raster pos
_INV16 = np.argsort(_RAS)                     # raster pos -> block order

# x264's decimate run table (common/macroblock.c i_ds_table4): the score a
# lone +-1 coefficient contributes given the zero-run below it
_DS_TABLE = np.asarray([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])


def _idx(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def mbize(plane: torch.Tensor, bs: int = 16) -> torch.Tensor:
    """(H, W) -> (H//bs * W//bs, bs, bs) in MB raster order."""
    H, W = plane.shape
    return (plane.reshape(H // bs, bs, W // bs, bs).permute(0, 2, 1, 3)
            .reshape(-1, bs, bs))


def unmbize(mbs: torch.Tensor, H: int, W: int, bs: int = 16) -> torch.Tensor:
    return (mbs.reshape(H // bs, W // bs, bs, bs).permute(0, 2, 1, 3)
            .reshape(H, W))


def mb_to_blocks(mbs: torch.Tensor) -> torch.Tensor:
    """(n, 16, 16) -> (n, 16, 4, 4) in block coding order."""
    n = mbs.shape[0]
    raster = mbs.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 4, 4)
    return raster.index_select(1, _idx(_RAS, mbs.device))


def blocks_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    """(n, 16, 4, 4) block coding order -> (n, 16, 16)."""
    n = blocks.shape[0]
    raster = blocks.index_select(1, _idx(_INV16, blocks.device))
    return raster.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)


def c8_to_blocks(c8: torch.Tensor) -> torch.Tensor:
    """(n, 8, 8) -> (n, 4, 4, 4) raster sub-block order."""
    n = c8.shape[0]
    return c8.reshape(n, 2, 4, 2, 4).permute(0, 1, 3, 2, 4).reshape(n, 4, 4, 4)


def blocks_to_c8(blocks: torch.Tensor) -> torch.Tensor:
    n = blocks.shape[0]
    return blocks.reshape(n, 2, 2, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 8, 8)


def zigzag16(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 16) zigzag order."""
    return blocks.reshape(*blocks.shape[:-2], 16).index_select(
        -1, _idx(ZZ, blocks.device))


def _edge_pad(plane: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-extend a 2D plane by p on every side (a clamped gather)."""
    H, W = plane.shape
    ys = torch.arange(-p, H + p, device=plane.device).clamp(0, H - 1)
    xs = torch.arange(-p, W + p, device=plane.device).clamp(0, W - 1)
    return plane[ys[:, None], xs[None, :]]


def _per_pixel(field: torch.Tensor, bs: int) -> torch.Tensor:
    """(mbh, mbw) per-MB values -> (mbh*bs, mbw*bs) per pixel."""
    return field.repeat_interleave(bs, 0).repeat_interleave(bs, 1)


def aq_qp_map(src_y: torch.Tensor, qp: int,
              aq_strength: float) -> torch.Tensor:
    """Variance adaptive quantisation (--aq-mode 1 / --aq-strength): busy
    MBs get a higher QP, flat MBs a lower one, normalised to the frame's
    mean energy: qp + clip(round(strength * 1.2 * (e - mean(e))), -6, 6)
    with e = log2(var + 1), clipped to [1, 51].  Returns (n,) int32.

    The JAX package computes var, log2 and the frame mean in float32 in
    XLA's reduction order.  Here each MB's variance is exact (var * 65536
    = 256 * sum(x^2) - sum(x)^2 in int64 on the device), and the rest runs
    in float64 in numpy on the host (one pull of n integers), so the map
    is the same on every device; it differs from the JAX package's only
    where a float32 rounding moves a value across a .5 step of round()."""
    mbs = mbize(src_y.to(torch.int64))
    s1 = mbs.sum(dim=(1, 2))
    num = (256 * (mbs * mbs).sum(dim=(1, 2)) - s1 * s1).cpu().numpy()
    energy = np.log2(num / 65536.0 + 1.0)
    adj = aq_strength * 1.2 * (energy - energy.mean())
    adj = np.clip(np.round(adj), -6, 6).astype(np.int32)
    return torch.as_tensor(np.clip(qp + adj, 1, 51).astype(np.int32),
                           device=src_y.device)


def realized_qp_chain(qp_mb: torch.Tensor, coded: torch.Tensor,
                      slice_qp: int):
    """Decoder-visible per-MB QP: only MBs that signal mb_qp_delta (coded
    residual) can move QP; the others inherit the previous MB's QP
    (§7.4.5).  Returns (qp_real (n,), qp_delta (n,)) int32; the delta is
    meaningful only where coded."""
    n = qp_mb.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=qp_mb.device)
    idx = torch.cummax(torch.where(coded, i, -1), dim=0).values
    qp_real = torch.where(idx >= 0, qp_mb[idx.clamp(min=0).long()],
                          slice_qp).to(torch.int32)
    prev = torch.cat([qp_real.new_full((1,), slice_qp), qp_real[:-1]])
    return qp_real, torch.where(coded, qp_mb - prev, 0).to(torch.int32)


# --------------------------------------------------------------------------
# P-frame pipeline
# --------------------------------------------------------------------------

def _halfpel_planes(ref_pad: torch.Tensor):
    """Spec half-pel planes of a padded reference (§8.4.2.2.1, 6-tap).

    ref_pad: (Hp, Wp) int32, padded by >= 3 on every side beyond what the
    caller reads.  Returns int32 (b, h, j) where, for integer coords
    (y, x): b[y, x] is the sample at (y, x+1/2), h[y, x] at (y+1/2, x) and
    j[y, x] at (y+1/2, x+1/2), computed from the unrounded b intermediate.
    Valid on [3:-3] of each axis (the taps wrap around the edges)."""
    def f6(a, dim):
        r = torch.roll
        return (r(a, 2, dim) - 5 * r(a, 1, dim) + 20 * a
                + 20 * r(a, -1, dim) - 5 * r(a, -2, dim) + r(a, -3, dim))

    a32 = ref_pad.to(torch.int32)
    b1 = f6(a32, 1)
    b = ((b1 + 16) >> 5).clamp(0, 255)
    h = ((f6(a32, 0) + 16) >> 5).clamp(0, 255)
    j = ((f6(b1, 0) + 512) >> 10).clamp(0, 255)
    return b, h, j


# quarter-pel sample = (P1 + P2 + 1) >> 1 of two {int, b, h, j} samples
# (§8.4.2.2.1 Table 8-12).  For the fractional position (fx, fy) in
# quarter units (mod 4), the two (plane, dx, dy) operands, offsets in full
# pels; planes: 0 = int, 1 = b, 2 = h, 3 = j
_QPEL_PAIRS = {
    (0, 0): ((0, 0, 0), (0, 0, 0)),
    (2, 0): ((1, 0, 0), (1, 0, 0)),
    (0, 2): ((2, 0, 0), (2, 0, 0)),
    (2, 2): ((3, 0, 0), (3, 0, 0)),
    (1, 0): ((0, 0, 0), (1, 0, 0)),
    (3, 0): ((1, 0, 0), (0, 1, 0)),
    (0, 1): ((0, 0, 0), (2, 0, 0)),
    (0, 3): ((2, 0, 0), (0, 0, 1)),
    (2, 1): ((1, 0, 0), (3, 0, 0)),
    (2, 3): ((3, 0, 0), (1, 0, 1)),
    (1, 2): ((2, 0, 0), (3, 0, 0)),
    (3, 2): ((3, 0, 0), (2, 1, 0)),
    (1, 1): ((1, 0, 0), (2, 0, 0)),
    (3, 1): ((1, 0, 0), (2, 1, 0)),
    (1, 3): ((2, 0, 0), (1, 0, 1)),
    (3, 3): ((2, 1, 0), (1, 0, 1)),
}


def _qpel_operands(tx: int, ty: int):
    """Total quarter offset (tx, ty) from the integer-aligned origin ->
    ((p1, o1x, o1y), (p2, o2x, o2y)) with offsets in full pels."""
    fx, fy = tx % 4, ty % 4
    ix, iy = (tx - fx) // 4, (ty - fy) // 4
    (p1, a1x, a1y), (p2, a2x, a2y) = _QPEL_PAIRS[(fx, fy)]
    return (p1, a1x + ix, a1y + iy), (p2, a2x + ix, a2y + iy)


_ME_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")
_RF = 3                 # the hierarchical refine's radius, full pels


def _split_me_method(me_backend: str) -> tuple[str, bool]:
    """me_backend as the JAX package spells it -> (backend, hier).  An
    ':hier' suffix selects the hierarchical search (x264's dia/hex/umh);
    without it the search is exhaustive (esa/tesa).  Every backend name
    means the same in the port, so the JAX package's _resolve_me_backend
    has no counterpart: the exhaustive search is sad16_argmin, the CUDA
    kernel on CUDA tensors and its plain version on CPU tensors."""
    backend, hier = ((me_backend[:-5], True) if me_backend.endswith(":hier")
                     else (me_backend, False))
    if backend not in _ME_BACKENDS:
        raise ValueError(f"unknown motion-search backend {me_backend!r}")
    return backend, hier


def _hier_search(src16: torch.Tensor, ref16: torch.Tensor, rng: int):
    """Hierarchical integer-pel search (x264vfw_tpu/encode/device.py:
    253-343), int16 planes in, (dxb, dyb) (mbh, mbw) int64 out.

    1. coarse: a full search over +-rng_c on 2x2-summed planes (the
       reference pooled, then edge-padded), cost 4*cSAD + 2*(|ody|+|odx|);
       the vector, doubled, is clipped to +-(rng - 3);
    2. refine: the +-3 offsets around it, on a band per MB row in which
       every column is aligned by the coarse vector of the MB that column
       lies in (the 3 columns beyond an MB's edge carry its neighbour's
       alignment, the frame's outer columns MB 0's and the last MB's, as
       in the JAX package's masked shifts); cost 4*SAD + |dx| + |dy| of
       the total vector;
    3. rescue: the +-2 offsets around zero, cost 4*SAD + |dx| + |dy|,
       which win ties against the refine.
    Candidates are row-major (dy, dx) and ties go to the first."""
    H, W = src16.shape
    mbh, mbw = H // 16, W // 16
    dev = src16.device

    def pool(p):
        return p.reshape(H // 2, 2, W // 2, 2).sum(dim=(1, 3))

    rc = (rng + 1) // 2
    Kc = 2 * rc + 1
    oc = (torch.arange(Kc, device=dev) - rc).abs()
    csads = _window_sads(pool(src16)[None], _edge_pad(pool(ref16), rc)[None],
                         Kc, Kc, 8, 8)[:, 0]
    ccost = 2 * (oc[:, None] + oc[None, :]).reshape(-1, 1, 1)
    bestc, _ = _argmin_first(csads * 4 + ccost)
    lim = rng - _RF
    dyb0 = (2 * (bestc // Kc - rc)).clamp(-lim, lim)
    dxb0 = (2 * (bestc % Kc - rc)).clamp(-lim, lim)

    cols = torch.arange(-_RF, W + _RF, device=dev)
    mbx = cols.clamp(0, W - 1) // 16
    rows = torch.arange(-_RF, 16 + _RF, device=dev)
    ys = (16 * torch.arange(mbh, device=dev)[:, None, None]
          + rows[None, :, None] + dyb0[:, mbx][:, None, :])
    xs = cols[None, None, :] + dxb0[:, mbx][:, None, :]
    band = ref16[ys.clamp(0, H - 1), xs.clamp(0, W - 1)]
    kr = 2 * _RF + 1
    rsads = _window_sads(src16.reshape(mbh, 16, W), band, kr, kr, 16,
                         16)[:, :, 0]
    r = torch.arange(-_RF, _RF + 1, device=dev)
    rdy, rdx = r.repeat_interleave(kr), r.repeat(kr)
    bestr, rval = _argmin_first(
        rsads * 4 + (dxb0[None] + rdx[:, None, None]).abs()
        + (dyb0[None] + rdy[:, None, None]).abs())

    zsads = _window_sads(src16[None], _edge_pad(ref16, 2)[None], 5, 5, 16,
                         16)[:, 0]
    z = torch.arange(-2, 3, device=dev)
    zdy, zdx = z.repeat_interleave(5), z.repeat(5)
    bestz, zval = _argmin_first(
        zsads * 4 + (zdx.abs() + zdy.abs())[:, None, None])
    use_z = zval <= rval
    return (torch.where(use_z, zdx[bestz], dxb0 + rdx[bestr]),
            torch.where(use_z, zdy[bestz], dyb0 + rdy[bestr]))


def _subpel_planes(ref_y: torch.Tensor, pad: int) -> torch.Tensor:
    """(4, H + 2 pad, W + 2 pad) int16: the reference edge-padded by pad
    and its b, h, j half-pel planes (_halfpel_planes)."""
    ref_pad = _edge_pad(ref_y, pad).to(torch.int32)
    return torch.stack([ref_pad, *_halfpel_planes(ref_pad)]).to(torch.int16)


def _subpel_refine(src16: torch.Tensor, planes: torch.Tensor, pad: int,
                   dxb: torch.Tensor, dyb: torch.Tensor, sub_lv: int):
    """The 16x16 half/quarter-pel decision and its luma prediction
    (x264vfw_tpu/encode/device.py:372-515).

    planes: (4, H + 2 pad, W + 2 pad) int16, the padded reference and its
    b, h, j half-pel planes.  The candidates are the even quarter offsets
    of [-2, 2]^2 (sub_lv 1) or all of them (sub_lv 2) around the integer
    vector; each is the rounded mean of two {int, b, h, j} samples
    (_qpel_operands).  The decision reads them from an array aligned per
    column at the integer vector of the MB the column lies in, edge-padded
    by one column (so within a pixel of an MB's left edge the neighbour's
    alignment shows, as in the JAX package), over every other row: cost
    4*SAD + |tx| + |ty|, ties to the first in row-major (ty, tx) order.
    The prediction at the winner is exact per MB.
    Returns (tx, ty) (mbh, mbw) and pred_y (H, W) int32."""
    _, Hp, Wp = planes.shape
    H, W = Hp - 2 * pad, Wp - 2 * pad
    mbh, mbw = H // 16, W // 16
    dev = planes.device
    ar = torch.arange

    # every plane aligned at the integer vector: rows -1..16 of each MB
    # row, columns -1..W (edge-padded by one)
    cc = ar(-1, W + 1, device=dev).clamp(0, W - 1)
    ox, oy = dxb[:, cc // 16], dyb[:, cc // 16]
    ys = (pad - 1 + 16 * ar(mbh, device=dev)[:, None, None]
          + ar(18, device=dev)[None, :, None] + oy[:, None, :])
    amap = planes[:, ys, (pad + cc)[None, None, :] + ox[:, None, :]]

    tr = range(-2, 3) if sub_lv >= 2 else (-2, 0, 2)
    deltas = [(tx, ty) for ty in tr for tx in tr]
    ops = torch.as_tensor([[*_qpel_operands(tx, ty)[0],
                            *_qpel_operands(tx, ty)[1]]
                           for tx, ty in deltas], device=dev)   # (N, 6)

    def read(p, ox_, oy_):
        """(N, mbh, 8, W): the candidates' operand samples on even rows."""
        return amap[p[:, None, None, None],
                    ar(mbh, device=dev)[None, :, None, None],
                    (1 + oy_)[:, None, None, None]
                    + 2 * ar(8, device=dev)[None, None, :, None],
                    (1 + ox_)[:, None, None, None]
                    + ar(W, device=dev)[None, None, None, :]]

    cand = (read(ops[:, 0], ops[:, 1], ops[:, 2])
            + read(ops[:, 3], ops[:, 4], ops[:, 5]) + 1) >> 1
    src_r = src16.reshape(mbh, 16, W)[:, ::2]
    sads = (src_r - cand).abs_().reshape(len(deltas), mbh, 8, mbw, 16) \
        .sum(dim=(2, 4), dtype=torch.int32)
    d = torch.as_tensor(deltas, device=dev)
    best, _ = _argmin_first(
        sads * 4 + (d[:, 0].abs() + d[:, 1].abs())[:, None, None])

    # exact MC: both operands at the winner, per pixel of the MB
    op = _per_pixel(ops[best], 16)                      # (H, W, 6)
    y = pad + ar(H, device=dev)[:, None] + _per_pixel(dyb, 16)
    x = pad + ar(W, device=dev)[None, :] + _per_pixel(dxb, 16)
    pred = ((planes[op[..., 0], y + op[..., 2], x + op[..., 1]].to(torch.int32)
             + planes[op[..., 3], y + op[..., 5], x + op[..., 4]] + 1) >> 1)
    return d[best, 0], d[best, 1], pred


def _motion_search_and_mc(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                          rng: int, subpel: int = 0,
                          me_backend: str = "auto"):
    """Integer-pel search, then the optional 16x16 half/quarter-pel
    refinement, then luma/chroma MC.

    The integer search is hierarchical (_hier_search) when me_backend
    ends in ':hier' and rng >= 6, else exhaustive: sad16_argmin (the CUDA
    kernel on the card, its plain version on the CPU), cost 4*SAD16 +
    (|dy|+|dx|), ties to the smallest offset id.  subpel: 0 = integer,
    1 = half, 2 = quarter pel (_subpel_refine).  Returns (mv_q (mbh, mbw,
    2) quarter-pel [x, y], pred_y (H, W), pred_u, pred_v) int32."""
    _, hier = _split_me_method(me_backend)
    H, W = src_y.shape
    sub_lv = int(subpel)
    if hier and rng >= 6:
        dxb, dyb = _hier_search(src_y.to(torch.int16), ref_y.to(torch.int16),
                                rng)
    else:
        K = 2 * rng + 1
        best = sad16_argmin(src_y.to(torch.uint8).contiguous(),
                            _edge_pad(ref_y, rng).to(torch.uint8).contiguous(),
                            rng)
        dyb = torch.div(best, K, rounding_mode="floor") - rng
        dxb = best % K - rng
    mv_q = torch.stack([dxb, dyb], dim=-1).to(torch.int32) * 4

    if sub_lv:
        pad = rng + 8
        tx, ty, pred_y = _subpel_refine(src_y.to(torch.int16),
                                        _subpel_planes(ref_y, pad), pad,
                                        dxb, dyb, sub_lv)
        mv_q = mv_q + torch.stack([tx, ty], dim=-1).to(torch.int32)
    else:
        # the reference sample at (y + dy, x + dx), edge-clamped
        ys = torch.arange(H, device=src_y.device)[:, None] + _per_pixel(dyb, 16)
        xs = torch.arange(W, device=src_y.device)[None, :] + _per_pixel(dxb, 16)
        pred_y = ref_y[ys.clamp(0, H - 1), xs.clamp(0, W - 1)].to(torch.int32)

    return (mv_q, pred_y, *_chroma_mc(mv_q, ref_u, ref_v, 8))


def _ref_bits(r: int, R: int) -> int:
    """The multi-reference decision's cost of signalling ref_idx r among R
    references: te(v) is one bit at R = 2, else ue(v), 2 * floor(log2(r +
    1)) + 1 bits (1 at r = 0)."""
    return 1 if R == 2 or r == 0 else 2 * ((r + 1).bit_length() - 1) + 1


def _multi_ref_search_and_mc(src_y, src_u, src_v, refs, rng: int,
                             subpel: int = 0, me_backend: str = "auto"):
    """P16x16 over a DPB (x264's --ref): the one-reference search and MC
    (_motion_search_and_mc) against every reference, then per MB the
    reference of least 4 * SAD16 of its prediction + (|mv_x| + |mv_y|) >> 2
    + 8 * _ref_bits, ties to the first (newest) reference.

    refs: (y, u, v) planes per reference in ref_idx order, newest first.
    Returns (mv_q (mbh, mbw, 2), ref_idx (mbh, mbw) int32, pred_y, pred_u,
    pred_v)."""
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    R = len(refs)
    cands = [_motion_search_and_mc(src_y, src_u, src_v, *ref, rng,
                                   subpel=subpel, me_backend=me_backend)
             for ref in refs]
    costs = torch.stack([
        (src_y - py).abs().reshape(mbh, 16, mbw, 16)
        .sum(dim=(1, 3), dtype=torch.int32) * 4
        + (mv_q.abs().sum(dim=-1) >> 2) + 8 * _ref_bits(r, R)
        for r, (mv_q, py, _, _) in enumerate(cands)])
    sel, _ = _argmin_first(costs)
    sel = sel.to(torch.int32)
    sel_y, sel_c = _per_pixel(sel, 16), _per_pixel(sel, 8)
    mv_q, py, pu, pv = cands[0]
    for r in range(1, R):
        mv_q = torch.where((sel == r)[..., None], cands[r][0], mv_q)
        py = torch.where(sel_y == r, cands[r][1], py)
        pu = torch.where(sel_c == r, cands[r][2], pu)
        pv = torch.where(sel_c == r, cands[r][3], pv)
    return mv_q, sel, py, pu, pv


def _chroma_mc(mv_q, ref_u, ref_v, bs: int):
    """Chroma MC (§8.4.2.2.2) of blocks of bs x bs chroma samples, each at
    its own quarter-pel luma vector mv_q (rows, cols, 2) [x, y]: integer
    offset mv_q >> 3, eighth-pel fraction mv_q & 7, bilinear over the
    edge-clamped reference.  Returns (pred_u, pred_v) int32."""
    Hc, Wc = ref_u.shape
    dev = ref_u.device
    ci = mv_q >> 3
    f = mv_q & 7
    cy = torch.arange(Hc, device=dev)[:, None] + _per_pixel(ci[..., 1], bs)
    cx = torch.arange(Wc, device=dev)[None, :] + _per_pixel(ci[..., 0], bs)
    fx = _per_pixel(f[..., 0], bs)
    fy = _per_pixel(f[..., 1], bs)
    y0, y1 = cy.clamp(0, Hc - 1), (cy + 1).clamp(0, Hc - 1)
    x0, x1 = cx.clamp(0, Wc - 1), (cx + 1).clamp(0, Wc - 1)

    def bil(ref):
        ref = ref.to(torch.int32)
        return ((8 - fx) * (8 - fy) * ref[y0, x0] + fx * (8 - fy) * ref[y0, x1]
                + (8 - fx) * fy * ref[y1, x0] + fx * fy * ref[y1, x1]
                + 32) >> 6

    return bil(ref_u), bil(ref_v)


def _decimate_score(levels: torch.Tensor) -> torch.Tensor:
    """x264 decimate score per 4x4 block: 9 if any |level| > 1, else the
    sum of ds_table[zero-run below each +-1].  levels: (..., 16) zigzag."""
    nz = levels != 0
    big = (levels.abs() > 1).any(dim=-1)
    idx = torch.arange(16, device=levels.device)
    prev = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    prev_below = torch.cat([torch.full_like(prev[..., :1], -1),
                            prev[..., :-1]], dim=-1)
    run = (idx - prev_below - 1).clamp(max=15)
    table = _idx(_DS_TABLE, levels.device)
    score = torch.where(nz, table[run], 0).sum(dim=-1)
    return torch.where(big, 9, score)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of positive int32 values, exact (the JAX package
    takes them from a float32 log2, which is exact at every |level| an
    8-bit residual can give)."""
    return 32 - cd.bit_length(x)


def _lam2_table() -> np.ndarray:
    """The t8 decision's lambda for qp 0..51: max(1, round(0.9 *
    2^((qp - 12) / 3))) in float32, as the JAX package computes it."""
    q = np.arange(52, dtype=np.float32)
    x = np.float32(0.9) * np.exp2((q - np.float32(12.0)) / np.float32(3.0))
    return np.maximum(1, np.round(x.astype(np.float32))).astype(np.int32)


LAM2 = _lam2_table()


# the trellis decision's lambda for qp 0..51, lam = (512 * 0.9) *
# 2^((qp - 12) / 3) in float32 as the JAX package computes it on XLA:CPU,
# as bit patterns: its exp2 is not numpy's (they differ by up to 7 ulps
# at some QPs), and no device's exp2 may move a threshold
# (test_torch_trellis.py holds the table to the JAX package's)
_TRELLIS_LAM_BITS = np.asarray([
    0x41e66666, 0x42112495, 0x4236de5c, 0x42666666, 0x42912495, 0x42b6de5c,
    0x42e66666, 0x43112495, 0x4336de5c, 0x43666666, 0x43912495, 0x43b6de5c,
    0x43e66666, 0x44112495, 0x4436de5c, 0x44666666, 0x44912495, 0x44b6de5c,
    0x44e66666, 0x45112495, 0x4536de5c, 0x45666666, 0x45912495, 0x45b6de5c,
    0x45e66666, 0x46112495, 0x4636de5c, 0x46666666, 0x46912495, 0x46b6de5c,
    0x46e66666, 0x47112495, 0x4736de5c, 0x47666666, 0x47912495, 0x47b6de5c,
    0x47e66666, 0x48112495, 0x4836de5c, 0x48666666, 0x48912495, 0x48b6de5c,
    0x48e66666, 0x49112495, 0x4936de5c, 0x49666666, 0x49912495, 0x49b6de62,
    0x49e66666, 0x4a112491, 0x4a36de5d, 0x4a66666d,
], dtype=np.uint32)


def _trellis_lam_tables() -> tuple:
    """(lam, lam * 4, lam * 1.5) float32 for qp 0..51: the thresholds for
    dropping a lone +-1 and for stepping a larger level down."""
    lam = _TRELLIS_LAM_BITS.view(np.float32)
    return lam, lam * np.float32(4.0), lam * np.float32(1.5)


TRELLIS_LAM, TRELLIS_DROP, TRELLIS_STEP = _trellis_lam_tables()


def _trellis_adjust(coef, q, qp, intra: bool):
    """Trellis-lite (x264's --trellis): lower a level by one, or drop a
    lone +-1, where the distortion it adds is below the rate it saves at
    the QP's lambda.  The distortion is measured in the dequantised domain
    (4 |w| against L * V << qp/6): e = 4 |w| - |L| V, dD = V (2 e + V);
    a +-1 drops when dD < 4 lam, a larger level steps down when dD < 1.5
    lam (float32 comparisons, dD converted from int32 as the JAX package
    does).  Every value stays in int32: |w| <= 16 * 4 * 255, V <= 25 << 8,
    so |dD| < 2^30.

    coef: (n, 16, 4, 4) fdct4x4 output; q: its quant4x4 levels; qp: int or
    (n, 1) per-MB QPs.  intra is unused, as in the JAX package.  Returns
    the adjusted levels."""
    del intra
    qp = tj._qp(qp)
    V = tj._per_qp("dequant", qp, coef.device) << tj._bc(qp // 6, qp)
    absq = q.abs()
    e = coef.abs() * 4 - absq * V
    dD = (V * (2 * e + V)).to(torch.float32)
    if isinstance(qp, torch.Tensor):
        drop = tj._bc(torch.as_tensor(TRELLIS_DROP, device=coef.device)[
            qp.long()], qp)
        step = tj._bc(torch.as_tensor(TRELLIS_STEP, device=coef.device)[
            qp.long()], qp)
    else:
        drop = torch.tensor(TRELLIS_DROP[qp], device=coef.device)
        step = torch.tensor(TRELLIS_STEP[qp], device=coef.device)
    newabs = torch.where((absq == 1) & (dD < drop), 0,
                         torch.where((absq >= 2) & (dD < step), absq - 1,
                                     absq))
    return torch.sign(q) * newabs


def _luma_residual_pipeline(src_mbs, pred_mbs, qp, intra: bool,
                            decimate: bool = False, trellis: bool = False,
                            t8: bool = False):
    """fdct + quant (+ trellis) + zigzag and the decoder-exact recon
    residual.

    qp: int, or (n, 1) per-MB QPs.  trellis: _trellis_adjust the 4x4
    levels after quant, before zigzag and decimation (the 8x8 candidate
    is not refined, as in the JAX package).  decimate (inter only): zero
    a whole MB's luma residual when its summed decimate score is < 6
    (x264's default dct-decimate).  t8 (inter only): also evaluate the 8x8
    transform per MB (--8x8dct) and pick 4x4 or 8x8 by SSD + lambda *
    rate; the 8x8 levels come in CAVLC's interleaved-4x4 layout (§8.5.6:
    sub-block b of 8x8 block k sits in 4x4 slot 4k+b and carries 8x8
    scan positions 4j+b), so every consumer (slots, nC, CBP) reads them as
    it reads 4x4 levels.
    Returns (levels_zz (n, 16, 16), recon_res (n, 16, 16), t8_flag (n,)
    bool or None)."""
    resid = src_mbs - pred_mbs
    blocks = mb_to_blocks(resid)
    coef = tj.fdct4x4(blocks)
    q = tj.quant4x4(coef, qp, intra=intra)
    if trellis:
        q = _trellis_adjust(coef, q, qp, intra)
    levels = zigzag16(q)                            # (n, 16, 16)
    if decimate and not intra:
        keep = _decimate_score(levels).sum(dim=-1) >= 6      # (n,)
        levels = levels * keep[:, None, None]
        q = q * keep[:, None, None, None]
    res = blocks_to_mb(tj.idct4x4_core(tj.dequant4x4(q, qp)))
    if not t8 or intra:
        return levels, res, None

    # ---- the 8x8 transform candidate ----
    n = resid.shape[0]
    # (n, 4, 8, 8) quadrant blocks in cbp order (TL, TR, BL, BR)
    b8 = resid.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8)
    q8 = tj.quant8x8(tj.fdct8x8(b8), qp, intra=False)
    lv8 = tj.zigzag8x8_scan(q8).reshape(n, 4, 16, 4).permute(0, 1, 3, 2) \
        .reshape(n, 16, 16)
    if decimate:
        keep8 = _decimate_score(lv8).sum(dim=-1) >= 6
        lv8 = lv8 * keep8[:, None, None]
        q8 = q8 * keep8[:, None, None, None]
    res8 = tj.idct8x8_core(tj.dequant8x8(q8, qp))
    res8_mb = res8.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def cost(levels_, res_):
        """SSD against the true residual, and a rate proxy in bits."""
        ssd = ((res_ - resid) ** 2).sum(dim=(-1, -2), dtype=torch.int32)
        a = levels_.abs()
        bits = (2 * (a > 0).sum(dim=(-1, -2), dtype=torch.int32)
                + (31 - _clz32(a.clamp(min=1))).sum(dim=(-1, -2),
                                                    dtype=torch.int32))
        return ssd, bits

    if isinstance(qp, torch.Tensor):
        lam2 = torch.as_tensor(LAM2, device=qp.device)[qp.long()].reshape(n)
    else:
        lam2 = int(LAM2[qp])
    ssd4, bits4 = cost(levels, res)
    ssd8, bits8 = cost(lv8, res8_mb)
    flag8 = (ssd8 + lam2 * bits8) < (ssd4 + lam2 * bits4)
    levels = torch.where(flag8[:, None, None], lv8, levels)
    res = torch.where(flag8[:, None, None], res8_mb, res)
    return levels, res, flag8


def _chroma_residual_pipeline(src_c8, pred_c8, qpc, intra: bool,
                              qp_dc=None):
    """Chroma 8x8: DC Hadamard + AC.  qpc: int or (n, 1) per MB; qp_dc:
    int or (n,) for the DC path (default qpc).  Returns (dc_levels
    (n, 2, 2), ac_levels (n, 4, 15))."""
    if qp_dc is None:
        qp_dc = qpc
    coef = tj.fdct4x4(c8_to_blocks(src_c8 - pred_c8))       # (n, 4, 4, 4)
    dc = coef[:, :, 0, 0].reshape(-1, 2, 2)
    dc_lv = tj.chroma_dc_fwd_quant(dc, qp_dc, intra=intra)
    q = tj.quant4x4(coef, qpc, intra=intra)
    q[:, :, 0, 0] = 0
    return dc_lv, zigzag16(q)[:, :, 1:]


def _chroma_recon(pred_c8, dc_lv, ac_lv, qpc, use_dc, use_ac, qp_dc=None):
    """Decoder-exact chroma recon with cbp masking.  use_dc/use_ac: (n,);
    qpc/qp_dc as in _chroma_residual_pipeline."""
    if qp_dc is None:
        qp_dc = qpc
    n = pred_c8.shape[0]
    dc_lv = dc_lv * use_dc[:, None, None]
    ac_lv = ac_lv * use_ac[:, None, None]
    dc_rec = tj.chroma_dc_dequant(dc_lv, qp_dc)     # (n, 2, 2)
    full = torch.cat([ac_lv.new_zeros(n, 4, 1), ac_lv], dim=-1)
    d = tj.dequant4x4(tj.zigzag_unscan(full), qpc)
    d[:, :, 0, 0] = dc_rec.reshape(n, 4)            # raster sb order
    rec = pred_c8 + blocks_to_c8(tj.idct4x4_core(d))
    return rec.clamp(0, 255)


def encode_p_frame_core(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                        qp: int, qpc: int, rng: int = 8, subpel: int = 0,
                        me_backend: str = "auto", decimate: bool = True,
                        partitions: bool = False, aq_strength: float = 0.0,
                        qpc_offset: int = 0, wp=None, dct8x8: bool = False,
                        qp_off=None, trellis: bool = False):
    """P-frame encode: P16x16 from one reference, or with `partitions` the
    16x16/16x8/8x16/8x8 decision on the 8x8 grid (adds 'part' (n,) and
    'mv8' (2mbh, 2mbw, 2) to the outputs), or, when the reference planes
    are stacked (R, H, W) in ref_idx order, P16x16 over the R references
    (_multi_ref_search_and_mc; adds 'ref_idx' (n,), and partitions are
    not searched).  All planes int32 at MB-multiple size.  Returns syntax
    tensors + recon planes (pre-deblock).

    aq_strength > 0: per-MB variance AQ (aq_qp_map); quant and dequant run
    with the per-MB QPs and the outputs carry 'qp_real' and 'qp_delta'
    (the mb_qp_delta chain, §7.4.5).  qp_off, optional (n,) or (mbh, mbw)
    int32: additive per-MB QP offsets (MB-tree), added to the AQ map (or
    to qp) and clipped to [1, 51]; they switch on the same per-MB QP
    bookkeeping.  wp, optional (w, o) ints: explicit weighted prediction
    of luma (§8.4.2.3, denominator 6) applied to the interpolated
    prediction, in the decoder's order.  dct8x8: the per-MB 4x4-vs-8x8
    transform decision (adds 't8' (n,) bool).  trellis: _trellis_adjust
    on the 4x4 levels."""
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    n = mbh * mbw
    src_mbs = mbize(src_y)
    aq = float(aq_strength) > 0.0
    if aq or qp_off is not None:
        qp_mb = (aq_qp_map(src_y, qp, float(aq_strength)) if aq else
                 torch.full((n,), qp, dtype=torch.int32, device=src_y.device))
        if qp_off is not None:
            qp_mb = (qp_mb + qp_off.reshape(n)).clamp(1, 51).to(torch.int32)
        qpc_mb = tj.chroma_qp(qp_mb, qpc_offset)
        qp_l, qp_c, qp_cdc = qp_mb[:, None], qpc_mb[:, None], qpc_mb
        aq = True                       # per-MB QP bookkeeping below
    else:
        qp_l, qp_c, qp_cdc = qp, qpc, qpc
    part = mv8 = ref_sel = None
    if ref_y.dim() == 3:
        mv_q4, ref_sel, pred_y_pl, pred_u_pl, pred_v_pl = \
            _multi_ref_search_and_mc(
                src_y, src_u, src_v,
                list(zip(ref_y, ref_u, ref_v)),
                rng, subpel=subpel, me_backend=me_backend)
    elif partitions:
        from .inter_partition import partition_search_and_mc
        part, mv8, pred_y_pl, pred_u_pl, pred_v_pl = partition_search_and_mc(
            src_y, src_u, src_v, ref_y, ref_u, ref_v, rng, qp, subpel)
        # per-MB field: the per-component max |mv| over the quadrants (the
        # JAX package's colocated-motion summary)
        mv_q4 = mv8.abs().reshape(mbh, 2, mbw, 2, 2).amax(dim=(1, 3))
    else:
        mv_q4, pred_y_pl, pred_u_pl, pred_v_pl = _motion_search_and_mc(
            src_y, src_u, src_v, ref_y, ref_u, ref_v, rng, subpel=subpel,
            me_backend=me_backend)
    if wp is not None:
        wp_w, wp_o = wp
        pred_y_pl = (((pred_y_pl * wp_w + 32) >> 6) + wp_o).clamp(0, 255)

    pred = mbize(pred_y_pl)
    levels, recon_res, t8_flag = _luma_residual_pipeline(
        src_mbs, pred, qp_l, intra=False, decimate=decimate,
        trellis=trellis, t8=dct8x8)

    # cbp luma per 8x8 quadrant (block coding order: blocks q*4..q*4+3)
    cbp_q = (levels != 0).any(dim=-1).reshape(n, 4, 4).any(dim=-1)
    bit = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=src_y.device)
    cbp_luma = (cbp_q * bit).sum(dim=-1, dtype=torch.int32)

    # luma recon with cbp masking (uncoded quadrants add no residual)
    keep = cbp_q.repeat_interleave(4, dim=-1)       # (n, 16) per block
    res_mb = blocks_to_mb(mb_to_blocks(recon_res) * keep[:, :, None, None])
    recon_y_mbs = (pred + res_mb).clamp(0, 255)

    pred_u = mbize(pred_u_pl, 8)
    pred_v = mbize(pred_v_pl, 8)
    dc_u, ac_u = _chroma_residual_pipeline(mbize(src_u, 8), pred_u, qp_c,
                                           False, qp_dc=qp_cdc)
    dc_v, ac_v = _chroma_residual_pipeline(mbize(src_v, 8), pred_v, qp_c,
                                           False, qp_dc=qp_cdc)
    has_ac = (ac_u != 0).any(dim=2).any(dim=1) | \
        (ac_v != 0).any(dim=2).any(dim=1)
    has_dc = (dc_u != 0).any(dim=2).any(dim=1) | \
        (dc_v != 0).any(dim=2).any(dim=1)
    cbp_chroma = torch.where(has_ac, 2, torch.where(has_dc, 1, 0)).to(
        torch.int32)
    use_dc = cbp_chroma >= 1
    use_ac = cbp_chroma == 2
    rec_u = _chroma_recon(pred_u, dc_u, ac_u, qp_c, use_dc, use_ac,
                          qp_dc=qp_cdc)
    rec_v = _chroma_recon(pred_v, dc_v, ac_v, qp_c, use_dc, use_ac,
                          qp_dc=qp_cdc)
    out = {
        "mv": mv_q4.reshape(n, 2),      # (n, 2) quarter-pel
        "levels": levels,               # (n, 16, 16) zigzag, block order
        "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_chroma,
        "dc_u": dc_u, "dc_v": dc_v,     # (n, 2, 2)
        "ac_u": ac_u, "ac_v": ac_v,     # (n, 4, 15)
        "recon_y": unmbize(recon_y_mbs, H, W),
        "recon_u": unmbize(rec_u, H // 2, W // 2, 8),
        "recon_v": unmbize(rec_v, H // 2, W // 2, 8),
    }
    if ref_sel is not None:
        out["ref_idx"] = ref_sel.reshape(n)
    if part is not None:
        out["part"] = part.reshape(n)
        out["mv8"] = mv8
    if t8_flag is not None:
        out["t8"] = t8_flag
    if aq:
        coded = (cbp_luma != 0) | (cbp_chroma != 0)
        out["qp_real"], out["qp_delta"] = realized_qp_chain(qp_mb, coded, qp)
    return out


# --------------------------------------------------------------------------
# B-frame pipeline
# --------------------------------------------------------------------------

def _direct_flip_mask(mode_map: torch.Tensor, colzero: torch.Tensor):
    """Eligibility masks for flipping explicit-mode MBs to spatial
    B_Direct_16x16 / B_Skip (§8.4.1.2.2) whose decoder prediction is known
    exactly in advance, for any subset of eligible MBs flipped.

    With single-entry reference lists the derived refIdxLX (MinPositive
    over the available neighbours A, B and C, D where C is unavailable)
    is 0 iff one of them uses list X.  Under colZeroFlag the derived
    vector is 0 on every list used, so the prediction follows from the
    derived usage alone:
    * `both`, and `none` (directZeroPredictionFlag: refIdx 0, 0 at mv 0),
      predict bi(0, 0).  A flipped MB of either class uses both lists,
      so flips keep `both` and can only turn `none` into `both`;
    * `L0 only` predicts from reference 0 at mv 0, but is stable only if
      no flip anywhere can bring in L1: the phase-1 field uses no L1 and
      no `none` MB is flipped.  L1 alike.

    mode_map: (mbh, mbw) phase-1 modes (1 = L0, 2 = L1, 3 = Bi).
    colzero: (mbh, mbw) bool colZeroFlag.
    Returns (elig_bi, elig_l0, elig_l1) bool maps."""
    use0 = (mode_map == 1) | (mode_map == 3)
    use1 = (mode_map == 2) | (mode_map == 3)

    def nb_any(use):
        """An available neighbour A, B or C (D where C is unavailable)
        uses the list."""
        a = torch.zeros_like(use)
        a[:, 1:] = use[:, :-1]
        b = torch.zeros_like(use)
        b[1:] = use[:-1]
        d = torch.zeros_like(use)
        d[1:, 1:] = use[:-1, :-1]
        c = d.clone()           # above-right where it exists, else D
        c[1:, :-1] = use[:-1, 1:]
        return a | b | c

    dl0 = nb_any(use0)
    dl1 = nb_any(use1)
    elig_bi = colzero & ((dl0 & dl1) | (~dl0 & ~dl1))
    elig_l0 = colzero & dl0 & ~dl1 & ~use1.any()
    elig_l1 = colzero & dl1 & ~dl0 & ~use0.any()
    return elig_bi, elig_l0, elig_l1


def mv_bits(mv: torch.Tensor) -> torch.Tensor:
    """The mode decision's rate proxy for an mvd pair (the predictor is
    not known there): 2 * ceil(log2(|x| + |y| + 2)) + 2, which the JAX
    package takes from a float32 log2.  ceil(log2(a + 2)) is the bit
    length of a + 1, exactly; the two agree for every a below 2^16
    (test_torch_bframes.py), far beyond the reachable |x| + |y| <= 4 *
    (2 * 16 + 1)."""
    return 2 * cd.bit_length(mv.abs().sum(dim=-1) + 1) + 2


def encode_b_frame_core(src_y, src_u, src_v, ref0_y, ref0_u, ref0_v,
                        ref1_y, ref1_u, ref1_v, mvcol, qp: int, qpc: int,
                        rng: int = 8, subpel: int = 0,
                        me_backend: str = "auto", decimate: bool = True,
                        dct8x8: bool = False, trellis: bool = False):
    """B-frame encode: independent L0 and L1 motion searches (each one
    _motion_search_and_mc), the per-MB {L0, L1, Bi} decision (default
    bi-prediction, (p0 + p1 + 1) >> 1, §8.4.2.3.1), then a second phase
    that flips MBs to spatial B_Direct_16x16 / B_Skip where the decoder's
    direct derivation provably equals the prediction coded
    (_direct_flip_mask) and it is no dearer.  Ties in the decision go to
    the first of L0, L1, Bi; the flips take equal costs.

    mvcol: (n, 2) the colocated motion field of RefPicList1[0], the
    anchor after this frame (TorchEncoder.last_mv): per MB its vector,
    or for an anchor with partitions the per-component max |mv| over the
    MB's four 8x8 quadrants.  An MB is colZero when both components are
    <= 1 in magnitude, a conservative colZeroFlag (the decoder derives
    it per block).  B frames are non-reference (no B-pyramid), so no
    recon is computed.
    Returns 'mode' (n,) 0 = direct, 1 = L0, 2 = L1, 3 = Bi; 'mv0', 'mv1'
    (n, 2) quarter-pel; 'uses0', 'uses1' (n,) the final list usage as
    the decoder sees it; the residual syntax tensors; and 't8' with
    dct8x8.  trellis: _trellis_adjust on the 4x4 levels."""
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    n = mbh * mbw
    dev = src_y.device
    src_mbs = mbize(src_y)

    mv0_q4, p0y, p0u, p0v = _motion_search_and_mc(
        src_y, src_u, src_v, ref0_y, ref0_u, ref0_v, rng, subpel=subpel,
        me_backend=me_backend)
    mv1_q4, p1y, p1u, p1v = _motion_search_and_mc(
        src_y, src_u, src_v, ref1_y, ref1_u, ref1_v, rng, subpel=subpel,
        me_backend=me_backend)
    biy = (p0y + p1y + 1) >> 1
    biu = (p0u + p1u + 1) >> 1
    biv = (p0v + p1v + 1) >> 1
    # the direct candidate: bi-prediction at mv 0 (the one direct shape the
    # flips admit), the rounded mean of the two references
    diy = (ref0_y + ref1_y + 1) >> 1
    diu = (ref0_u + ref1_u + 1) >> 1
    div = (ref0_v + ref1_v + 1) >> 1

    def mbsad(pred):
        return (src_y - pred).abs().reshape(mbh, 16, mbw, 16) \
            .sum(dim=(1, 3), dtype=torch.int32).reshape(n)

    mv0 = mv0_q4.reshape(n, 2)
    mv1 = mv1_q4.reshape(n, 2)
    lam = 4                     # the integer search's lambda (4 * SAD + bits)
    c0 = mbsad(p0y) * 4 + lam * (3 + mv_bits(mv0))
    c1 = mbsad(p1y) * 4 + lam * (3 + mv_bits(mv1))
    cbi = mbsad(biy) * 4 + lam * (5 + mv_bits(mv0) + mv_bits(mv1))
    mode = torch.where((c0 <= c1) & (c0 <= cbi), 1,
                       torch.where(c1 <= cbi, 2, 3)).to(torch.int32)
    cmin = torch.minimum(c0, torch.minimum(c1, cbi))

    # ---- phase 2: the direct / skip flips ----
    colzero = (mvcol.abs() <= 1).all(dim=-1).reshape(mbh, mbw)
    elig_bi, elig_l0, elig_l1 = _direct_flip_mask(mode.reshape(mbh, mbw),
                                                  colzero)
    flip_bi = elig_bi.reshape(n) & (mbsad(diy) * 4 + lam <= cmin)
    flip_l0 = elig_l0.reshape(n) & (mbsad(ref0_y) * 4 + lam <= cmin)
    flip_l1 = elig_l1.reshape(n) & (mbsad(ref1_y) * 4 + lam <= cmin)
    flip = flip_bi | flip_l0 | flip_l1
    # direct flavour per MB: 0 = bi(0, 0), 1 = L0(0, 0), 2 = L1(0, 0)
    flavor = torch.where(flip_l0, 1, torch.where(flip_l1, 2, 0))
    mode = torch.where(flip, 0, mode).to(torch.int32)

    def select(bs, direct, p0, p1, bi, r0, r1):
        """Per-pixel prediction of the chosen mode and flavour."""
        m = _per_pixel(mode.reshape(mbh, mbw), bs)
        f = _per_pixel(flavor.reshape(mbh, mbw), bs)
        dpl = torch.where(f == 1, r0, torch.where(f == 2, r1, direct))
        return torch.where(m == 0, dpl, torch.where(
            m == 1, p0, torch.where(m == 2, p1, bi))).to(torch.int32)

    pred = mbize(select(16, diy, p0y, p1y, biy, ref0_y, ref1_y))
    pred_u = mbize(select(8, diu, p0u, p1u, biu, ref0_u, ref1_u), 8)
    pred_v = mbize(select(8, div, p0v, p1v, biv, ref0_v, ref1_v), 8)
    levels, _, t8_flag = _luma_residual_pipeline(
        src_mbs, pred, qp, intra=False, decimate=decimate, trellis=trellis,
        t8=dct8x8)
    cbp_q = (levels != 0).any(dim=-1).reshape(n, 4, 4).any(dim=-1)
    bit = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=dev)
    cbp_luma = (cbp_q * bit).sum(dim=-1, dtype=torch.int32)
    dc_u, ac_u = _chroma_residual_pipeline(mbize(src_u, 8), pred_u, qpc,
                                           False)
    dc_v, ac_v = _chroma_residual_pipeline(mbize(src_v, 8), pred_v, qpc,
                                           False)
    has_ac = (ac_u != 0).any(dim=2).any(dim=1) | \
        (ac_v != 0).any(dim=2).any(dim=1)
    has_dc = (dc_u != 0).any(dim=2).any(dim=1) | \
        (dc_v != 0).any(dim=2).any(dim=1)
    cbp_chroma = torch.where(has_ac, 2, torch.where(has_dc, 1, 0)).to(
        torch.int32)
    out = {
        "mode": mode,
        "mv0": mv0, "mv1": mv1,
        # the final list usage (decoder view): explicit modes use their
        # lists, direct MBs those of their flavour
        "uses0": torch.where(flip, flavor != 2, (mode == 1) | (mode == 3)),
        "uses1": torch.where(flip, flavor != 1, (mode == 2) | (mode == 3)),
        "levels": levels,
        "cbp_luma": cbp_luma,
        "cbp_chroma": cbp_chroma,
        "dc_u": dc_u, "dc_v": dc_v,
        "ac_u": ac_u, "ac_v": ac_v,
    }
    if t8_flag is not None:
        out["t8"] = t8_flag
    return out


# --------------------------------------------------------------------------
# I-frame pipeline
# --------------------------------------------------------------------------

def encode_i_frame_core(src_y, src_u, src_v, qp: int, qpc: int,
                        i4x4: bool = False):
    """I-frame encode: anti-diagonal wavefront with full per-MB
    Intra_16x16 (V/H/DC/Plane) and chroma (DC/H/V/Plane) mode decision
    under exact reconstruction feedback (see intra_wavefront).  i4x4 adds
    the 9-mode I_NxN candidate per MB (slope-2 wavefront, intra4x4).

    Returns syntax tensors + recon planes + per-MB 'i16_mode'/'cmode'."""
    from .intra_wavefront import encode_i_frame_core_wf
    return encode_i_frame_core_wf(src_y, src_u, src_v, qp, qpc, i4x4)


def _luma_residual_pipeline_i16(src_mbs, pred_mbs, qp: int):
    """I16x16: separate DC (Hadamard) + AC-only levels.

    Returns (levels dict with 'dc' (n, 16) zigzag of the DC block and
    'ac' (n, 16, 15), recon residual (n, 16, 16))."""
    blocks = mb_to_blocks(src_mbs - pred_mbs)
    coef = tj.fdct4x4(blocks)
    n = coef.shape[0]
    by, bx = _idx(BLK_Y, coef.device), _idx(BLK_X, coef.device)
    dc_r = coef.new_zeros(n, 4, 4)                  # DC in raster layout
    dc_r[:, by, bx] = coef[:, :, 0, 0]
    dc_lv = tj.luma_dc_fwd_quant(dc_r, qp)          # (n, 4, 4) raster
    q = tj.quant4x4(coef, qp, intra=True)
    q[:, :, 0, 0] = 0
    ac_lv = zigzag16(q)[:, :, 1:]                   # (n, 16, 15)
    dc_rec = tj.luma_dc_dequant(dc_lv, qp)
    d = tj.dequant4x4(q, qp)
    d[:, :, 0, 0] = dc_rec[:, by, bx]
    res = tj.idct4x4_core(d)
    return {"dc": zigzag16(dc_lv), "ac": ac_lv}, blocks_to_mb(res)


def _dc_only_residual(dc_zz, qp: int, n: int):
    """Residual contribution of the DC block alone (AC zeroed)."""
    dc_rec = tj.luma_dc_dequant(tj.zigzag_unscan(dc_zz), qp)
    by, bx = _idx(BLK_Y, dc_zz.device), _idx(BLK_X, dc_zz.device)
    d = dc_zz.new_zeros(n, 16, 4, 4)
    d[:, :, 0, 0] = dc_rec[:, by, bx]
    return blocks_to_mb(tj.idct4x4_core(d))


def _finish_intra_mb(sy, pred_y, levels, res_mb, su, pu, sv, pv,
                     qp: int, qpc: int):
    """Shared I16x16 tail: cbp, chroma, recon.  All batched (n, ...)."""
    n = sy.shape[0]
    cbp_luma_nz = (levels["ac"] != 0).any(dim=2).any(dim=1)
    # I16x16 luma AC is all-or-nothing: recon keeps AC only when coded
    dc_only = _dc_only_residual(levels["dc"], qp, n)
    res_final = torch.where(cbp_luma_nz[:, None, None], res_mb, dc_only)
    recon_y = (pred_y + res_final).clamp(0, 255)

    dc_u, ac_u = _chroma_residual_pipeline(su, pu, qpc, True)
    dc_v, ac_v = _chroma_residual_pipeline(sv, pv, qpc, True)
    has_ac = (ac_u != 0).any(dim=2).any(dim=1) | \
        (ac_v != 0).any(dim=2).any(dim=1)
    has_dc = (dc_u != 0).any(dim=2).any(dim=1) | \
        (dc_v != 0).any(dim=2).any(dim=1)
    cbp_chroma = torch.where(has_ac, 2, torch.where(has_dc, 1, 0)).to(
        torch.int32)
    rec_u = _chroma_recon(pu, dc_u, ac_u, qpc, cbp_chroma >= 1,
                          cbp_chroma == 2)
    rec_v = _chroma_recon(pv, dc_v, ac_v, qpc, cbp_chroma >= 1,
                          cbp_chroma == 2)
    return {
        "dc": levels["dc"], "ac": levels["ac"],
        "cbp_luma_nz": cbp_luma_nz, "cbp_chroma": cbp_chroma,
        "dc_u": dc_u, "dc_v": dc_v, "ac_u": ac_u, "ac_v": ac_v,
        "recon_y": recon_y, "recon_u": rec_u, "recon_v": rec_v,
    }


def loop_filter_maps(out, qp: int, mbh: int, mbw: int, intra: bool,
                     offA: int = 0, offB: int = 0, qpc_offset: int = 0):
    """The deblock edge maps of a frame from the encoder's own syntax
    tensors: per-4x4 total_coeff of the cbp-masked levels (an 8x8-
    transformed MB's quadrant count on each of its four 4x4 blocks), the
    motion field broadcast to 4x4 blocks (mv8 where the frame has
    partitions), an all-intra or all-inter frame, each MB's ref_idx
    ('ref_idx' with several references, else 0: bS 1 across an edge
    between different references), the decoder-visible per-MB QP
    ('qp_real' under AQ, else qp), and no internal 4x4 edges in
    8x8-transformed MBs.  offA/offB are the full
    (2 * div2) slice offsets.  Returns (mapsV, mapsH, mapsVc, mapsHc)
    int32, contiguous."""
    from ..ops.deblock import build_maps
    dev = out["recon_y"].device
    rep = torch.repeat_interleave
    if intra:
        tc4 = torch.zeros(4 * mbh, 4 * mbw, dtype=torch.int32, device=dev)
        mv4 = torch.zeros(4 * mbh, 4 * mbw, 2, dtype=torch.int32, device=dev)
    else:
        quad = ((out["cbp_luma"][:, None]
                 >> (torch.arange(16, device=dev) // 4)) & 1).bool()
        lv = out["levels"] * quad[:, :, None]
        tc_blk = (lv != 0).sum(-1, dtype=torch.int32)   # (n, 16) block order
        if "t8" in out:
            # bS sees the 8x8 block's coded status on each 4x4 it covers
            tc8 = tc_blk.reshape(-1, 4, 4).sum(-1, dtype=torch.int32) \
                .repeat_interleave(4, dim=1)
            tc_blk = torch.where(out["t8"][:, None], tc8, tc_blk)
        raster = tc_blk.index_select(1, _idx(_INV16, dev))
        tc4 = (raster.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3)
               .reshape(4 * mbh, 4 * mbw))
        if "mv8" in out:
            mv4 = rep(rep(out["mv8"], 2, 0), 2, 1)
        else:
            mv4 = rep(rep(out["mv"].reshape(mbh, mbw, 2), 4, 0), 4, 1)
    intra_map = torch.full((mbh, mbw), intra, dtype=torch.bool, device=dev)
    if not intra and "ref_idx" in out:
        ref4 = rep(rep(out["ref_idx"].reshape(mbh, mbw).to(torch.int32), 4,
                       0), 4, 1)
    else:
        ref4 = torch.zeros(4 * mbh, 4 * mbw, dtype=torch.int32, device=dev)
    qp_map = (out["qp_real"].reshape(mbh, mbw) if "qp_real" in out
              else torch.full((mbh, mbw), qp, dtype=torch.int32, device=dev))
    t8_4 = (rep(rep(out["t8"].reshape(mbh, mbw), 4, 0), 4, 1)
            if not intra and "t8" in out else None)
    maps = build_maps(intra_map, tc4, mv4, ref4, qp_map, offA, offB,
                      qpc_offset, t8_4=t8_4)
    return tuple(m.contiguous() for m in maps)


def apply_loop_filter(out, qp: int, mbh: int, mbw: int, intra: bool,
                      offA: int = 0, offB: int = 0, qpc_offset: int = 0):
    """In-loop deblock (exact §8.7) of the recon planes in `out` with the
    maps of loop_filter_maps.  Returns filtered (y, u, v) int32."""
    from ..ops.kernels.deblock import deblock_apply
    maps = loop_filter_maps(out, qp, mbh, mbw, intra, offA, offB,
                            qpc_offset)
    return deblock_apply(*(out[k].contiguous()
                           for k in ("recon_y", "recon_u", "recon_v")),
                         *maps)
