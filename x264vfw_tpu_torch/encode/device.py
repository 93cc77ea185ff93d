"""Device encode pipeline (PyTorch): layout helpers, residual pipelines,
integer-pel motion search + motion compensation, and the I / P cores.

Port of x264vfw_tpu/encode/device.py for the slices this package carries:
I16x16 with chroma intra; P with one reference found by exhaustive
search, either P16x16 at integer-pel precision (`subpel=0`) or the 8x8-grid
partitions with half/quarter-pel refinement (encode/inter_partition.py);
and the in-loop deblock of the reconstruction.  Every function is
batched over macroblocks; sample arithmetic is int32, as in the JAX code.
The outputs are the same syntax tensors (levels in zigzag + block coding
order, CBPs, MVs, modes) and recon planes, bit for bit.

Where the JAX code aligns the reference with masked static shifts (a TPU
cannot gather), the port gathers each MB's prediction at its own motion
vector: the prediction planes are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import transform as tj
from ..ops.kernels.sad import sad16_argmin
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


def _motion_search_and_mc(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                          rng: int, subpel: int = 0,
                          me_backend: str = "auto"):
    """Exhaustive integer-pel SAD search + luma/chroma MC.

    The search is sad16_argmin (the CUDA kernel on the card, its plain
    version on the CPU): cost = 4*SAD16 + (|dy|+|dx|), ties to the
    smallest offset id.  Returns (mv_q (mbh, mbw, 2) quarter-pel [x, y],
    pred_y (H, W), pred_u, pred_v) int32."""
    if me_backend.endswith(":hier"):
        raise NotImplementedError(
            "hierarchical motion search (--me dia/hex/umh) is not ported "
            "yet (ROADMAP.md, queue A)")
    if subpel:
        raise NotImplementedError(
            "half/quarter-pel refinement (--subme > 0) is not ported yet "
            "(ROADMAP.md, queue A)")
    H, W = src_y.shape
    K = 2 * rng + 1
    ref_pad = _edge_pad(ref_y, rng).to(torch.uint8)
    best = sad16_argmin(src_y.to(torch.uint8).contiguous(),
                        ref_pad.contiguous(), rng)
    dyb = torch.div(best, K, rounding_mode="floor") - rng
    dxb = best % K - rng
    mv_q = torch.stack([dxb, dyb], dim=-1).to(torch.int32) * 4

    # luma MC: the reference sample at (y + dy, x + dx), edge-clamped
    ys = torch.arange(H, device=src_y.device)[:, None] + _per_pixel(dyb, 16)
    xs = torch.arange(W, device=src_y.device)[None, :] + _per_pixel(dxb, 16)
    pred_y = ref_y[ys.clamp(0, H - 1), xs.clamp(0, W - 1)].to(torch.int32)

    return (mv_q, pred_y, *_chroma_mc(mv_q, ref_u, ref_v, 8))


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


def _luma_residual_pipeline(src_mbs, pred_mbs, qp: int, intra: bool,
                            decimate: bool = False):
    """fdct + quant + zigzag and the decoder-exact recon residual.

    decimate (inter only): zero a whole MB's luma residual when its summed
    decimate score is < 6 (x264's default dct-decimate).
    Returns (levels_zz (n, 16, 16), recon_res (n, 16, 16))."""
    blocks = mb_to_blocks(src_mbs - pred_mbs)
    q = tj.quant4x4(tj.fdct4x4(blocks), qp, intra=intra)
    levels = zigzag16(q)                            # (n, 16, 16)
    if decimate and not intra:
        keep = _decimate_score(levels).sum(dim=-1) >= 6      # (n,)
        levels = levels * keep[:, None, None]
        q = q * keep[:, None, None, None]
    res = blocks_to_mb(tj.idct4x4_core(tj.dequant4x4(q, qp)))
    return levels, res


def _chroma_residual_pipeline(src_c8, pred_c8, qpc: int, intra: bool):
    """Chroma 8x8: DC Hadamard + AC.  Returns (dc_levels (n, 2, 2),
    ac_levels (n, 4, 15))."""
    coef = tj.fdct4x4(c8_to_blocks(src_c8 - pred_c8))       # (n, 4, 4, 4)
    dc = coef[:, :, 0, 0].reshape(-1, 2, 2)
    dc_lv = tj.chroma_dc_fwd_quant(dc, qpc, intra=intra)
    q = tj.quant4x4(coef, qpc, intra=intra)
    q[:, :, 0, 0] = 0
    return dc_lv, zigzag16(q)[:, :, 1:]


def _chroma_recon(pred_c8, dc_lv, ac_lv, qpc: int, use_dc, use_ac):
    """Decoder-exact chroma recon with cbp masking.  use_dc/use_ac: (n,)."""
    n = pred_c8.shape[0]
    dc_lv = dc_lv * use_dc[:, None, None]
    ac_lv = ac_lv * use_ac[:, None, None]
    dc_rec = tj.chroma_dc_dequant(dc_lv, qpc)       # (n, 2, 2)
    full = torch.cat([ac_lv.new_zeros(n, 4, 1), ac_lv], dim=-1)
    d = tj.dequant4x4(tj.zigzag_unscan(full), qpc)
    d[:, :, 0, 0] = dc_rec.reshape(n, 4)            # raster sb order
    rec = pred_c8 + blocks_to_c8(tj.idct4x4_core(d))
    return rec.clamp(0, 255)


def encode_p_frame_core(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                        qp: int, qpc: int, rng: int = 8, subpel: int = 0,
                        me_backend: str = "auto", decimate: bool = True,
                        partitions: bool = False):
    """P-frame encode, one reference: P16x16, or with `partitions` the
    16x16/16x8/8x16/8x8 decision on the 8x8 grid (adds 'part' (n,) and
    'mv8' (2mbh, 2mbw, 2) to the outputs).  All planes int32 at MB-
    multiple size.  Returns syntax tensors + recon planes (pre-deblock)."""
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    n = mbh * mbw
    src_mbs = mbize(src_y)
    part = mv8 = None
    if partitions:
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

    pred = mbize(pred_y_pl)
    levels, recon_res = _luma_residual_pipeline(
        src_mbs, pred, qp, intra=False, decimate=decimate)

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
    use_dc = cbp_chroma >= 1
    use_ac = cbp_chroma == 2
    rec_u = _chroma_recon(pred_u, dc_u, ac_u, qpc, use_dc, use_ac)
    rec_v = _chroma_recon(pred_v, dc_v, ac_v, qpc, use_dc, use_ac)
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
    if part is not None:
        out["part"] = part.reshape(n)
        out["mv8"] = mv8
    return out


# --------------------------------------------------------------------------
# I-frame pipeline
# --------------------------------------------------------------------------

def encode_i_frame_core(src_y, src_u, src_v, qp: int, qpc: int):
    """I-frame encode: anti-diagonal wavefront with full per-MB
    Intra_16x16 (V/H/DC/Plane) and chroma (DC/H/V/Plane) mode decision
    under exact reconstruction feedback (see intra_wavefront).

    Returns syntax tensors + recon planes + per-MB 'i16_mode'/'cmode'."""
    from .intra_wavefront import encode_i_frame_core_wf
    return encode_i_frame_core_wf(src_y, src_u, src_v, qp, qpc)


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
    tensors: per-4x4 total_coeff of the cbp-masked levels, the motion
    field broadcast to 4x4 blocks (mv8 where the frame has partitions), an
    all-intra or all-inter frame, one reference, a constant QP.  offA/offB
    are the full (2 * div2) slice offsets.  Returns (mapsV, mapsH, mapsVc,
    mapsHc) int32, contiguous."""
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
        raster = tc_blk.index_select(1, _idx(_INV16, dev))
        tc4 = (raster.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3)
               .reshape(4 * mbh, 4 * mbw))
        if "mv8" in out:
            mv4 = rep(rep(out["mv8"], 2, 0), 2, 1)
        else:
            mv4 = rep(rep(out["mv"].reshape(mbh, mbw, 2), 4, 0), 4, 1)
    intra_map = torch.full((mbh, mbw), intra, dtype=torch.bool, device=dev)
    ref4 = torch.zeros(4 * mbh, 4 * mbw, dtype=torch.int32, device=dev)
    qp_map = torch.full((mbh, mbw), qp, dtype=torch.int32, device=dev)
    maps = build_maps(intra_map, tc4, mv4, ref4, qp_map, offA, offB,
                      qpc_offset)
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
