"""Device-side slice finalisation: syntax tensors -> slots -> packed bytes.

Port of the I and one-reference P parts (P16x16 and the 8x8-grid
partitions) of x264vfw_tpu/encode/device_finalize.py, with the in-loop
deblock of the reference planes, and of its batched P run
(encode_pgop_slots, pack_batch) without B frames or MB-tree.
Everything between the per-MB compute and the NAL wrapper runs on the
device: MV prediction, skip-run derivation, nC context maps, CAVLC slot
generation (bitstream/cavlc_dev) and bit packing (device_pack).  The host
receives the packed payload bytes, about the size of the bitstream.

Slot layout differs from the JAX code only in slots that are always
zero-length in the ported configurations (I_NxN modes and residual,
ref_idx, transform_size_8x8_flag): the packer drops zero-length slots, so
the packed bytes are the same.

Slice-header bits are assembled on the host and passed in as slot arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import cavlc_dev as cd
from ..bitstream.mb_syntax import CBP_TO_CODE
from .device_pack import pack_slots

S = cd.SLOTS
MAX_HDR = 64  # header slot capacity

BLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
_RAS = BLK_Y * 4 + BLK_X                       # block order -> raster pos
_INV16 = np.argsort(_RAS)                      # raster pos -> block order


def _nc_from_map(tcm: torch.Tensor) -> torch.Tensor:
    """Neighbour-averaged nC from a total-coeff map (availability = frame
    edge)."""
    tA = torch.zeros_like(tcm)
    tA[:, 1:] = tcm[:, :-1]
    tB = torch.zeros_like(tcm)
    tB[1:, :] = tcm[:-1, :]
    availA = torch.zeros(tcm.shape, dtype=torch.bool, device=tcm.device)
    availA[:, 1:] = True
    availB = torch.zeros(tcm.shape, dtype=torch.bool, device=tcm.device)
    availB[1:, :] = True
    return torch.where(availA & availB, (tA + tB + 1) >> 1,
                       torch.where(availA, tA, torch.where(availB, tB, 0)))


def _nc_luma(tc_blk: torch.Tensor, mbh: int, mbw: int) -> torch.Tensor:
    """tc_blk (n, 16) block coding order -> nC (n, 16)."""
    n = mbh * mbw
    dev = tc_blk.device
    raster = tc_blk.index_select(1, torch.as_tensor(_INV16, device=dev))
    tcm = raster.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3) \
        .reshape(4 * mbh, 4 * mbw)
    nc = _nc_from_map(tcm)
    back = nc.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3).reshape(n, 16)
    return back.index_select(1, torch.as_tensor(_RAS, device=dev))


def _nc_chroma(tc_c: torch.Tensor, mbh: int, mbw: int) -> torch.Tensor:
    """tc_c (n, 4) per chroma sub-block (raster) -> nC (n, 4)."""
    n = mbh * mbw
    tcm = tc_c.reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3) \
        .reshape(2 * mbh, 2 * mbw)
    nc = _nc_from_map(tcm)
    return nc.reshape(mbh, 2, mbw, 2).permute(0, 2, 1, 3).reshape(n, 4)


def _median3(a, b, c):
    return a + b + c - torch.maximum(a, torch.maximum(b, c)) \
        - torch.minimum(a, torch.minimum(b, c))


def p16_mv_pred(mv: torch.Tensor):
    """(mbh, mbw, 2) -> (pmv, pmv_skip_is_zero): median MV prediction for
    an all-P16x16 frame with one reference (§8.4.1.3) and the P_Skip
    zero-forcing condition (§8.4.1.1)."""
    mbh, mbw, _ = mv.shape
    dev = mv.device

    def sh(arr, dy, dx):
        out = torch.zeros_like(arr)
        ys = slice(max(dy, 0), mbh + min(dy, 0))
        xs = slice(max(dx, 0), mbw + min(dx, 0))
        yd = slice(max(-dy, 0), mbh + min(-dy, 0))
        xd = slice(max(-dx, 0), mbw + min(-dx, 0))
        out[yd, xd] = arr[ys, xs]
        return out

    mvA = sh(mv, 0, -1)
    mvB = sh(mv, -1, 0)
    mvC = sh(mv, -1, 1)
    mvD = sh(mv, -1, -1)
    yy = torch.arange(mbh, device=dev)[:, None].expand(mbh, mbw)
    xx = torch.arange(mbw, device=dev)[None, :].expand(mbh, mbw)
    availA = xx > 0
    availB = yy > 0
    availC_raw = (yy > 0) & (xx < mbw - 1)
    availD = (yy > 0) & (xx > 0)
    mvC_eff = torch.where(availC_raw[..., None], mvC, mvD)
    availC = availC_raw | availD

    only_a = availA & ~availB & ~availC
    # one reference: every available neighbour has the same refIdx
    nmatch = availA.int() + availB.int() + availC.int()
    mA = torch.where(availA[..., None], mvA, 0)
    mB = torch.where(availB[..., None], mvB, 0)
    mC = torch.where(availC[..., None], mvC_eff, 0)
    med = _median3(mA, mB, mC)
    one = torch.where(availA[..., None], mvA,
                      torch.where(availB[..., None], mvB, mvC_eff))
    pmv = torch.where(only_a[..., None], mvA,
                      torch.where((nmatch == 1)[..., None], one, med))
    zeroA = availA & (mvA == 0).all(-1)
    zeroB = availB & (mvB == 0).all(-1)
    skip_cond = (~availA) | (~availB) | zeroA | zeroB
    pmv_skip = torch.where(skip_cond[..., None], 0, pmv)
    return pmv, (pmv_skip == 0).all(-1)


def _stack_rows(hdr_vals, hdr_lens, mb_vals, mb_lens, tail_vals, tail_lens):
    """The slice's slot stream as a 2D (rows, L) array: one row of header
    codes, n rows of per-MB codes, one row of tail codes; row-major order
    is the bitstream order."""
    L = mb_vals.shape[1]
    dev = mb_vals.device

    def row(v, dtype):
        r = torch.zeros(1, L, dtype=dtype, device=dev)
        r[0, :v.shape[0]] = v.to(dtype)
        return r

    return (torch.cat([row(hdr_vals, torch.int64), mb_vals,
                       row(tail_vals, torch.int64)]),
            torch.cat([row(hdr_lens, torch.int32), mb_lens,
                       row(tail_lens, torch.int32)]))


def _chroma_slots(out, n, mbh, mbw):
    """Masked chroma levels -> (vals, lens) of DC U, DC V, AC U, AC V, each
    zeroed where the chroma cbp does not code it."""
    cbp_chroma = out["cbp_chroma"]
    ac_u = out["ac_u"] * (cbp_chroma == 2)[:, None, None]
    ac_v = out["ac_v"] * (cbp_chroma == 2)[:, None, None]
    dc_u = out["dc_u"].reshape(n, 4) * (cbp_chroma >= 1)[:, None]
    dc_v = out["dc_v"].reshape(n, 4) * (cbp_chroma >= 1)[:, None]
    nc_cu = _nc_chroma((ac_u != 0).sum(-1, dtype=torch.int32), mbh, mbw)
    nc_cv = _nc_chroma((ac_v != 0).sum(-1, dtype=torch.int32), mbh, mbw)
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dc_u.device)
    vcdu, lcdu = cd.encode_blocks(dc_u, minus1, 4)
    vcdv, lcdv = cd.encode_blocks(dc_v, minus1, 4)
    has_cdc = (cbp_chroma >= 1)[:, None]
    lcdu = lcdu * has_cdc
    lcdv = lcdv * has_cdc
    vcau, lcau = cd.encode_blocks(ac_u.reshape(-1, 15), nc_cu.reshape(-1), 15)
    vcav, lcav = cd.encode_blocks(ac_v.reshape(-1, 15), nc_cv.reshape(-1), 15)
    has_cac = (cbp_chroma == 2)[:, None]
    vals = torch.cat([vcdu, vcdv, vcau.reshape(n, -1), vcav.reshape(n, -1)],
                     dim=1)
    lens = torch.cat([lcdu, lcdv, lcau.reshape(n, -1) * has_cac,
                      lcav.reshape(n, -1) * has_cac], dim=1)
    return vals, lens


def _tail(hdr_lens, mb_lens, trailing=None):
    """Trailing mb_skip_run (P) + rbsp_trailing_bits as slot arrays."""
    dev = mb_lens.device
    body_bits = hdr_lens.sum(dtype=torch.int64) + mb_lens.sum(dtype=torch.int64)
    tv = torch.zeros(1, dtype=torch.int64, device=dev)
    tl = torch.zeros(1, dtype=torch.int32, device=dev)
    if trailing is not None:
        v, ln = cd.ue_codes_dev(trailing.clamp(min=0))
        tv = v.reshape(1)
        tl = torch.where(trailing > 0, ln, 0).reshape(1)
        body_bits = body_bits + tl[0]
    pad = (-(body_bits + 1)) % 8
    return (torch.cat([tv, (torch.ones_like(pad) << pad).reshape(1)]),
            torch.cat([tl, (1 + pad).reshape(1).to(torch.int32)]))


def _mb_header_p16(out, mbh: int, mbw: int, cbp):
    """P16x16 header slots [mb_type, mvd x, mvd y] and the skip flags."""
    n = mbh * mbw
    mv = out["mv"].reshape(mbh, mbw, 2)
    pmv, skip_zero = p16_mv_pred(mv)
    mv_flat = mv.reshape(n, 2)
    skip = (cbp == 0) & (mv_flat == 0).all(dim=1) & skip_zero.reshape(n)
    mvd = mv_flat - pmv.reshape(n, 2)
    xv, xl = cd.se_codes_dev(mvd[:, 0])
    yv, yl = cd.se_codes_dev(mvd[:, 1])
    one = torch.ones(n, dtype=torch.int64, device=mv.device)
    return (torch.stack([one, xv, yv], dim=1),     # ue(P_L0_16x16 = 0) = '1'
            torch.stack([one.int(), xl, yl], dim=1), skip)


def _mb_header_parts(out, mbh: int, mbw: int, cbp):
    """Partitioned P header slots [mb_type, sub_mb_type x 4, (mvd x,
    mvd y) x 4 quadrant slots] and the skip flags.  mvd pairs go in
    quadrant raster order, which is the partitions' decode order for every
    layout; slots a layout does not use are zero-length."""
    from .inter_partition import partition_mvds
    n = mbh * mbw
    part = out["part"]
    mv8 = out["mv8"]
    mvd8, nslot, skip_zero = partition_mvds(mv8, part.reshape(mbh, mbw))
    mv00 = mv8[0::2, 0::2].reshape(n, 2)
    skip = ((cbp == 0) & (part == 0) & (mv00 == 0).all(dim=1)
            & skip_zero.reshape(n))
    mvd4 = mvd8.reshape(mbh, 2, mbw, 2, 2).permute(0, 2, 1, 3, 4) \
        .reshape(n, 4, 2)
    nsl4 = nslot.reshape(mbh, 2, mbw, 2).permute(0, 2, 1, 3).reshape(n, 4)
    tv, tl = cd.ue_codes_dev(part)
    # sub_mb_type P_L0_8x8 = ue(0) = '1', only in P_8x8 MBs
    is8 = (part == 3).int()
    vals, lens = [tv], [tl]
    vals += [torch.ones_like(tv)] * 4
    lens += [is8] * 4
    for q in range(4):
        for c in range(2):
            v, ln = cd.se_codes_dev(mvd4[:, q, c])
            vals.append(v)
            lens.append(ln * nsl4[:, q])
    return torch.stack(vals, dim=1), torch.stack(lens, dim=1), skip


def _finalize_p_core(out, hdr_vals, hdr_lens, mbh: int, mbw: int):
    """P-slice syntax tensors (one reference; P16x16, or the 8x8-grid
    partitions when `out` has 'part') -> slot rows."""
    n = mbh * mbw
    dev = out["mv"].device
    cbp_luma = out["cbp_luma"]
    cbp = cbp_luma | (out["cbp_chroma"] << 4)
    head = _mb_header_parts if "part" in out else _mb_header_p16
    tv, tl, skip = head(out, mbh, mbw, cbp)

    i = torch.arange(n, dtype=torch.int32, device=dev)
    ns = ~skip
    ns_pos = torch.where(ns, i, -1)
    prev_ns = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                         torch.cummax(ns_pos, dim=0).values[:-1]])
    runs = torch.where(ns, i - prev_ns - 1, 0)
    trailing = n - 1 - ns_pos.max()

    quad = torch.arange(16, device=dev) // 4
    quad_coded = ((cbp_luma[:, None] >> quad) & 1).bool()
    levels = out["levels"] * quad_coded[:, :, None]
    nc_l = _nc_luma((levels != 0).sum(-1, dtype=torch.int32), mbh, mbw)
    vlu, llu = cd.encode_blocks(levels.reshape(-1, 16), nc_l.reshape(-1), 16)
    llu = llu.reshape(n, 16, S) * quad_coded[:, :, None]

    # header slots: [mb_skip_run, <type and mvds>, cbp, qp_delta]
    rv, rl = cd.ue_codes_dev(runs)
    code = torch.as_tensor(CBP_TO_CODE[0], device=dev)[cbp.long()]
    bv, bl = cd.ue_codes_dev(code)
    one = torch.ones(n, dtype=torch.int64, device=dev)
    hv = torch.cat([rv[:, None], tv, torch.stack([bv, one], dim=1)], dim=1)
    hl = torch.cat([rl[:, None], tl,
                    torch.stack([bl, (cbp != 0).int()], dim=1)],  # se(0)
                   dim=1)

    cv, cl = _chroma_slots(out, n, mbh, mbw)
    mb_vals = torch.cat([hv, vlu.reshape(n, -1), cv], dim=1)
    mb_lens = torch.cat([hl, llu.reshape(n, -1), cl], dim=1)
    mb_lens = mb_lens * (~skip)[:, None]
    tail_vals, tail_lens = _tail(hdr_lens, mb_lens, trailing)
    return _stack_rows(hdr_vals, hdr_lens, mb_vals, mb_lens,
                       tail_vals, tail_lens)


def _finalize_i_core(out, hdr_vals, hdr_lens, mbh: int, mbw: int):
    """I-slice syntax tensors (all I16x16) -> slot rows."""
    n = mbh * mbw
    cbp_luma_nz = out["cbp_luma_nz"]
    cbp_chroma = out["cbp_chroma"]
    mb_type = 1 + out["i16_mode"] + 4 * cbp_chroma + 12 * cbp_luma_nz.int()

    ac = out["ac"] * cbp_luma_nz[:, None, None]
    nc_l = _nc_luma((ac != 0).sum(-1, dtype=torch.int32), mbh, mbw)
    vdc, ldc = cd.encode_blocks(out["dc"], nc_l[:, 0], 16)
    vac, lac = cd.encode_blocks(ac.reshape(-1, 15), nc_l.reshape(-1), 15)
    lac = lac.reshape(n, -1) * cbp_luma_nz[:, None]

    # header slots: [mb_type, intra_chroma_pred_mode, qp_delta se(0)]
    tv, tl = cd.ue_codes_dev(mb_type)
    cv_, cl_ = cd.ue_codes_dev(out["cmode"])
    one = torch.ones(n, dtype=torch.int64, device=tv.device)
    hv = torch.stack([tv, cv_, one], dim=1)
    hl = torch.stack([tl, cl_, one.int()], dim=1)

    cv, cl = _chroma_slots(out, n, mbh, mbw)
    mb_vals = torch.cat([hv, vdc, vac.reshape(n, -1), cv], dim=1)
    mb_lens = torch.cat([hl, ldc, lac, cl], dim=1)
    tail_vals, tail_lens = _tail(hdr_lens, mb_lens)
    return _stack_rows(hdr_vals, hdr_lens, mb_vals, mb_lens,
                       tail_vals, tail_lens)


def _unpack_src(src_yuv: torch.Tensor, H: int, W: int):
    """(H*W*3/2,) uint8 I420 upload -> int32 (y, u, v) planes."""
    ys = H * W
    cs = ys // 4
    return (src_yuv[:ys].reshape(H, W).to(torch.int32),
            src_yuv[ys:ys + cs].reshape(H // 2, W // 2).to(torch.int32),
            src_yuv[ys + cs:].reshape(H // 2, W // 2).to(torch.int32))


def _maybe_deblock(out, qp: int, mbh: int, mbw: int, intra: bool,
                   deblock: bool, dbA: int, dbB: int, qpc_offset: int):
    """The reference planes to keep: deblocked when the slice filters."""
    if not deblock:
        return out["recon_y"], out["recon_u"], out["recon_v"]
    from .device import apply_loop_filter
    return apply_loop_filter(out, qp, mbh, mbw, intra, offA=2 * dbA,
                             offB=2 * dbB, qpc_offset=qpc_offset)


def encode_i_slots_fn(H: int, W: int, deblock: bool = False, dbA: int = 0,
                      dbB: int = 0, qpc_offset: int = 0):
    """The fused I-frame phase 1 for a geometry: unpack the uint8 frame ->
    I encode -> slot rows, and the (deblocked when `deblock`) recon.  The
    returned function gives (slot_vals, slot_lens, recon_y, recon_u,
    recon_v)."""
    from .device import encode_i_frame_core

    def fn(src_yuv, qp: int, qpc: int, hdr_vals, hdr_lens):
        out = encode_i_frame_core(*_unpack_src(src_yuv, H, W), qp, qpc)
        v, l = _finalize_i_core(out, hdr_vals, hdr_lens, H // 16, W // 16)
        return (v, l, *_maybe_deblock(out, qp, H // 16, W // 16, True,
                                      deblock, dbA, dbB, qpc_offset))

    return fn


def encode_p_slots(src_yuv, ref_y, ref_u, ref_v, qp: int, qpc: int,
                   hdr_vals, hdr_lens, rng: int, subpel: int = 0,
                   me_backend: str = "auto", deblock: bool = False,
                   dbA: int = 0, dbB: int = 0, qpc_offset: int = 0,
                   partitions: bool = False):
    """Fused P-frame phase 1: unpack the uint8 frame -> P encode -> slot
    rows, and the (deblocked when `deblock`) recon.  Returns (slot_vals,
    slot_lens, recon_y, recon_u, recon_v, out): `out` holds the syntax
    tensors, among them 'mv' and, with partitions, 'part' and 'mv8'."""
    from .device import encode_p_frame_core
    H, W = ref_y.shape
    out = encode_p_frame_core(*_unpack_src(src_yuv, H, W), ref_y, ref_u,
                              ref_v, qp, qpc, rng, subpel, me_backend,
                              partitions=partitions)
    v, l = _finalize_p_core(out, hdr_vals, hdr_lens, H // 16, W // 16)
    return (v, l, *_maybe_deblock(out, qp, H // 16, W // 16, False, deblock,
                                  dbA, dbB, qpc_offset), out)


def encode_pgop_slots(frames_yuv, ref_y, ref_u, ref_v, qps, qpcs,
                      hdr_vals, hdr_lens, rng: int, subpel: int = 0,
                      me_backend: str = "auto", deblock: bool = False,
                      dbA: int = 0, dbB: int = 0, qpc_offset: int = 0,
                      partitions: bool = False):
    """Batched P-frame phase 1: the G frames of a run, each encoded
    against the (deblocked when `deblock`) recon of the one before, with
    one reference and no per-MB QP offsets.  The JAX package's lax.scan
    is a Python loop over encode_p_slots here.  It packs nothing, so no
    bit count is read back (pack_batch reads them when the run is
    materialized) and on CUDA the run stays queued while the host goes
    on.

    frames_yuv: (G, H*W*3/2) uint8; qps/qpcs: G Python ints (one QP per
    frame, as rate control chose); hdr_vals/hdr_lens: (G, MAX_HDR).
    Returns (slot_vals (G, rows, L), slot_lens (G, rows, L), recon_y,
    recon_u, recon_v of the last frame, mv (G, n, 2) quarter-pel)."""
    ref = (ref_y, ref_u, ref_v)
    vs, ls, mvs = [], [], []
    for g in range(frames_yuv.shape[0]):
        v, l, *ref, out = encode_p_slots(
            frames_yuv[g], *ref, qps[g], qpcs[g], hdr_vals[g], hdr_lens[g],
            rng, subpel, me_backend, deblock, dbA, dbB, qpc_offset,
            partitions)
        vs.append(v)
        ls.append(l)
        mvs.append(out["mv"])
    return (torch.stack(vs), torch.stack(ls), *ref, torch.stack(mvs))


def pack_batch(vs, ls):
    """Pack a (G, rows, L) slot batch: a list of G packed byte tensors and
    a list of G bit counts.  pack_slots sizes each output exactly (it
    reads each bit count to the host), so the JAX package's capacity
    bucket and overflow re-pack have no counterpart."""
    packed = [pack_slots(v, l) for v, l in zip(vs, ls)]
    return [p[0] for p in packed], [p[1] for p in packed]


def finalize_i(out, hdr_vals, hdr_lens, mbh: int, mbw: int):
    """I syntax tensors -> (packed bytes, total bits)."""
    return pack_slots(*_finalize_i_core(out, hdr_vals, hdr_lens, mbh, mbw))


def finalize_p(out, hdr_vals, hdr_lens, mbh: int, mbw: int):
    """P syntax tensors -> (packed bytes, total bits)."""
    return pack_slots(*_finalize_p_core(out, hdr_vals, hdr_lens, mbh, mbw))


def pack_phase(vals, lens):
    """Phase 2: slot rows -> (packed bytes, total bits)."""
    return pack_slots(vals, lens)
