"""Device-side slice finalisation: syntax tensors -> slots -> packed bytes.

Port of the I (I16x16 and I_NxN), P (P16x16 from one reference or from
a DPB of up to four with ref_idx, and the one-reference 8x8-grid
partitions, with transform_size_8x8_flag and mb_qp_delta) and B (16x16
modes, direct and B_Skip) parts of x264vfw_tpu/encode/device_finalize.py,
with the in-loop deblock of the reference planes, and of its batched
runs (encode_pgop_slots with MB-tree offsets, the sliding DPB and the
anchors' recons, encode_bgop_slots, pack_batch).
Everything between the per-MB compute and the NAL wrapper runs on the
device: MV prediction, skip-run derivation, nC context maps, CAVLC slot
generation (bitstream/cavlc_dev) and bit packing (device_pack).  The host
receives the packed payload bytes, about the size of the bitstream.

I and B slices have the JAX code's slot layout.  P slices differ from
it only in slots that are always zero-length where the port leaves them
out: ref_idx with one reference and, without --8x8dct,
transform_size_8x8_flag.  The packer drops zero-length slots, so the
packed bytes are the same.

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


def p16_mv_pred(mv: torch.Tensor, ref: torch.Tensor | None = None):
    """(mbh, mbw, 2)[, (mbh, mbw) ref_idx] -> (pmv, pmv_skip_is_zero):
    median MV prediction for an all-P16x16 frame (§8.4.1.3) and the P_Skip
    zero-forcing condition (§8.4.1.1).  With `ref`, the one neighbour of
    the MB's own refIdx gives its vector directly when it is the only
    such neighbour (§8.4.1.3.1; unavailable neighbours match none), and
    a neighbour forces P_Skip's vector to 0 only at refIdx 0.  Without
    it every MB is at refIdx 0."""
    mbh, mbw, _ = mv.shape
    dev = mv.device
    if ref is None:
        ref = torch.zeros(mbh, mbw, dtype=torch.int32, device=dev)
    mvA, mvB, mvC, mvD = _neighbours(mv)
    rA, rB, rC, rD = _neighbours(ref)
    yy = torch.arange(mbh, device=dev)[:, None].expand(mbh, mbw)
    xx = torch.arange(mbw, device=dev)[None, :].expand(mbh, mbw)
    availA = xx > 0
    availB = yy > 0
    availC_raw = (yy > 0) & (xx < mbw - 1)
    availD = (yy > 0) & (xx > 0)
    mvC_eff = torch.where(availC_raw[..., None], mvC, mvD)
    rC_eff = torch.where(availC_raw, rC, rD)
    availC = availC_raw | availD

    only_a = availA & ~availB & ~availC
    msk_a = availA & (rA == ref)
    msk_b = availB & (rB == ref)
    msk_c = availC & (rC_eff == ref)
    nmatch = msk_a.int() + msk_b.int() + msk_c.int()
    mA = torch.where(availA[..., None], mvA, 0)
    mB = torch.where(availB[..., None], mvB, 0)
    mC = torch.where(availC[..., None], mvC_eff, 0)
    med = _median3(mA, mB, mC)
    one = torch.where(msk_a[..., None], mvA,
                      torch.where(msk_b[..., None], mvB, mvC_eff))
    pmv = torch.where(only_a[..., None], mvA,
                      torch.where((nmatch == 1)[..., None], one, med))
    zeroA = availA & (rA == 0) & (mvA == 0).all(-1)
    zeroB = availB & (rB == 0) & (mvB == 0).all(-1)
    skip_cond = (~availA) | (~availB) | zeroA | zeroB
    pmv_skip = torch.where(skip_cond[..., None], 0, pmv)
    return pmv, (pmv_skip == 0).all(-1)


def _neighbours(a: torch.Tensor):
    """The left (A), above (B), above-right (C) and above-left (D)
    neighbour of every MB of a (mbh, mbw, ...) field, 0 off the frame."""
    def sh(dy, dx):
        out = torch.zeros_like(a)
        mbh, mbw = a.shape[:2]
        out[max(-dy, 0):mbh + min(-dy, 0), max(-dx, 0):mbw + min(-dx, 0)] = \
            a[max(dy, 0):mbh + min(dy, 0), max(dx, 0):mbw + min(dx, 0)]
        return out
    return sh(0, -1), sh(-1, 0), sh(-1, 1), sh(-1, -1)


def b_mv_pred(mv: torch.Tensor, uses: torch.Tensor) -> torch.Tensor:
    """§8.4.1.3 MV prediction for one list of a B frame with single-entry
    reference lists: a neighbour matches iff it is available and uses the
    list (refIdx 0 == refIdx 0); neighbours that do not use it give mv 0
    to the median.  C falls back to D where C is unavailable.  An MB with
    only A available (the top row) takes A's vector if A uses the list,
    else 0.  mv: (mbh, mbw, 2) the final per-MB vector of this list (0
    where the MB does not use it or is direct); uses: (mbh, mbw) bool.
    Returns pmv (mbh, mbw, 2)."""
    mbh, mbw, _ = mv.shape
    dev = mv.device
    mvA, mvB, mvC, mvD = _neighbours(mv)
    usA, usB, usC, usD = _neighbours(uses)
    yy = torch.arange(mbh, device=dev)[:, None].expand(mbh, mbw)
    xx = torch.arange(mbw, device=dev)[None, :].expand(mbh, mbw)
    availA = xx > 0
    availB = yy > 0
    availC_raw = (yy > 0) & (xx < mbw - 1)
    availC = availC_raw | ((yy > 0) & (xx > 0))
    mvC_eff = torch.where(availC_raw[..., None], mvC, mvD)
    usC_eff = torch.where(availC_raw, usC, usD)
    matchA = availA & usA
    matchB = availB & usB
    matchC = availC & usC_eff
    mA = torch.where(matchA[..., None], mvA, 0)
    mB = torch.where(matchB[..., None], mvB, 0)
    mC = torch.where(matchC[..., None], mvC_eff, 0)
    nmatch = matchA.int() + matchB.int() + matchC.int()
    only_a = availA & ~availB & ~availC       # MB-level availability
    return torch.where(only_a[..., None], mA,
                       torch.where((nmatch == 1)[..., None], mA + mB + mC,
                                   _median3(mA, mB, mC)))


def colocated_mv(out, n: int) -> torch.Tensor:
    """The colocated motion field a P anchor hands to the B frames before
    it (spatial direct's colZeroFlag, §8.4.1.2.2): (n, 2), per MB its
    vector, or with partitions the per-component max |mv| over its 8x8
    quadrants (the P core's 'mv'), so the B core's |mv| <= 1 test stays
    a conservative colZeroFlag.  colZeroFlag also needs refIdxCol 0, so
    an MB predicted from ref_idx > 0 reports the vector (4096, 4096),
    which is never colZero."""
    mv = out["mv"].reshape(n, 2)
    if "ref_idx" in out:
        mv = torch.where((out["ref_idx"].reshape(n) != 0)[:, None],
                         1 << 12, mv).to(mv.dtype)
    return mv


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
    body_bits = hdr_lens.sum(dtype=torch.int64) + mb_lens.sum(dtype=torch.int64)
    tv, tl = [], []
    if trailing is not None:
        v, ln = cd.ue_codes_dev(trailing.clamp(min=0))
        tv.append(v.reshape(1))
        tl.append(torch.where(trailing > 0, ln, 0).reshape(1))
        body_bits = body_bits + tl[0][0]
    pad = (-(body_bits + 1)) % 8
    return (torch.cat(tv + [(torch.ones_like(pad) << pad).reshape(1)]),
            torch.cat(tl + [(1 + pad).reshape(1).to(torch.int32)]))


def _mb_header_p16(out, mbh: int, mbw: int, cbp, nref: int = 1):
    """P16x16 header slots [mb_type, (ref_idx_l0), mvd x, mvd y] and the
    skip flags.  With 'ref_idx' in `out`, P_Skip needs refIdx 0 and the
    prediction reads the neighbours' refIdx (p16_mv_pred); the ref_idx
    slot is there when nref > 1: te(v), one bit !ref_idx at nref 2, else
    ue(v)."""
    n = mbh * mbw
    mv = out["mv"].reshape(mbh, mbw, 2)
    ref = out.get("ref_idx")
    pmv, skip_zero = p16_mv_pred(
        mv, None if ref is None else ref.reshape(mbh, mbw))
    mv_flat = mv.reshape(n, 2)
    skip = (cbp == 0) & (mv_flat == 0).all(dim=1) & skip_zero.reshape(n)
    if ref is not None:
        skip = skip & (ref.reshape(n) == 0)         # P_Skip is refIdx 0
    mvd = mv_flat - pmv.reshape(n, 2)
    xv, xl = cd.se_codes_dev(mvd[:, 0])
    yv, yl = cd.se_codes_dev(mvd[:, 1])
    one = torch.ones(n, dtype=torch.int64, device=mv.device)
    vals, lens = [one], [one.int()]                 # ue(P_L0_16x16 = 0) = '1'
    if nref > 1 and ref is not None:
        ref = ref.reshape(n)
        if nref == 2:
            vals.append((1 - ref).to(torch.int64))
            lens.append(one.int())
        else:
            rv, rl = cd.ue_codes_dev(ref)
            vals.append(rv)
            lens.append(rl.int())
    return (torch.stack(vals + [xv, yv], dim=1),
            torch.stack(lens + [xl, yl], dim=1), skip)


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


def _finalize_p_core(out, hdr_vals, hdr_lens, mbh: int, mbw: int,
                     t8_mode: bool = False, nref: int = 1):
    """P-slice syntax tensors (P16x16, with 'ref_idx' from nref
    references; or the one-reference 8x8-grid partitions when `out` has
    'part') -> slot rows.  t8_mode: the PPS
    enables the 8x8 transform, so every MB with luma cbp codes
    transform_size_8x8_flag ('t8', 0 where `out` has none); 'qp_delta' in
    `out` gives the MBs with a coded residual their se(mb_qp_delta)."""
    n = mbh * mbw
    dev = out["mv"].device
    cbp_luma = out["cbp_luma"]
    cbp = cbp_luma | (out["cbp_chroma"] << 4)
    if "part" in out:
        tv, tl, skip = _mb_header_parts(out, mbh, mbw, cbp)
    else:
        tv, tl, skip = _mb_header_p16(out, mbh, mbw, cbp, nref)

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

    # header slots: [mb_skip_run, <type and mvds>, cbp, (t8), qp_delta]
    rv, rl = cd.ue_codes_dev(runs)
    code = torch.as_tensor(CBP_TO_CODE[0], device=dev)[cbp.long()]
    bv, bl = cd.ue_codes_dev(code)
    vals, lens = [rv[:, None], tv, bv[:, None]], [rl[:, None], tl,
                                                  bl[:, None]]
    if t8_mode or "t8" in out:
        # transform_size_8x8_flag (§7.3.5), coded when luma cbp != 0
        t8 = out.get("t8", torch.zeros(n, dtype=torch.bool, device=dev))
        vals.append(t8.to(torch.int64)[:, None])
        lens.append((cbp_luma != 0).int()[:, None])
    if "qp_delta" in out:                       # per-MB AQ
        qv, ql = cd.se_codes_dev(out["qp_delta"])
    else:                                       # se(0)
        qv, ql = torch.ones(n, dtype=torch.int64, device=dev), 1
    vals.append(qv[:, None])
    lens.append((ql * (cbp != 0)).int()[:, None])
    hv = torch.cat(vals, dim=1)
    hl = torch.cat(lens, dim=1)

    cv, cl = _chroma_slots(out, n, mbh, mbw)
    mb_vals = torch.cat([hv, vlu.reshape(n, -1), cv], dim=1)
    mb_lens = torch.cat([hl, llu.reshape(n, -1), cl], dim=1)
    mb_lens = mb_lens * (~skip)[:, None]
    tail_vals, tail_lens = _tail(hdr_lens, mb_lens, trailing)
    return _stack_rows(hdr_vals, hdr_lens, mb_vals, mb_lens,
                       tail_vals, tail_lens)


def _finalize_b_core(out, hdr_vals, hdr_lens, mbh: int, mbw: int,
                     t8_mode: bool = False):
    """B-slice syntax tensors -> slot rows, in the JAX code's layout.
    mode: 0 = B_Direct_16x16, 1 = B_L0_16x16, 2 = B_L1_16x16, 3 =
    B_Bi_16x16, which are also the mb_type values (Table 7-14); direct
    MBs with cbp 0 fold into mb_skip_run (B_Skip).  Header slots per MB:
    [mb_skip_run, mb_type, mvd L0 x, y, mvd L1 x, y, coded_block_pattern,
    transform_size_8x8_flag (t8_mode, luma cbp != 0), mb_qp_delta se(0)
    (cbp != 0)], then the luma blocks and chroma."""
    n = mbh * mbw
    dev = out["mode"].device
    mode = out["mode"]
    cbp_luma = out["cbp_luma"]
    cbp = cbp_luma | (out["cbp_chroma"] << 4)

    # the final per-list fields the decoder sees: direct MBs use the lists
    # of their flavour at mv 0 (device._direct_flip_mask guarantees it)
    has0 = (mode == 1) | (mode == 3)
    has1 = (mode == 2) | (mode == 3)
    mvL0 = out["mv0"] * has0[:, None]
    mvL1 = out["mv1"] * has1[:, None]
    mvd0 = mvL0 - b_mv_pred(mvL0.reshape(mbh, mbw, 2),
                            out["uses0"].reshape(mbh, mbw)).reshape(n, 2)
    mvd1 = mvL1 - b_mv_pred(mvL1.reshape(mbh, mbw, 2),
                            out["uses1"].reshape(mbh, mbw)).reshape(n, 2)

    skip = (mode == 0) & (cbp == 0)
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

    rv, rl = cd.ue_codes_dev(runs)
    tv, tl = cd.ue_codes_dev(mode)
    vals, lens = [rv, tv], [rl, tl]
    for mvd, hasl in ((mvd0, has0), (mvd1, has1)):
        for c in range(2):
            v, ln = cd.se_codes_dev(mvd[:, c])
            vals.append(v)
            lens.append(ln * hasl)
    code = torch.as_tensor(CBP_TO_CODE[0], device=dev)[cbp.long()]
    bv, bl = cd.ue_codes_dev(code)
    vals.append(bv)
    lens.append(bl)
    t8 = out.get("t8", torch.zeros(n, dtype=torch.bool, device=dev))
    vals.append(t8.to(torch.int64) if t8_mode else torch.zeros_like(rv))
    lens.append((cbp_luma != 0).int() * int(t8_mode))
    vals.append(torch.ones_like(rv))
    lens.append((cbp != 0).int())
    hv = torch.stack(vals, dim=1)
    hl = torch.stack([ln.to(torch.int32) for ln in lens], dim=1)

    cv, cl = _chroma_slots(out, n, mbh, mbw)
    mb_vals = torch.cat([hv, vlu.reshape(n, -1), cv], dim=1)
    mb_lens = torch.cat([hl, llu.reshape(n, -1), cl], dim=1)
    mb_lens = mb_lens * (~skip)[:, None]
    tail_vals, tail_lens = _tail(hdr_lens, mb_lens, trailing)
    return _stack_rows(hdr_vals, hdr_lens, mb_vals, mb_lens,
                       tail_vals, tail_lens)


def _finalize_i_core(out, hdr_vals, hdr_lens, mbh: int, mbw: int,
                     t8_mode: bool = False):
    """I-slice syntax tensors -> slot rows, mixed I16x16 / I_NxN (all
    I16x16 when `out` has no 'use_i4'), in the JAX code's layout: header
    [mb_type, transform_size_8x8_flag, 16 x intra 4x4 pred mode,
    intra_chroma_pred_mode, coded_block_pattern, mb_qp_delta], then the
    I16 DC and AC blocks, the I_NxN 16-coefficient blocks and chroma.
    nC reads one total-coeff map over both MB types (§9.2.1: I_NxN
    blocks count all 16 coefficients, I16 blocks their 15 AC ones).
    t8_mode: the PPS enables the 8x8 transform, so I_NxN MBs code
    transform_size_8x8_flag (0: no Intra 8x8)."""
    n = mbh * mbw
    dev = out["dc"].device
    if "use_i4" in out:
        use_i4, levels4, cbp4 = out["use_i4"], out["levels4"], out["cbp_luma4"]
        prev, rem = out["i4_prev"], out["i4_rem"]
    else:
        use_i4 = torch.zeros(n, dtype=torch.bool, device=dev)
        levels4 = torch.zeros(n, 16, 16, dtype=torch.int32, device=dev)
        cbp4 = torch.zeros(n, dtype=torch.int32, device=dev)
        prev = torch.zeros(n, 16, dtype=torch.bool, device=dev)
        rem = torch.zeros(n, 16, dtype=torch.int32, device=dev)
    cbp_luma_nz = out["cbp_luma_nz"]
    cbp_chroma = out["cbp_chroma"]
    i16 = ~use_i4
    mb_type = torch.where(use_i4, 0, 1 + out["i16_mode"] + 4 * cbp_chroma
                          + 12 * cbp_luma_nz.int())

    ac = out["ac"] * (cbp_luma_nz & i16)[:, None, None]
    tc_blk = torch.where(use_i4[:, None],
                         (levels4 != 0).sum(-1, dtype=torch.int32),
                         (ac != 0).sum(-1, dtype=torch.int32))
    nc_l = _nc_luma(tc_blk, mbh, mbw)
    vdc, ldc = cd.encode_blocks(out["dc"], nc_l[:, 0], 16)
    ldc = ldc * i16[:, None]
    vac, lac = cd.encode_blocks(ac.reshape(-1, 15), nc_l.reshape(-1), 15)
    lac = lac.reshape(n, 16, S) * (cbp_luma_nz & i16)[:, None, None]
    # I_NxN luma: 16-coefficient blocks, coded when the quadrant's cbp
    # bit is set
    vl4, ll4 = cd.encode_blocks(levels4.reshape(-1, 16), nc_l.reshape(-1),
                                16)
    quad4 = ((cbp4[:, None] >> (torch.arange(16, device=dev) // 4)) & 1) \
        .bool()
    ll4 = ll4.reshape(n, 16, S) * (use_i4[:, None] & quad4)[:, :, None]

    i4 = use_i4.int()
    tv, tl = cd.ue_codes_dev(mb_type)
    pmv = torch.where(prev, 1, rem).to(torch.int64)
    pml = torch.where(prev, 1, 4) * i4[:, None]
    cv_, cl_ = cd.ue_codes_dev(out["cmode"])
    code = torch.as_tensor(CBP_TO_CODE[1], device=dev)[
        (cbp4 | (cbp_chroma << 4)).long()]
    bv, bl = cd.ue_codes_dev(code)
    qpd_on = (i16 | (cbp4 != 0) | (cbp_chroma != 0)).int()
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    one = torch.ones_like(zero)
    hv = torch.cat([tv[:, None], zero[:, None], pmv,
                    torch.stack([cv_, bv, one], dim=1)], dim=1)
    hl = torch.cat([tl[:, None], (i4 if t8_mode else 0 * i4)[:, None],
                    pml.int(), torch.stack([cl_, bl * i4, qpd_on], dim=1)],
                   dim=1)

    cv, cl = _chroma_slots(out, n, mbh, mbw)
    mb_vals = torch.cat([hv, vdc, vac.reshape(n, -1), vl4.reshape(n, -1), cv],
                        dim=1)
    mb_lens = torch.cat([hl, ldc, lac.reshape(n, -1), ll4.reshape(n, -1), cl],
                        dim=1)
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
                      dbB: int = 0, qpc_offset: int = 0, i4x4: bool = False,
                      dct8x8: bool = False):
    """The fused I-frame phase 1 for a geometry: unpack the uint8 frame ->
    I encode (with the I_NxN candidate when i4x4) -> slot rows, and the
    (deblocked when `deblock`) recon.  dct8x8: the PPS enables the 8x8
    transform (I_NxN MBs code transform_size_8x8_flag = 0).  The returned
    function gives (slot_vals, slot_lens, recon_y, recon_u, recon_v)."""
    from .device import encode_i_frame_core

    def fn(src_yuv, qp: int, qpc: int, hdr_vals, hdr_lens):
        out = encode_i_frame_core(*_unpack_src(src_yuv, H, W), qp, qpc,
                                  i4x4)
        v, l = _finalize_i_core(out, hdr_vals, hdr_lens, H // 16, W // 16,
                                t8_mode=dct8x8)
        return (v, l, *_maybe_deblock(out, qp, H // 16, W // 16, True,
                                      deblock, dbA, dbB, qpc_offset))

    return fn


def encode_p_slots(src_yuv, ref_y, ref_u, ref_v, qp: int, qpc: int,
                   hdr_vals, hdr_lens, rng: int, subpel: int = 0,
                   me_backend: str = "auto", deblock: bool = False,
                   dbA: int = 0, dbB: int = 0, qpc_offset: int = 0,
                   partitions: bool = False, aq_strength: float = 0.0,
                   wp=None, dct8x8: bool = False, qp_off=None,
                   trellis: bool = False):
    """Fused P-frame phase 1: unpack the uint8 frame -> P encode (with AQ,
    MB-tree's per-MB QP offsets qp_off, weighted prediction, the 8x8
    transform decision and trellis when asked; over R references when
    the reference planes are stacked (R, H, W) in ref_idx order) -> slot
    rows, and the (deblocked when `deblock`) recon.  Returns (slot_vals,
    slot_lens, recon_y, recon_u, recon_v, out): `out` holds the syntax
    tensors, among them 'mv', with several references 'ref_idx' and with
    partitions 'part' and 'mv8'."""
    from .device import encode_p_frame_core
    H, W = ref_y.shape[-2:]
    out = encode_p_frame_core(*_unpack_src(src_yuv, H, W), ref_y, ref_u,
                              ref_v, qp, qpc, rng, subpel, me_backend,
                              partitions=partitions, aq_strength=aq_strength,
                              qpc_offset=qpc_offset, wp=wp, dct8x8=dct8x8,
                              qp_off=qp_off, trellis=trellis)
    v, l = _finalize_p_core(out, hdr_vals, hdr_lens, H // 16, W // 16,
                            t8_mode=dct8x8,
                            nref=ref_y.shape[0] if ref_y.dim() == 3 else 1)
    return (v, l, *_maybe_deblock(out, qp, H // 16, W // 16, False, deblock,
                                  dbA, dbB, qpc_offset), out)


def encode_pgop_slots(frames_yuv, ref_y, ref_u, ref_v, qps, qpcs,
                      hdr_vals, hdr_lens, rng: int, subpel: int = 0,
                      me_backend: str = "auto", deblock: bool = False,
                      dbA: int = 0, dbB: int = 0, qpc_offset: int = 0,
                      partitions: bool = False, aq_strength: float = 0.0,
                      dct8x8: bool = False, qp_offs=None,
                      want_recons: bool = False, trellis: bool = False):
    """Batched P-frame phase 1: the G frames of a run, each encoded
    against the (deblocked when `deblock`) recon of the one before, or,
    with reference planes stacked (R, H, W), against a sliding DPB of R
    references in which each frame's recon enters at ref_idx 0 and the
    oldest leaves; without weighted prediction (as in the JAX package:
    its batched P program takes no weights).  The JAX package's lax.scan
    is a Python loop over encode_p_slots here.  It packs nothing, so no
    bit count is read back (pack_batch reads them when the run is
    materialized) and on CUDA the run stays queued while the host goes
    on.

    frames_yuv: (G, H*W*3/2) uint8; qps/qpcs: G Python ints (one QP per
    frame, as rate control chose); hdr_vals/hdr_lens: (G, MAX_HDR);
    qp_offs: None or (G, n) int32 per-MB QP offsets (MB-tree).
    Returns (slot_vals (G, rows, L), slot_lens (G, rows, L), recon_y,
    recon_u, recon_v of the last frame (with stacked references the final
    DPB, stacked), mv (G, n, 2) the colocated fields (colocated_mv)) and,
    with want_recons, a list of G (y, u, v) uint8 recons, the references
    of the B frames around these anchors."""
    ref = (ref_y, ref_u, ref_v)
    multi = ref_y.dim() == 3
    vs, ls, mvs, recons = [], [], [], []
    H, W = ref_y.shape[-2:]
    n = (H // 16) * (W // 16)
    for g in range(frames_yuv.shape[0]):
        v, l, *rec, out = encode_p_slots(
            frames_yuv[g], *ref, qps[g], qpcs[g], hdr_vals[g], hdr_lens[g],
            rng, subpel, me_backend, deblock, dbA, dbB, qpc_offset,
            partitions, aq_strength, dct8x8=dct8x8,
            qp_off=None if qp_offs is None else qp_offs[g], trellis=trellis)
        # the newest recon enters the DPB at ref_idx 0
        ref = (tuple(torch.cat([r[None], old[:-1]]) for r, old in
                     zip(rec, ref)) if multi else rec)
        vs.append(v)
        ls.append(l)
        mvs.append(colocated_mv(out, n))
        if want_recons:
            recons.append(tuple(p.to(torch.uint8) for p in rec))
    res = (torch.stack(vs), torch.stack(ls), *ref, torch.stack(mvs))
    return res + (recons,) if want_recons else res


def encode_b_slots(src_yuv, ref0_y, ref0_u, ref0_v, ref1_y, ref1_u, ref1_v,
                   mvcol, qp: int, qpc: int, hdr_vals, hdr_lens, rng: int,
                   subpel: int = 0, me_backend: str = "auto",
                   dct8x8: bool = False):
    """Fused B-frame phase 1: unpack the uint8 frame -> B encode between
    the two anchors (any integer dtype, the values 0..255) -> slot rows.
    mvcol: (n, 2) the later anchor's colocated field.  B frames are
    non-reference: no recon.  As in the JAX package, whose B programs take
    no trellis, they are quantised without it.  Returns (slot_vals,
    slot_lens)."""
    from .device import encode_b_frame_core
    H, W = ref0_y.shape
    refs = [p.to(torch.int32) for p in (ref0_y, ref0_u, ref0_v, ref1_y,
                                        ref1_u, ref1_v)]
    out = encode_b_frame_core(*_unpack_src(src_yuv, H, W), *refs, mvcol, qp,
                              qpc, rng, subpel, me_backend, dct8x8=dct8x8)
    return _finalize_b_core(out, hdr_vals, hdr_lens, H // 16, W // 16,
                            t8_mode=dct8x8)


def encode_bgop_slots(rows, refs0, refs1, mvcols, qps, qpcs, hdr_vals,
                      hdr_lens, rng: int, subpel: int = 0,
                      me_backend: str = "auto", dct8x8: bool = False):
    """Batched B-frame phase 1: Gb B frames, which do not depend on each
    other.  The JAX package's lax.scan (there to bound peak memory) is a
    Python loop over encode_b_slots here; nothing is read back.

    rows: (Gb, H*W*3/2) uint8; refs0/refs1: Gb (y, u, v) reference tuples
    (the anchors' recons); mvcols: Gb (n, 2) colocated fields of the later
    anchors; qps/qpcs: Gb ints; hdr_vals/hdr_lens: (Gb, MAX_HDR).
    Returns (slot_vals (Gb, rows, L), slot_lens (Gb, rows, L))."""
    vs, ls = [], []
    for g in range(rows.shape[0]):
        v, l = encode_b_slots(rows[g], *refs0[g], *refs1[g], mvcols[g],
                              qps[g], qpcs[g], hdr_vals[g], hdr_lens[g],
                              rng, subpel, me_backend, dct8x8)
        vs.append(v)
        ls.append(l)
    return torch.stack(vs), torch.stack(ls)


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
