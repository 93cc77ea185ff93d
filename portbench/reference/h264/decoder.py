# Frozen copy of x264vfw_tpu_torch/decode/decoder.py at commit 4a379f6, the benchmark's
# reference decoder: its imports are rewritten to this folder, the device
# route (use_device) is taken out, and deblock_frame comes from
# deblock_fast (deblock_np's filter over diagonals of MBs, held equal to
# it by tests/test_portbench_reference.py); nothing else is changed.
"""Native H.264 decoder: the host route (numpy) and the entry to the
device route.

Port of x264vfw_tpu/decode/decoder.py.  This is the framework's decode
path (the capability the reference gets from FFmpeg's H.264 decoder,
reference codec.c:2000-2296) and the conformance oracle for the encoder:
the encoder's reconstruction must equal what this decoder gives, and the
JAX package pins its copy of this decoder to stock FFmpeg on real x264
streams (tests/test_decoder_vs_ffmpeg.py).  The port's copy is held to
the JAX package's on the CPU (tests/test_torch_decode_host.py).

The host route (_SliceDecoder) decodes everything: CAVLC and CABAC, I, P
and B slices with spatial and temporal direct, weighted prediction,
multi-slice pictures, I_PCM, the 8x8 transform, MMCO and long-term
references.  With use_device=True, each slice that
device_decode.parse_slice_syntax accepts (CAVLC I or P, one slice, ...)
is parsed in C on the host and reconstructed on the decoder's device
(decode/device_decode.py); every other slice takes the host route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cavlc import decode_residual_block
from .mb_syntax import (
    CBP_FROM_CODE,
    I_NXN,
    I_PCM,
    P_8X8,
    P_8X8REF0,
    P_L0_16X16,
    P_L0_L0_16X8,
    P_L0_L0_8X16,
    parse_i16x16_mb_type,
)
from .nal import NAL_PPS, NAL_SLICE, NAL_SLICE_IDR, NAL_SPS, split_annexb
from .params import PPS, SPS
from .slice import SliceHeader
from . import intra_np as ipred
from . import transform_np as tnp
from .deblock_fast import deblock_frame
from .mc_np import chroma_mc, luma_mc
from .bitstream import BitReader

# luma 4x4 block index -> (bx, by) in 4-pel units (§6.4.3 inverse scan)
BLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
# raster (by*4+bx) -> block index
RASTER_TO_BLK = np.zeros(16, dtype=np.int64)
for _i in range(16):
    RASTER_TO_BLK[BLK_Y[_i] * 4 + BLK_X[_i]] = _i


@dataclass(eq=False)
class Frame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    frame_num: int = 0
    poc: int = 0
    is_ref: bool = False
    is_idr: bool = False
    # per-MB debug info
    mb_types: np.ndarray | None = None
    qps: np.ndarray | None = None
    mvs: np.ndarray | None = None  # (mbh*4, mbw*4, 2) per 4x4 block
    refs: np.ndarray | None = None
    # list-1 motion + per-block reference-picture identity (temporal direct
    # §8.4.1.2.3 reads the colocated picture's motion and maps its
    # references into the current lists by picture identity)
    mvs1: np.ndarray | None = None
    refs1: np.ndarray | None = None
    refid0: np.ndarray | None = None    # (mbh*4, mbw*4) id-key or -1
    refid1: np.ndarray | None = None
    # reference marking (§8.2.5): short-term by default, long-term when an
    # MMCO op / IDR long_term_reference_flag marks it
    long_term: bool = False
    lt_idx: int = 0

    def crop(self, w: int, h: int) -> "Frame":
        f = Frame(self.y[:h, :w], self.u[:h // 2, :w // 2],
                  self.v[:h // 2, :w // 2], self.frame_num, self.poc,
                  self.is_ref, self.is_idr, self.mb_types, self.qps,
                  self.mvs, self.refs, self.mvs1, self.refs1,
                  self.refid0, self.refid1, self.long_term, self.lt_idx)
        f.syntax = getattr(self, "syntax", None)
        return f


class H264Decoder:
    """Stateful Annex-B decoder."""

    def __init__(self) -> None:
        self.sps: dict[int, SPS] = {}
        self.pps: dict[int, PPS] = {}
        self.dpb: list[Frame] = []   # short-term refs, most recent first
        self.dpb_lt: list[Frame] = []  # long-term refs, LongTermFrameIdx asc
        self.frames: list[Frame] = []
        # POC (type 0) decoding state, §8.2.1.1
        self._prev_poc_msb = 0
        self._prev_poc_lsb = 0
        self._idr_epoch = 0
        # in-flight picture (multi-slice assembly): finished when all MBs
        # are decoded or a new picture starts
        self._cur: _SliceDecoder | None = None
        self._cur_info: tuple | None = None
    # ------------------------------------------------------------------ API
    def decode(self, annexb: bytes) -> list[Frame]:
        """Decode a complete Annex-B stream; returns frames in decode order."""
        for nal in split_annexb(annexb):
            if nal.nal_unit_type == NAL_SPS:
                s = SPS.from_rbsp(nal.rbsp)
                self.sps[s.seq_parameter_set_id] = s
            elif nal.nal_unit_type == NAL_PPS:
                p = PPS.from_rbsp(nal.rbsp)
                self.pps[p.pic_parameter_set_id] = p
            elif nal.nal_unit_type in (NAL_SLICE, NAL_SLICE_IDR):
                self._decode_slice(nal.rbsp, nal.nal_unit_type, nal.nal_ref_idc)
            # SEI/AUD/filler ignored
        self._finish_picture()
        return self.frames

    def display_order(self) -> list[Frame]:
        """Decoded frames reordered for output (IDR epoch, then POC) —
        the output-order role FFmpeg plays in the reference decode path."""
        return sorted(self.frames,
                      key=lambda f: (getattr(f, "idr_epoch", 0), f.poc))

    # -------------------------------------------------------------- slices
    def _compute_poc(self, sps: SPS, h: SliceHeader, nal_type: int,
                     nal_ref_idc: int) -> int:
        if sps.pic_order_cnt_type == 2:
            return 2 * len(self.frames)   # decode order == display order
        # type 0 (§8.2.1.1)
        max_lsb = 1 << (sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if nal_type == NAL_SLICE_IDR:
            self._prev_poc_msb = 0
            self._prev_poc_lsb = 0
        lsb = h.pic_order_cnt_lsb
        if (lsb < self._prev_poc_lsb
                and self._prev_poc_lsb - lsb >= max_lsb // 2):
            msb = self._prev_poc_msb + max_lsb
        elif (lsb > self._prev_poc_lsb
                and lsb - self._prev_poc_lsb > max_lsb // 2):
            msb = self._prev_poc_msb - max_lsb
        else:
            msb = self._prev_poc_msb
        if nal_ref_idc != 0:
            self._prev_poc_msb, self._prev_poc_lsb = msb, lsb
        return msb + lsb

    def _decode_slice(self, rbsp: np.ndarray, nal_type: int, nal_ref_idc: int) -> None:
        r = BitReader(rbsp)
        # need pps id before full parse: peek via temp parse
        hdr_probe = BitReader(rbsp)
        hdr_probe.ue()  # first_mb
        hdr_probe.ue()  # slice_type
        pps_id = hdr_probe.ue()
        pps = self.pps[pps_id]
        sps = self.sps[pps.seq_parameter_set_id]
        h = SliceHeader.parse(r, sps, pps, nal_type, nal_ref_idc)

        if h.first_mb_in_slice != 0:
            # continuation slice of the in-flight picture
            st = self._cur
            if st is None:
                raise ValueError("continuation slice without picture start")
            st.new_slice(h)
            self._run_slice(st, r, rbsp, pps)
            if st.n_decoded >= st.mbw * st.mbh:
                self._finish_picture()
            return

        self._finish_picture()
        if nal_type == NAL_SLICE_IDR:
            self.dpb.clear()
            self.dpb_lt.clear()
            self._idr_epoch += 1

        poc = self._compute_poc(sps, h, nal_type, nal_ref_idc)
        st = _SliceDecoder(self, sps, pps, h, nal_type, nal_ref_idc, poc)
        self._cur = st
        self._cur_info = (sps, h, nal_type, nal_ref_idc, poc)
        self._run_slice(st, r, rbsp, pps)
        if st.n_decoded >= st.mbw * st.mbh:
            self._finish_picture()

    @staticmethod
    def _run_slice(st: "_SliceDecoder", r: BitReader, rbsp: np.ndarray,
                   pps: PPS) -> None:
        if pps.entropy_coding_mode_flag:
            # cabac_alignment_one_bit(s), then the arithmetic payload
            pad = (-r.bit_position) % 8
            if pad:
                r.u(pad)
            st.decode_slice_data_cabac(
                np.asarray(rbsp[r.bit_position // 8:], np.uint8).tobytes())
        else:
            st.decode_slice_data(r)

    def _finish_picture(self) -> None:
        if self._cur is None:
            return
        st, self._cur = self._cur, None
        (sps, h, nal_type, nal_ref_idc, poc) = self._cur_info
        self._cur_info = None
        frame = st.finish()
        self._emit_frame(frame, sps, h, nal_type, nal_ref_idc, poc)

    def _emit_frame(self, frame: Frame, sps: SPS, h: SliceHeader,
                    nal_type: int, nal_ref_idc: int, poc: int) -> None:
        frame.poc = poc
        frame.idr_epoch = self._idr_epoch
        if nal_ref_idc != 0:
            frame.is_ref = True
            self._mark_refs(frame, sps, h, nal_type)
        out = frame.crop(sps.width, sps.height)
        out.idr_epoch = self._idr_epoch
        self.frames.append(out)

    # ---------------------------------------------------- ref marking §8.2.5
    def _mark_refs(self, frame: Frame, sps: SPS, h: SliceHeader,
                   nal_type: int) -> None:
        max_pic_num = 1 << (sps.log2_max_frame_num_minus4 + 4)
        cur = h.frame_num

        def pic_num(f: Frame) -> int:
            # FrameNumWrap (§8.2.4.1)
            return (f.frame_num - max_pic_num if f.frame_num > cur
                    else f.frame_num)

        if nal_type == NAL_SLICE_IDR:
            if h.long_term_reference_flag:
                frame.long_term, frame.lt_idx = True, 0
                self.dpb_lt[:] = [frame]
            else:
                self.dpb.insert(0, frame)
            return
        if h.adaptive_ref_pic_marking_mode_flag:
            for op in h.mmco_ops:
                if op.op == 1:          # unmark short-term
                    pn = cur - (op.args[0] + 1)
                    self.dpb = [f for f in self.dpb if pic_num(f) != pn]
                elif op.op == 2:        # unmark long-term
                    self.dpb_lt = [f for f in self.dpb_lt
                                   if f.lt_idx != op.args[0]]
                elif op.op == 3:        # short-term -> long-term
                    pn = cur - (op.args[0] + 1)
                    for f in list(self.dpb):
                        if pic_num(f) == pn:
                            self.dpb.remove(f)
                            f.long_term, f.lt_idx = True, op.args[1]
                            self.dpb_lt = [g for g in self.dpb_lt
                                           if g.lt_idx != op.args[1]] + [f]
                elif op.op == 4:        # max long-term frame idx
                    mx = op.args[0] - 1
                    self.dpb_lt = [f for f in self.dpb_lt if f.lt_idx <= mx]
                elif op.op == 5:        # unmark all + rebase
                    self.dpb.clear()
                    self.dpb_lt.clear()
                    self._prev_poc_msb = self._prev_poc_lsb = 0
                    frame.frame_num = 0
                    frame.poc = 0
                elif op.op == 6:        # current -> long-term
                    frame.long_term, frame.lt_idx = True, op.args[0]
                    self.dpb_lt = [g for g in self.dpb_lt
                                   if g.lt_idx != op.args[0]] + [frame]
            self.dpb_lt.sort(key=lambda f: f.lt_idx)
            if not frame.long_term:
                self.dpb.insert(0, frame)
            return
        # sliding window (§8.2.5.3): long-term pictures are never evicted
        self.dpb.insert(0, frame)
        max_refs = max(1, sps.max_num_ref_frames)
        while len(self.dpb) + len(self.dpb_lt) > max_refs and len(self.dpb) > 1:
            self.dpb.pop()


class _SliceDecoder:
    """Decodes one slice's macroblocks into a Frame."""

    def __init__(self, top: H264Decoder, sps: SPS, pps: PPS, h: SliceHeader,
                 nal_type: int, nal_ref_idc: int, poc: int = 0) -> None:
        self.top = top
        self.sps, self.pps, self.h = sps, pps, h
        self.poc = poc
        self.mbw = sps.mb_width
        self.mbh = sps.mb_height
        W, H = self.mbw * 16, self.mbh * 16
        self.y = np.zeros((H, W), dtype=np.int32)
        self.u = np.zeros((H // 2, W // 2), dtype=np.int32)
        self.v = np.zeros((H // 2, W // 2), dtype=np.int32)
        self.qp = pps.pic_init_qp_minus26 + 26 + h.slice_qp_delta
        self.qp_map = np.zeros((self.mbh, self.mbw), dtype=np.int32)
        self.mb_type = np.full((self.mbh, self.mbw), -1, dtype=np.int32)
        # total_coeffs contexts
        self.tc_luma = np.zeros((self.mbh * 4, self.mbw * 4), dtype=np.int32)
        self.tc_chroma = np.zeros((2, self.mbh * 2, self.mbw * 2), dtype=np.int32)
        # intra 4x4 modes per 4x4 block (-1 = not I4x4); Intra_8x8 modes
        # are replicated into their four cells (mode prediction then works
        # uniformly at 4x4 granularity, the FFmpeg cache convention)
        self.i4_modes = np.full((self.mbh * 4, self.mbw * 4), -1, dtype=np.int32)
        # High-profile 8x8 transform bookkeeping (deblock rules §8.7.2.1)
        self.t8x8 = np.zeros((self.mbh, self.mbw), dtype=bool)
        self.t8_coded = np.zeros((self.mbh * 2, self.mbw * 2), dtype=bool)
        # motion field per 4x4 block (list 0; list 1 for B slices)
        self.mv = np.zeros((self.mbh * 4, self.mbw * 4, 2), dtype=np.int32)
        self.ref = np.full((self.mbh * 4, self.mbw * 4), -1, dtype=np.int32)
        self.mv1 = np.zeros((self.mbh * 4, self.mbw * 4, 2), dtype=np.int32)
        self.ref1 = np.full((self.mbh * 4, self.mbw * 4), -1, dtype=np.int32)
        # per-list reference PICTURE identity (id() of the Frame) for the
        # deblock bs rule "different reference pictures" (§8.7.2.1) — list
        # index equality is not picture equality across L0/L1
        self.refpic = np.full((2, self.mbh * 4, self.mbw * 4), -1,
                              dtype=np.int64)
        # per-4x4-block "decoded" flag (MV-pred availability, §6.4.10.4)
        self.blk_done = np.zeros((self.mbh * 4, self.mbw * 4), dtype=bool)
        self.is_idr = nal_type == NAL_SLICE_IDR
        self.nal_ref_idc = nal_ref_idc
        # optional syntax collection for the device recon path (config 4):
        # filled during parse when the slice is P16x16/skip-only
        self.collect = {
            "eligible": h.is_p() and h.disable_deblocking_filter_idc == 1
                        and h.num_ref_idx_l0_active_minus1 == 0,
            "levels": np.zeros((self.mbh * self.mbw, 16, 16), np.int32),
            "dc_u": np.zeros((self.mbh * self.mbw, 2, 2), np.int32),
            "dc_v": np.zeros((self.mbh * self.mbw, 2, 2), np.int32),
            "ac_u": np.zeros((self.mbh * self.mbw, 4, 15), np.int32),
            "ac_v": np.zeros((self.mbh * self.mbw, 4, 15), np.int32),
            "cbp_luma": np.zeros(self.mbh * self.mbw, np.int32),
            "cbp_chroma": np.zeros(self.mbh * self.mbw, np.int32),
        }
        # multi-slice assembly: per-MB slice ids gate neighbor availability
        # (intra pred, MV pred, and nC contexts do not cross slices, §6.4.9)
        self.mb_slice = np.full((self.mbh, self.mbw), -1, dtype=np.int32)
        self.cur_slice = 0
        self.n_decoded = 0
        self.ref_list0: list[Frame] = []
        self.ref_list1: list[Frame] = []
        self._build_ref_lists(h)
        # per-MB intra flag for nC... (kept via mb_type map)

    def new_slice(self, h: SliceHeader) -> None:
        """Start a continuation slice of the same picture (§7.4.3
        first_mb_in_slice > 0): fresh slice id, QP, and reference lists."""
        self.cur_slice += 1
        self.h = h
        self.qp = self.pps.pic_init_qp_minus26 + 26 + h.slice_qp_delta
        self.collect["eligible"] = False
        self._build_ref_lists(h)

    def _build_ref_lists(self, h: SliceHeader) -> None:
        """Initial reference lists (§8.2.4.2) + modification (§8.2.4.3)."""
        top, poc = self.top, self.poc
        lt = sorted(top.dpb_lt, key=lambda f: f.lt_idx)
        if h.is_p():
            # short-term by PicNum descending (dpb is most-recent-first),
            # then long-term by LongTermFrameIdx ascending
            self.ref_list0 = list(top.dpb) + lt
            self.ref_list1 = []
        elif h.is_b():
            before = sorted((f for f in top.dpb if f.poc < poc),
                            key=lambda f: -f.poc)
            after = sorted((f for f in top.dpb if f.poc > poc),
                           key=lambda f: f.poc)
            self.ref_list0 = before + after + lt
            self.ref_list1 = after + before + lt
            # §8.2.4.2.3: identical lists with >1 entry -> swap list1's
            # first two entries
            if (len(self.ref_list1) > 1
                    and len(self.ref_list1) == len(self.ref_list0)
                    and all(a is b for a, b in zip(self.ref_list1,
                                                   self.ref_list0))):
                self.ref_list1 = ([self.ref_list1[1], self.ref_list1[0]]
                                  + self.ref_list1[2:])
        else:
            self.ref_list0 = []
            self.ref_list1 = []
        if h.ref_pic_list_mod_l0:
            self._apply_ref_mod(self.ref_list0, h.ref_pic_list_mod_l0, h)
        if h.ref_pic_list_mod_l1:
            self._apply_ref_mod(self.ref_list1, h.ref_pic_list_mod_l1, h)
        if h.is_p() or h.is_b():
            del self.ref_list0[h.num_ref_idx_l0_active_minus1 + 1:]
        if h.is_b():
            del self.ref_list1[h.num_ref_idx_l1_active_minus1 + 1:]

    def _apply_ref_mod(self, refs: list, mods: list, h: SliceHeader) -> None:
        """ref_pic_list_modification (§8.2.4.3): reorder by picture number
        difference (idc 0/1) or long-term frame idx (idc 2)."""
        max_pic_num = 1 << (self.sps.log2_max_frame_num_minus4 + 4)
        cur_pic_num = h.frame_num
        pred = cur_pic_num
        idx = 0
        for (idc, val) in mods:
            if idc in (0, 1):
                ad = val + 1
                pn = pred - ad if idc == 0 else pred + ad
                pn %= max_pic_num
                pred = pn
                pic_num = pn - max_pic_num if pn > cur_pic_num else pn
                target = next(
                    (f for f in self.top.dpb
                     if (f.frame_num - max_pic_num
                         if f.frame_num > cur_pic_num else f.frame_num)
                     == pic_num), None)
            else:  # idc == 2: long-term
                target = next((f for f in self.top.dpb_lt
                               if f.lt_idx == val), None)
            if target is None:
                raise ValueError(f"ref list modification ({idc},{val}) "
                                 "names a picture not in the DPB")
            refs.insert(idx, target)
            for j in range(idx + 1, len(refs)):
                if refs[j] is target:
                    del refs[j]
                    break
            idx += 1

    # ---------------------------------------------------------------- utils
    def mb_avail(self, mx: int, my: int) -> bool:
        return (0 <= mx < self.mbw and 0 <= my < self.mbh
                and self.mb_type[my, mx] >= 0
                and self.mb_slice[my, mx] == self.cur_slice)

    def _blk_avail(self, bx: int, by: int) -> bool:
        """4x4-block-granular availability: decoded AND same slice."""
        return (0 <= bx < self.mbw * 4 and 0 <= by < self.mbh * 4
                and bool(self.blk_done[by, bx])
                and self.mb_slice[by // 4, bx // 4] == self.cur_slice)

    def _nc_luma(self, bx: int, by: int) -> int:
        """nC for luma 4x4 block at global block coords (§9.2.1)."""
        availA = bx > 0 and self._blk_mb_decoded(bx - 1, by)
        availB = by > 0 and self._blk_mb_decoded(bx, by - 1)
        if availA and availB:
            return (self.tc_luma[by, bx - 1] + self.tc_luma[by - 1, bx] + 1) >> 1
        if availA:
            return int(self.tc_luma[by, bx - 1])
        if availB:
            return int(self.tc_luma[by - 1, bx])
        return 0

    def _nc_chroma(self, c: int, bx: int, by: int) -> int:
        availA = bx > 0 and self._blk_mb_decoded_c(bx - 1, by)
        availB = by > 0 and self._blk_mb_decoded_c(bx, by - 1)
        if availA and availB:
            return (self.tc_chroma[c, by, bx - 1] + self.tc_chroma[c, by - 1, bx] + 1) >> 1
        if availA:
            return int(self.tc_chroma[c, by, bx - 1])
        if availB:
            return int(self.tc_chroma[c, by - 1, bx])
        return 0

    def _blk_mb_decoded(self, bx: int, by: int) -> bool:
        return (self.mb_type[by // 4, bx // 4] >= 0
                and self.mb_slice[by // 4, bx // 4] == self.cur_slice)

    def _blk_mb_decoded_c(self, bx: int, by: int) -> bool:
        return (self.mb_type[by // 2, bx // 2] >= 0
                and self.mb_slice[by // 2, bx // 2] == self.cur_slice)

    # ------------------------------------------------------------ main loop
    def _mark_mb_done(self, mb_idx: int) -> None:
        mx, my = mb_idx % self.mbw, mb_idx // self.mbw
        self.mb_slice[my, mx] = self.cur_slice
        self.n_decoded += 1

    def decode_slice_data(self, r: BitReader) -> None:
        h = self.h
        mb_idx = h.first_mb_in_slice
        n_mbs = self.mbw * self.mbh
        inter_slice = h.is_p() or h.is_b()
        while mb_idx < n_mbs:
            if inter_slice:
                skip_run = r.ue()
                for _ in range(skip_run):
                    if mb_idx >= n_mbs:
                        raise ValueError("skip run past picture end")
                    mx, my = mb_idx % self.mbw, mb_idx // self.mbw
                    self.mb_slice[my, mx] = self.cur_slice
                    if h.is_p():
                        self._decode_p_skip(mx, my)
                    else:
                        self._decode_b_skip(mx, my)
                    self.n_decoded += 1
                    mb_idx += 1
                if mb_idx >= n_mbs:
                    break
                if not r.more_rbsp_data():
                    break   # slice ends after a skip run
            mx, my = mb_idx % self.mbw, mb_idx // self.mbw
            self.mb_slice[my, mx] = self.cur_slice
            self._decode_mb(r, mx, my)
            self.n_decoded += 1
            mb_idx += 1
            if not inter_slice and mb_idx < n_mbs and not r.more_rbsp_data():
                break   # slice ends mid-picture (multi-slice)

    # ----------------------------------------------------------- CABAC path
    def decode_slice_data_cabac(self, payload: bytes) -> None:
        from .cabac_slice import CabacSliceReader
        h = self.h
        rd = CabacSliceReader(self.qp, h.is_i(), self.mbh, self.mbw, payload,
                              h.cabac_init_idc)
        rd.num_ref_l0 = h.num_ref_idx_l0_active_minus1 + 1
        rd.num_ref_l1 = h.num_ref_idx_l1_active_minus1 + 1
        rd.first_mb = h.first_mb_in_slice
        rd.transform_8x8_mode = bool(self.pps.transform_8x8_mode_flag)
        self.collect["eligible"] = False
        n = self.mbh * self.mbw
        eos = True
        for k in range(h.first_mb_in_slice, n):
            mx, my = k % self.mbw, k // self.mbw
            self.mb_slice[my, mx] = self.cur_slice
            if h.is_b():
                o = rd.read_b_mb(mx, my)
                if o["skip"]:
                    self._decode_b_skip(mx, my)
                elif o.get("intra"):
                    self._recon_intra_cabac(mx, my, o)
                else:
                    self._recon_b_cabac(mx, my, o)
            elif h.is_p():
                o = rd.read_p_mb(mx, my)
                if o["skip"]:
                    self._decode_p_skip(mx, my)
                elif o.get("intra"):
                    self._recon_intra_cabac(mx, my, o)
                else:
                    self._recon_p16_cabac(mx, my, o)
            else:
                o = rd.read_i_mb(mx, my)
                self._recon_intra_cabac(mx, my, o)
            self.n_decoded += 1
            eos = bool(rd.end_mb())
            if eos:
                break   # end_of_slice_flag terminates the slice
        if not eos and k == n - 1:
            raise ValueError("CABAC slice data continues past the last MB")

    # ------------------------------------------------------------- finish
    def finish(self) -> Frame:
        """Deblock the assembled picture and build its Frame."""
        if self.n_decoded < self.mbh * self.mbw:
            raise ValueError(
                f"picture incomplete: {self.n_decoded}/"
                f"{self.mbh * self.mbw} MBs decoded")
        if self.h.disable_deblocking_filter_idc != 1:
            deblock_frame(self)
        fr = Frame(self.y, self.u, self.v, frame_num=self.h.frame_num,
                   is_idr=self.is_idr,
                   mb_types=self.mb_type.copy(), qps=self.qp_map.copy(),
                   mvs=self.mv.copy(), refs=self.ref.copy(),
                   mvs1=self.mv1.copy(), refs1=self.ref1.copy(),
                   refid0=self.refpic[0].copy(), refid1=self.refpic[1].copy())
        fr.syntax = (self.collect if (self.collect["eligible"]
                                      and self.cur_slice == 0) else None)
        return fr

    def _recon_p16_cabac(self, mx: int, my: int, o: dict) -> None:
        gx, gy = mx * 4, my * 4
        part = o.get("part", 0)
        self.mb_type[my, mx] = 100 + part
        if part == 0:
            ref = int(o.get("refs4", np.zeros(4, np.int32))[0])
            pmv = self._mv_pred(mx, my, 0, 0, 4, 4, ref)
            mv = pmv + o["mvd"]
            self._set_motion(mx, my, (0, 0, 4, 4), True, False,
                             mv, ref, None, None)
            self._inter_recon_16x16(mx, my, mv, ref)
        elif part == 3 and o.get("subt") is not None:
            # P_8x8 with sub-8x8 partitions: same geometry walk as the
            # CAVLC path (Table 7-17)
            SUBP = {0: [(0, 0, 2, 2)],
                    1: [(0, 0, 2, 1), (0, 1, 2, 1)],
                    2: [(0, 0, 1, 2), (1, 0, 1, 2)],
                    3: [(0, 0, 1, 1), (1, 0, 1, 1),
                        (0, 1, 1, 1), (1, 1, 1, 1)]}
            refs4 = o.get("refs4", np.zeros(4, np.int32))
            for sb in range(4):
                sbx, sby = (sb & 1) * 2, (sb >> 1) * 2
                ref = int(refs4[sb])
                for pi, (ox, oy, pw, ph) in enumerate(SUBP[o["subt"][sb]]):
                    px, py = sbx + ox, sby + oy
                    pmv = self._mv_pred(mx, my, px, py, pw, ph, ref)
                    mv = pmv + o["mvd_sub"][sb][pi]
                    self._set_motion(mx, my, (px, py, pw, ph), True, False,
                                     mv, ref, None, None)
                    self._inter_recon_16x16(
                        mx, my, mv, ref,
                        part=(px * 4, py * 4, pw * 4, ph * 4))
        else:
            # partitions (same geometry walk as the CAVLC path)
            PARTS = {1: [(0, 0, 4, 2), (0, 2, 4, 2)],
                     2: [(0, 0, 2, 4), (2, 0, 2, 4)],
                     3: [(0, 0, 2, 2), (2, 0, 2, 2),
                         (0, 2, 2, 2), (2, 2, 2, 2)]}
            refs4 = o.get("refs4", np.zeros(4, np.int32))
            for (px, py, pw, ph) in PARTS[part]:
                sl = (py // 2) * 2 + (px // 2)
                ref = int(refs4[sl])
                pmv = self._mv_pred(mx, my, px, py, pw, ph, ref)
                mv = pmv + o["mvd4"][sl]
                self._set_motion(mx, my, (px, py, pw, ph), True, False,
                                 mv, ref, None, None)
                self._inter_recon_16x16(
                    mx, my, mv, ref,
                    part=(px * 4, py * 4, pw * 4, ph * 4))
        self.qp += o["qpd"]
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        self._apply_inter_luma_cabac(mx, my, o, qp)
        xc, yc = mx * 8, my * 8
        preds = [self.u[yc:yc + 8, xc:xc + 8].copy(),
                 self.v[yc:yc + 8, xc:xc + 8].copy()]
        self.tc_chroma[0, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_u"], axis=1).reshape(2, 2)
        self.tc_chroma[1, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_v"], axis=1).reshape(2, 2)
        resid = {"dc": [o["dc_u"], o["dc_v"]],
                 "ac": np.stack([o["ac_u"], o["ac_v"]])}
        self._recon_chroma(preds, resid, mx, my, qpc)

    def _recon_b_cabac(self, mx: int, my: int, o: dict) -> None:
        """B MB recon from CABAC syntax (all Table 7-14 inter types)."""
        t = o["mode"]
        self.mb_type[my, mx] = 200 + t
        if t == 0:
            self._b_direct_recon(mx, my)
        elif t <= 3:
            use = (t in (1, 3), t in (2, 3))
            refs = (o.get("ref0", 0), o.get("ref1", 0))
            mvs = [np.zeros(2, np.int32), np.zeros(2, np.int32)]
            for x in (0, 1):
                if use[x]:
                    pmv = self._mv_pred(mx, my, 0, 0, 4, 4, refs[x], x)
                    mvs[x] = pmv + o["mvd0" if x == 0 else "mvd1"]
            self._set_motion(mx, my, (0, 0, 4, 4), use[0], use[1],
                             mvs[0], refs[0], mvs[1], refs[1])
            self._inter_recon_b(mx, my, (0, 0, 16, 16), use[0], use[1],
                                mvs[0], refs[0], mvs[1], refs[1])
        elif t <= 21:
            self._derive_b_2part(mx, my, t, o["refs2"], o["mvds2"])
        else:
            self._derive_b_8x8_syntax(mx, my, o["subt"], o["refs"],
                                      o["mvds"])
        # residual application (same tail as CABAC P, §-shared helpers)
        self.qp += o["qpd"]
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        self._apply_inter_luma_cabac(mx, my, o, qp)
        xc, yc = mx * 8, my * 8
        preds = [self.u[yc:yc + 8, xc:xc + 8].copy(),
                 self.v[yc:yc + 8, xc:xc + 8].copy()]
        self.tc_chroma[0, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_u"], axis=1).reshape(2, 2)
        self.tc_chroma[1, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_v"], axis=1).reshape(2, 2)
        resid = {"dc": [o["dc_u"], o["dc_v"]],
                 "ac": np.stack([o["ac_u"], o["ac_v"]])}
        self._recon_chroma(preds, resid, mx, my, qpc)

    def _derive_b_2part(self, mx: int, my: int, mb_type: int,
                        refs, mvds) -> None:
        """Two-partition B MB from raw syntax (refs[p][x], mvds[x][p])."""
        combo = self._B2_COMBO[mb_type]
        vert = mb_type & 1
        parts4 = ([(0, 0, 2, 4), (2, 0, 2, 4)] if vert
                  else [(0, 0, 4, 2), (0, 2, 4, 2)])
        for p in (0, 1):
            px, py, pw, ph = parts4[p]
            mvp = [None, None]
            for x in (0, 1):
                if combo[p][x]:
                    pmv = self._mv_pred(mx, my, px, py, pw, ph,
                                        refs[p][x], x)
                    mvp[x] = pmv + mvds[x][p]
            self._set_motion(mx, my, parts4[p], combo[p][0], combo[p][1],
                             mvp[0], refs[p][0], mvp[1], refs[p][1])
            self._inter_recon_b(mx, my, (px * 4, py * 4, pw * 4, ph * 4),
                                combo[p][0], combo[p][1],
                                mvp[0], refs[p][0], mvp[1], refs[p][1])

    def _derive_b_8x8_syntax(self, mx: int, my: int, subt, refs,
                             mvds) -> None:
        """B_8x8 from raw syntax, 8x8 subs only (CABAC reader scope):
        subt[sb] in 0..3, refs[sb][x], mvds[x][sb]."""
        direct = (self._b_direct_motion(mx, my)
                  if any(s == 0 for s in subt) else None)
        for sb in range(4):
            st = subt[sb]
            sbx, sby = (sb & 1) * 2, (sb >> 1) * 2
            qx, qy = sb & 1, sb >> 1
            if st == 0:
                f0, f1, r0q, r1q, mv0q, mv1q = direct
                r0, r1 = int(r0q[qy, qx]), int(r1q[qy, qx])
                self._set_motion(mx, my, (sbx, sby, 2, 2), f0, f1,
                                 mv0q[qy, qx], r0, mv1q[qy, qx], r1)
                self._inter_recon_b(mx, my, (8 * qx, 8 * qy, 8, 8), f0, f1,
                                    mv0q[qy, qx], r0, mv1q[qy, qx], r1)
                continue
            use = self._BSUB_LISTS[st]
            mvp = [None, None]
            for x in (0, 1):
                if use[x]:
                    pmv = self._mv_pred(mx, my, sbx, sby, 2, 2,
                                        refs[sb][x], x)
                    mvp[x] = pmv + mvds[x][sb]
            self._set_motion(mx, my, (sbx, sby, 2, 2), use[0], use[1],
                             mvp[0], refs[sb][0], mvp[1], refs[sb][1])
            self._inter_recon_b(mx, my, (8 * qx, 8 * qy, 8, 8),
                                use[0], use[1], mvp[0], refs[sb][0],
                                mvp[1], refs[sb][1])

    def _recon_intra_cabac(self, mx: int, my: int, o: dict) -> None:
        if o["kind"] == "i16":
            self._recon_i16_cabac(mx, my, o)
        elif o["kind"] == "i8":
            self._recon_i8_cabac(mx, my, o)
        else:
            self._recon_i4_cabac(mx, my, o)

    def _recon_i8_cabac(self, mx: int, my: int, o: dict) -> None:
        """I_NxN + transform_size_8x8_flag recon from CABAC syntax."""
        self.mb_type[my, mx] = I_NXN
        self.t8x8[my, mx] = True
        modes8 = np.zeros(4, np.int32)
        for blk in range(4):
            prev, rem = o["modes_bins8"][blk]
            pred = self._i8_pred_mode(mx, my, blk, modes8)
            modes8[blk] = pred if prev else (rem if rem < pred else rem + 1)
        for blk in range(4):
            bx, by = blk & 1, blk >> 1
            self.i4_modes[my * 4 + by * 2:my * 4 + by * 2 + 2,
                          mx * 4 + bx * 2:mx * 4 + bx * 2 + 2] = modes8[blk]
        self.qp += o["qpd"]
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        for b8 in range(4):
            lv = o["levels8"][b8]
            b8x, b8y = b8 & 1, b8 >> 1
            coded = bool(lv.any())
            self.t8_coded[my * 2 + b8y, mx * 2 + b8x] = coded
            self.tc_luma[my * 4 + b8y * 2:my * 4 + b8y * 2 + 2,
                         mx * 4 + b8x * 2:mx * 4 + b8x * 2 + 2] = \
                int(np.count_nonzero(lv))
            self._recon_i8_block(mx, my, b8, int(modes8[b8]), lv, qp)
        preds = self._chroma_pred_pair(mx, my, o["cmode"])
        self.tc_chroma[0, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_u"], axis=1).reshape(2, 2)
        self.tc_chroma[1, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_v"], axis=1).reshape(2, 2)
        resid = {"dc": [o["dc_u"], o["dc_v"]],
                 "ac": np.stack([o["ac_u"], o["ac_v"]])}
        self._recon_chroma(preds, resid, mx, my, qpc)
        gx, gy = mx * 4, my * 4
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    def _apply_inter_luma_cabac(self, mx: int, my: int, o: dict,
                                qp: int) -> None:
        """Inter luma residual application (4x4 or 8x8 transform)."""
        x0, y0 = mx * 16, my * 16
        if o.get("t8"):
            self.t8x8[my, mx] = True
            for b8 in range(4):
                lv = o["levels8"][b8]
                b8x, b8y = b8 & 1, b8 >> 1
                self.t8_coded[my * 2 + b8y, mx * 2 + b8x] = bool(lv.any())
                self.tc_luma[my * 4 + b8y * 2:my * 4 + b8y * 2 + 2,
                             mx * 4 + b8x * 2:mx * 4 + b8x * 2 + 2] = \
                    int(np.count_nonzero(lv))
                if not lv.any():
                    continue
                px, py = x0 + b8x * 8, y0 + b8y * 8
                d = tnp.dequant8x8(tnp.zigzag8x8_unscan(lv), qp)
                res = tnp.idct8x8_core(d)
                self.y[py:py + 8, px:px + 8] = np.clip(
                    self.y[py:py + 8, px:px + 8] + res, 0, 255)
            return
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            ggx, ggy = mx * 4 + bx, my * 4 + by
            lv = o["levels"][blk]
            self.tc_luma[ggy, ggx] = int(np.count_nonzero(lv))
            if not lv.any():
                continue
            blkc = tnp.zigzag_unscan(lv.reshape(1, 16))[0]
            d = tnp.dequant4x4(blkc.reshape(1, 4, 4), qp)
            res = tnp.idct4x4_core(d)[0]
            px, py = x0 + bx * 4, y0 + by * 4
            self.y[py:py + 4, px:px + 4] = np.clip(
                self.y[py:py + 4, px:px + 4] + res, 0, 255)

    def _recon_i4_cabac(self, mx: int, my: int, o: dict) -> None:
        self.mb_type[my, mx] = I_NXN
        modes = np.zeros(16, np.int32)
        for blk in range(16):
            prev, rem = o["modes_bins"][blk]
            pred = self._i4_pred_mode(mx, my, blk, modes)
            modes[blk] = pred if prev else (rem if rem < pred else rem + 1)
        for blk in range(16):
            gx, gy = mx * 4 + int(BLK_X[blk]), my * 4 + int(BLK_Y[blk])
            self.i4_modes[gy, gx] = modes[blk]
        self.qp += o["qpd"]
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            self.tc_luma[my * 4 + by, mx * 4 + bx] = \
                int(np.count_nonzero(o["levels"][blk]))
        self._recon_i4_luma(mx, my, modes, o["levels"], qp)
        preds = self._chroma_pred_pair(mx, my, o["cmode"])
        self.tc_chroma[0, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_u"], axis=1).reshape(2, 2)
        self.tc_chroma[1, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_v"], axis=1).reshape(2, 2)
        resid = {"dc": [o["dc_u"], o["dc_v"]],
                 "ac": np.stack([o["ac_u"], o["ac_v"]])}
        self._recon_chroma(preds, resid, mx, my, qpc)
        gx, gy = mx * 4, my * 4
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    def _recon_i16_cabac(self, mx: int, my: int, o: dict) -> None:
        it = 1 + o["pred"] + 4 * o["cbp_c"] + 12 * int(o["ac_flag"])
        self.mb_type[my, mx] = it
        self.qp += o["qpd"]
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        ac = np.zeros((16, 16), dtype=np.int32)
        ac[:, 1:] = o["ac"]
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            self.tc_luma[my * 4 + by, mx * 4 + bx] = \
                int(np.count_nonzero(o["ac"][blk]))
        self._recon_i16_luma(mx, my, o["pred"], o["dc"], ac, qp)
        preds = self._chroma_pred_pair(mx, my, o["cmode"])
        self.tc_chroma[0, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_u"], axis=1).reshape(2, 2)
        self.tc_chroma[1, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = \
            np.count_nonzero(o["ac_v"], axis=1).reshape(2, 2)
        resid = {"dc": [o["dc_u"], o["dc_v"]],
                 "ac": np.stack([o["ac_u"], o["ac_v"]])}
        self._recon_chroma(preds, resid, mx, my, qpc)
        gx, gy = mx * 4, my * 4
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    def _recon_i16_luma(self, mx: int, my: int, pred_mode: int,
                        dc_levels: np.ndarray, ac: np.ndarray,
                        qp: int) -> None:
        """I16x16 luma recon from parsed coefficients (entropy-agnostic).
        ac: (16, 16) per block zigzag incl. the (ignored) DC slot."""
        top, left, tl = self._intra_neighbors_luma(mx, my)
        pred = ipred.pred16x16(pred_mode, top, left, tl)
        x0, y0 = mx * 16, my * 16
        dc_raster = tnp.zigzag_unscan(dc_levels.reshape(1, 16))[0]
        dc_vals = tnp.luma_dc_dequant(dc_raster.reshape(1, 4, 4), qp)[0]
        blocks = tnp.zigzag_unscan(ac)  # (16,4,4)
        d = tnp.dequant4x4(blocks, qp)
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            d[blk, 0, 0] = dc_vals[by, bx]
        res = tnp.idct4x4_core(d)
        rec = np.zeros((16, 16), dtype=np.int32)
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = (
                pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res[blk])
        self.y[y0:y0 + 16, x0:x0 + 16] = np.clip(rec, 0, 255)

    # -------------------------------------------------------------- intra
    def _intra_neighbors_luma(self, mx: int, my: int):
        """(top16, left16, topleft) sample arrays or None."""
        x0, y0 = mx * 16, my * 16
        top = self.y[y0 - 1, x0:x0 + 16].copy() if self.mb_avail(mx, my - 1) else None
        left = self.y[y0:y0 + 16, x0 - 1].copy() if self.mb_avail(mx - 1, my) else None
        tl = int(self.y[y0 - 1, x0 - 1]) if self.mb_avail(mx - 1, my - 1) else None
        return top, left, tl

    def _decode_intra16x16(self, r: BitReader, mx: int, my: int, pred_mode: int,
                           cbp_luma: int, cbp_chroma: int, qp: int) -> None:
        # luma DC: nC context of block 0
        nc = self._nc_luma(mx * 4, my * 4)
        dc_levels = decode_residual_block(r, nc, 16)
        # (the I16x16 DC block does not update the nC context map)

        ac = np.zeros((16, 16), dtype=np.int32)  # per block, zigzag incl DC slot
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            gx, gy = mx * 4 + bx, my * 4 + by
            if cbp_luma & (1 << (blk // 4)):
                nc = self._nc_luma(gx, gy)
                lv = decode_residual_block(r, nc, 15)
                ac[blk, 1:] = lv
                self.tc_luma[gy, gx] = int(np.count_nonzero(lv))
            else:
                self.tc_luma[gy, gx] = 0
        self._recon_i16_luma(mx, my, pred_mode, dc_levels, ac, qp)

    def _decode_intra4x4(self, r: BitReader, mx: int, my: int,
                         modes: np.ndarray, cbp_luma: int, qp: int) -> None:
        """CAVLC parse + recon. modes: (16,) I4x4 modes in block order."""
        lv16 = np.zeros((16, 16), np.int32)
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            gx, gy = mx * 4 + bx, my * 4 + by
            if cbp_luma & (1 << (blk // 4)):
                nc = self._nc_luma(gx, gy)
                lv = decode_residual_block(r, nc, 16)
                self.collect["levels"][my * self.mbw + mx, blk] = lv
                self.tc_luma[gy, gx] = int(np.count_nonzero(lv))
                lv16[blk] = lv
            else:
                self.tc_luma[gy, gx] = 0
        self._recon_i4_luma(mx, my, modes, lv16, qp)

    def _recon_i4_luma(self, mx: int, my: int, modes: np.ndarray,
                       lv16: np.ndarray, qp: int) -> None:
        """I4x4 luma recon from parsed coefficients (entropy-agnostic).
        lv16: (16,16) zigzag per block (zeros when uncoded)."""
        x0, y0 = mx * 16, my * 16
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            gx, gy = mx * 4 + bx, my * 4 + by
            px, py = x0 + bx * 4, y0 + by * 4
            # neighbor sample availability (block granular)
            availA = (gx > 0) and (bx > 0 or self.mb_avail(mx - 1, my))
            availB = (gy > 0) and (by > 0 or self.mb_avail(mx, my - 1))
            availD = (gx > 0 and gy > 0) and \
                ((bx > 0 and by > 0) or
                 (bx > 0 and self.mb_avail(mx, my - 1)) or
                 (by > 0 and self.mb_avail(mx - 1, my)) or
                 (bx == 0 and by == 0 and self.mb_avail(mx - 1, my - 1)))
            # top-right availability (§6.4.11 neighbouring 4x4 blocks):
            # inside MB: only blocks whose top-right neighbor was already
            # decoded; pattern per block index.
            availC = self._i4_topright_avail(mx, my, blk)
            top = self.y[py - 1, px:px + 4].copy() if availB else None
            left = self.y[py:py + 4, px - 1].copy() if availA else None
            tl = int(self.y[py - 1, px - 1]) if availD else None
            tr = self.y[py - 1, px + 4:px + 8].copy() if availC else None
            if top is not None and (tr is None or tr.size < 4):
                tr = None  # replicate handled in pred4x4
            pred = ipred.pred4x4(int(modes[blk]), top, tr, left, tl)

            lv = lv16[blk]
            if lv.any():
                blkc = tnp.zigzag_unscan(lv.reshape(1, 16))[0]
                d = tnp.dequant4x4(blkc.reshape(1, 4, 4), qp)
                res = tnp.idct4x4_core(d)[0]
            else:
                res = 0
            self.y[py:py + 4, px:px + 4] = np.clip(pred + res, 0, 255)

    def _i4_topright_avail(self, mx: int, my: int, blk: int) -> bool:
        bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
        gx, gy = mx * 4 + bx, my * 4 + by
        if by == 0:
            # top row of MB: neighbor is in MB above (or above-right for bx=3)
            if bx < 3:
                return self.mb_avail(mx, my - 1)
            return self.mb_avail(mx + 1, my - 1)
        # inside MB: top-right block must be earlier in decode order
        if bx == 3:
            return False
        nb_raster = (by - 1) * 4 + (bx + 1)
        return RASTER_TO_BLK[nb_raster] < blk

    def _decode_chroma_intra(self, r: BitReader, mx: int, my: int, mode: int,
                             cbp_chroma: int, qpc: int, intra: bool = True) -> None:
        x0, y0 = mx * 8, my * 8
        for c, plane in ((0, self.u), (1, self.v)):
            top = plane[y0 - 1, x0:x0 + 8].copy() if self.mb_avail(mx, my - 1) else None
            left = plane[y0:y0 + 8, x0 - 1].copy() if self.mb_avail(mx - 1, my) else None
            tl = int(plane[y0 - 1, x0 - 1]) if self.mb_avail(mx - 1, my - 1) else None
            pred = ipred.pred_chroma8x8(mode, top, left, tl)
            self._apply_chroma_residual(r, plane, pred, c, mx, my, cbp_chroma,
                                        qpc, intra, defer=(c == 0))

    # chroma residual parse order is DC(Cb), DC(Cr), AC(Cb)x4, AC(Cr)x4 —
    # so reconstruction needs the parse split from the apply. We parse into
    # a staging dict and apply after both planes' syntax is read.
    def _parse_chroma_residuals(self, r: BitReader, mx: int, my: int,
                                cbp_chroma: int) -> dict:
        out = {"dc": [np.zeros(4, np.int32), np.zeros(4, np.int32)],
               "ac": np.zeros((2, 4, 15), dtype=np.int32)}
        if cbp_chroma:
            for c in range(2):
                out["dc"][c] = decode_residual_block(r, -1, 4)
                key = "dc_u" if c == 0 else "dc_v"
                self.collect[key][my * self.mbw + mx] = out["dc"][c].reshape(2, 2)
        if cbp_chroma == 2:
            for c in range(2):
                for sb in range(4):
                    sbx, sby = sb & 1, sb >> 1
                    gx, gy = mx * 2 + sbx, my * 2 + sby
                    nc = self._nc_chroma(c, gx, gy)
                    lv = decode_residual_block(r, nc, 15)
                    out["ac"][c, sb] = lv
                    self.collect["ac_u" if c == 0 else "ac_v"][
                        my * self.mbw + mx, sb] = lv
                    self.tc_chroma[c, gy, gx] = int(np.count_nonzero(lv))
        else:
            for c in range(2):
                self.tc_chroma[c, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        return out

    def _recon_chroma(self, preds: tuple[np.ndarray, np.ndarray],
                      resid: dict, mx: int, my: int, qpc: int) -> None:
        x0, y0 = mx * 8, my * 8
        for c, plane in ((0, self.u), (1, self.v)):
            dc_z = resid["dc"][c]
            # chroma DC 2x2: "zigzag" is raster for 2x2: positions 0,1,2,3
            dc22 = dc_z.reshape(2, 2)
            dc_vals = tnp.chroma_dc_dequant(dc22.reshape(1, 2, 2), qpc)[0]
            blocks = tnp.zigzag_unscan(
                np.concatenate([np.zeros((4, 1), np.int32), resid["ac"][c]], axis=1))
            d = tnp.dequant4x4(blocks, qpc)
            for sb in range(4):
                sbx, sby = sb & 1, sb >> 1
                d[sb, 0, 0] = dc_vals[sby, sbx]
            res = tnp.idct4x4_core(d)
            rec = np.zeros((8, 8), dtype=np.int32)
            for sb in range(4):
                sbx, sby = sb & 1, sb >> 1
                rec[sby * 4:sby * 4 + 4, sbx * 4:sbx * 4 + 4] = (
                    preds[c][sby * 4:sby * 4 + 4, sbx * 4:sbx * 4 + 4] + res[sb])
            plane[y0:y0 + 8, x0:x0 + 8] = np.clip(rec, 0, 255)

    # --------------------------------------------------------------- inter
    def _mv_pred(self, mx: int, my: int, part_x: int, part_y: int,
                 part_w: int, part_h: int, ref_idx: int,
                 lst: int = 0) -> np.ndarray:
        """Median MV prediction (§8.4.1.3). part coords in 4-pel units
        relative to MB origin; sizes in 4-pel units.  lst selects the
        motion field (list 0 / list 1 for B slices)."""
        gx = mx * 4 + part_x
        gy = my * 4 + part_y
        mv_f = self.mv if lst == 0 else self.mv1
        ref_f = self.ref if lst == 0 else self.ref1

        def nb(bx, by):
            """-> (avail, mv, ref)"""
            if not self._blk_avail(bx, by):
                return False, np.zeros(2, np.int32), -1
            # intra / not-using-this-list neighbors: available, ref -1, mv 0
            rr = int(ref_f[by, bx])
            return True, (mv_f[by, bx] if rr >= 0
                          else np.zeros(2, np.int32)), rr

        availA, mvA, refA = nb(gx - 1, gy)
        availB, mvB, refB = nb(gx, gy - 1)
        availC, mvC, refC = nb(gx + part_w, gy - 1)
        if not availC:
            availC, mvC, refC = nb(gx - 1, gy - 1)  # D

        # directional for 16x8 / 8x16 (§8.4.1.3.1)
        if part_w == 4 and part_h == 2:  # 16x8
            if part_y == 0 and availB and refB == ref_idx:
                return mvB.copy()
            if part_y == 2 and availA and refA == ref_idx:
                return mvA.copy()
        elif part_w == 2 and part_h == 4:  # 8x16
            if part_x == 0 and availA and refA == ref_idx:
                return mvA.copy()
            if part_x == 2 and availC and refC == ref_idx:
                return mvC.copy()

        if availA and not availB and not availC:
            return mvA.copy()
        match = [(availA and refA == ref_idx), (availB and refB == ref_idx),
                 (availC and refC == ref_idx)]
        if sum(match) == 1:
            return [mvA, mvB, mvC][match.index(True)].copy()
        mvs = np.stack([mvA if availA else np.zeros(2, np.int32),
                        mvB if availB else np.zeros(2, np.int32),
                        mvC if availC else np.zeros(2, np.int32)])
        return np.median(mvs, axis=0).astype(np.int32)

    def _decode_p_skip(self, mx: int, my: int) -> None:
        qp = self.qp
        self.qp_map[my, mx] = qp
        # P_Skip mv derivation (§8.4.1.1)
        gx, gy = mx * 4, my * 4

        def nb(bx, by):
            if not self._blk_avail(bx, by):
                return False, np.zeros(2, np.int32), -1
            return True, self.mv[by, bx], int(self.ref[by, bx])

        availA, mvA, refA = nb(gx - 1, gy)
        availB, mvB, refB = nb(gx, gy - 1)
        if (not availA or not availB or
                (refA == 0 and mvA[0] == 0 and mvA[1] == 0) or
                (refB == 0 and mvB[0] == 0 and mvB[1] == 0)):
            mv = np.zeros(2, np.int32)
        else:
            mv = self._mv_pred(mx, my, 0, 0, 4, 4, 0)
        self.mb_type[my, mx] = 1000  # P_Skip marker (>=0 means decoded)
        self._inter_recon_16x16(mx, my, mv, 0)
        self._set_motion(mx, my, (0, 0, 4, 4), True, False, mv, 0, None, None)
        self.tc_luma[gy:gy + 4, gx:gx + 4] = 0
        self.tc_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0

    def _mc_pred(self, ref: Frame, x0: int, y0: int, pw: int, ph: int,
                 mv: np.ndarray):
        """Interpolated (y, u, v) prediction arrays for one partition."""
        py_ = luma_mc(ref.y, x0, y0, int(mv[0]), int(mv[1]), pw, ph)
        cx, cy, cw, ch = x0 // 2, y0 // 2, pw // 2, ph // 2
        pu = chroma_mc(ref.u, cx, cy, int(mv[0]), int(mv[1]), cw, ch)
        pv = chroma_mc(ref.v, cx, cy, int(mv[0]), int(mv[1]), cw, ch)
        return py_, pu, pv

    # ------------------------------------------------ weighted prediction
    def _wp_explicit(self, lst: int):
        """Explicit WP tables for one list, or (None, None) when inactive
        (§8.4.2.3.3: P + weighted_pred_flag, or B + weighted_bipred_idc 1)."""
        h = self.h
        active = ((h.is_p() and self.pps.weighted_pred_flag)
                  or (h.is_b() and self.pps.weighted_bipred_idc == 1))
        if not active:
            return None, None
        if lst == 0:
            return h.luma_weights_l0, h.chroma_weights_l0
        return h.luma_weights_l1, h.chroma_weights_l1

    @staticmethod
    def _wp_scale(plane: np.ndarray, w: int, o: int, d: int) -> np.ndarray:
        p = plane.astype(np.int64)
        p = ((p * w + ((1 << d) >> 1)) >> d) if d > 0 else p * w
        return np.clip(p + o, 0, 255)

    def _wp_apply_uni(self, gy, gu, gv, lst: int, ref_idx: int):
        lw, cw = self._wp_explicit(lst)
        if lw is None:
            return gy, gu, gv
        h = self.h
        if ref_idx < len(lw) and lw[ref_idx] is not None:
            w, o = lw[ref_idx]
            gy = self._wp_scale(gy, w, o, h.luma_log2_weight_denom)
        if cw and ref_idx < len(cw) and cw[ref_idx] is not None:
            d = h.chroma_log2_weight_denom
            (wu, ou), (wv, ov) = cw[ref_idx]
            gu = self._wp_scale(gu, wu, ou, d)
            gv = self._wp_scale(gv, wv, ov, d)
        return gy, gu, gv

    @staticmethod
    def _trunc_div(a: int, b: int) -> int:
        """Integer division truncating toward zero (spec '/' operator)."""
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    def _implicit_weights(self, ref0: int, ref1: int) -> tuple[int, int]:
        """Implicit bi-prediction weights (§8.4.2.3.1, bipred_idc == 2)."""
        f0, f1 = self.ref_list0[ref0], self.ref_list1[ref1]
        if f0.poc == f1.poc or f0.long_term or f1.long_term:
            return 32, 32
        tb = min(max(self.poc - f0.poc, -128), 127)
        td = min(max(f1.poc - f0.poc, -128), 127)
        tx = self._trunc_div(16384 + (abs(td) >> 1), td)
        dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return 32, 32
        return 64 - w1, w1

    def _bi_combine(self, a, b, ref0: int, ref1: int):
        """Combine L0/L1 predictions for one bi-predicted partition."""
        h = self.h
        idc = self.pps.weighted_bipred_idc
        if h.is_b() and idc == 2:
            w0, w1 = self._implicit_weights(ref0, ref1)
            def mix(p0, p1):
                return np.clip(
                    (p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
                     + 32) >> 6, 0, 255)
            return tuple(mix(a[i], b[i]) for i in range(3))
        if h.is_b() and idc == 1:
            dl, dc = h.luma_log2_weight_denom, h.chroma_log2_weight_denom

            def ent(tbl, ref, d):
                if tbl and ref < len(tbl) and tbl[ref] is not None:
                    return tbl[ref]
                return (1 << d, 0)

            def mix(p0, p1, w0, o0, w1, o1, d):
                return np.clip(
                    ((p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
                      + (1 << d)) >> (d + 1)) + ((o0 + o1 + 1) >> 1), 0, 255)

            wy0, oy0 = ent(h.luma_weights_l0, ref0, dl)
            wy1, oy1 = ent(h.luma_weights_l1, ref1, dl)
            cu0, cv0 = (ent(h.chroma_weights_l0, ref0, dc)
                        if (h.chroma_weights_l0 and ref0 < len(h.chroma_weights_l0)
                            and h.chroma_weights_l0[ref0] is not None)
                        else ((1 << dc, 0), (1 << dc, 0)))
            cu1, cv1 = (ent(h.chroma_weights_l1, ref1, dc)
                        if (h.chroma_weights_l1 and ref1 < len(h.chroma_weights_l1)
                            and h.chroma_weights_l1[ref1] is not None)
                        else ((1 << dc, 0), (1 << dc, 0)))
            return (mix(a[0], b[0], wy0, oy0, wy1, oy1, dl),
                    mix(a[1], b[1], cu0[0], cu0[1], cu1[0], cu1[1], dc),
                    mix(a[2], b[2], cv0[0], cv0[1], cv1[0], cv1[1], dc))
        return tuple((a[i].astype(np.int32) + b[i] + 1) >> 1 for i in range(3))

    def _inter_recon_16x16(self, mx: int, my: int, mv: np.ndarray, ref_idx: int,
                           part: tuple[int, int, int, int] = (0, 0, 16, 16),
                           lst: int = 0) -> None:
        """Motion-compensate one uni-directional partition into self planes."""
        px, py, pw, ph = part
        ref = (self.ref_list0 if lst == 0 else self.ref_list1)[ref_idx]
        x0, y0 = mx * 16 + px, my * 16 + py
        gy, gu, gv = self._mc_pred(ref, x0, y0, pw, ph, mv)
        gy, gu, gv = self._wp_apply_uni(gy, gu, gv, lst, ref_idx)
        cx, cy, cw, ch = x0 // 2, y0 // 2, pw // 2, ph // 2
        self.y[y0:y0 + ph, x0:x0 + pw] = gy
        self.u[cy:cy + ch, cx:cx + cw] = gu
        self.v[cy:cy + ch, cx:cx + cw] = gv

    def _inter_recon_b(self, mx: int, my: int, part, flag0, flag1,
                       mv0, ref0, mv1, ref1) -> None:
        """B partition MC: L0-only / L1-only / bi-prediction with default,
        implicit (idc 2), or explicit (idc 1) weighting (§8.4.2.3)."""
        px, py, pw, ph = part
        x0, y0 = mx * 16 + px, my * 16 + py
        cx, cy, cw, ch = x0 // 2, y0 // 2, pw // 2, ph // 2
        if flag0 and flag1:
            a = self._mc_pred(self.ref_list0[ref0], x0, y0, pw, ph, mv0)
            b = self._mc_pred(self.ref_list1[ref1], x0, y0, pw, ph, mv1)
            gy, gu, gv = self._bi_combine(a, b, ref0, ref1)
        elif flag0:
            gy, gu, gv = self._mc_pred(self.ref_list0[ref0], x0, y0, pw, ph, mv0)
            gy, gu, gv = self._wp_apply_uni(gy, gu, gv, 0, ref0)
        else:
            gy, gu, gv = self._mc_pred(self.ref_list1[ref1], x0, y0, pw, ph, mv1)
            gy, gu, gv = self._wp_apply_uni(gy, gu, gv, 1, ref1)
        self.y[y0:y0 + ph, x0:x0 + pw] = gy
        self.u[cy:cy + ch, cx:cx + cw] = gu
        self.v[cy:cy + ch, cx:cx + cw] = gv

    def _set_motion(self, mx, my, part, flag0, flag1, mv0, ref0, mv1, ref1):
        """Record per-4x4 motion/ref fields + ref-picture ids for one
        partition (part in 4-pel units relative to the MB)."""
        px, py, pw, ph = part
        gx, gy = mx * 4 + px, my * 4 + py
        sl = np.s_[gy:gy + ph, gx:gx + pw]
        if flag0:
            self.mv[sl] = mv0
            self.ref[sl] = ref0
            self.refpic[0][sl] = id(self.ref_list0[ref0]) % (1 << 62)
        else:
            self.mv[sl] = 0
            self.ref[sl] = -1
            self.refpic[0][sl] = -1
        if flag1:
            self.mv1[sl] = mv1
            self.ref1[sl] = ref1
            self.refpic[1][sl] = id(self.ref_list1[ref1]) % (1 << 62)
        else:
            self.mv1[sl] = 0
            self.ref1[sl] = -1
            self.refpic[1][sl] = -1
        self.blk_done[sl] = True

    def _decode_inter_residual(self, r: BitReader, mx: int, my: int,
                               cbp_luma: int, qp: int) -> None:
        x0, y0 = mx * 16, my * 16
        for blk in range(16):
            bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
            gx, gy = mx * 4 + bx, my * 4 + by
            if cbp_luma & (1 << (blk // 4)):
                nc = self._nc_luma(gx, gy)
                lv = decode_residual_block(r, nc, 16)
                self.collect["levels"][my * self.mbw + mx, blk] = lv
                self.tc_luma[gy, gx] = int(np.count_nonzero(lv))
                blkc = tnp.zigzag_unscan(lv.reshape(1, 16))[0]
                d = tnp.dequant4x4(blkc.reshape(1, 4, 4), qp)
                res = tnp.idct4x4_core(d)[0]
                px, py = x0 + bx * 4, y0 + by * 4
                self.y[py:py + 4, px:px + 4] = np.clip(
                    self.y[py:py + 4, px:px + 4] + res, 0, 255)
            else:
                self.tc_luma[gy, gx] = 0

    def _apply_chroma_residual(self, *a, **k):  # pragma: no cover - unused stub
        raise NotImplementedError

    # ------------------------------------------------------------- B MBs
    def _b_direct_motion(self, mx: int, my: int):
        """Direct luma motion with direct_8x8_inference: spatial
        (§8.4.1.2.2) or temporal (§8.4.1.2.3) per the slice header flag.
        Returns (flag0, flag1, r0q, r1q, mv0q, mv1q) with per-8x8-quadrant
        refs r*q (2, 2) and MVs mv*q (2, 2, 2) [qy, qx, xy]."""
        if not self.h.direct_spatial_mv_pred_flag:
            return self._b_direct_motion_temporal(mx, my)
        gx, gy = mx * 4, my * 4

        def nb(ref_f, bx, by):
            avail = self._blk_avail(bx, by)
            return avail, (int(ref_f[by, bx]) if avail else -1)

        def minpos(a, b):
            return min(a, b) if (a >= 0 and b >= 0) else max(a, b)

        refs = []
        for ref_f in (self.ref, self.ref1):
            _, rA = nb(ref_f, gx - 1, gy)
            availC, rC = nb(ref_f, gx + 4, gy - 1)
            if not availC:
                _, rC = nb(ref_f, gx - 1, gy - 1)   # D substitutes
            _, rB = nb(ref_f, gx, gy - 1)
            refs.append(minpos(minpos(rA, rB), rC))
        ref0, ref1 = refs
        z = np.zeros((2, 2, 2), np.int32)
        zr = np.zeros((2, 2), np.int32)
        if ref0 < 0 and ref1 < 0:
            # directZeroPredictionFlag: bi(0,0) with refIdx 0,0
            return True, True, zr, zr, z, z
        mvp0 = (self._mv_pred(mx, my, 0, 0, 4, 4, ref0, 0)
                if ref0 >= 0 else np.zeros(2, np.int32))
        mvp1 = (self._mv_pred(mx, my, 0, 0, 4, 4, ref1, 1)
                if ref1 >= 0 else np.zeros(2, np.int32))
        col = self.ref_list1[0]
        mv0q = np.zeros((2, 2, 2), np.int32)
        mv1q = np.zeros((2, 2, 2), np.int32)
        for qy in (0, 1):
            for qx in (0, 1):
                cbx, cby = gx + 3 * qx, gy + 3 * qy   # corner 4x4 of quadrant
                colref = int(col.refs[cby, cbx]) if col.refs is not None else -1
                if colref < 0 and getattr(col, "refs1", None) is not None:
                    colref = int(col.refs1[cby, cbx])
                    colmv = col.mvs1[cby, cbx]
                else:
                    colmv = (col.mvs[cby, cbx] if col.mvs is not None
                             else np.zeros(2, np.int32))
                colzero = (colref == 0 and abs(int(colmv[0])) <= 1
                           and abs(int(colmv[1])) <= 1)
                mv0q[qy, qx] = 0 if (ref0 == 0 and colzero) else mvp0
                mv1q[qy, qx] = 0 if (ref1 == 0 and colzero) else mvp1
        return (ref0 >= 0, ref1 >= 0, zr + max(ref0, 0), zr + max(ref1, 0),
                mv0q, mv1q)

    def _b_direct_motion_temporal(self, mx: int, my: int):
        """Temporal direct (§8.4.1.2.3): scale the colocated picture's
        motion by POC distances; L0 ref maps by picture identity."""
        gx, gy = mx * 4, my * 4
        col = self.ref_list1[0]
        ids0 = [id(f) % (1 << 62) for f in self.ref_list0]
        mv0q = np.zeros((2, 2, 2), np.int32)
        mv1q = np.zeros((2, 2, 2), np.int32)
        r0q = np.zeros((2, 2), np.int32)
        for qy in (0, 1):
            for qx in (0, 1):
                cbx, cby = gx + 3 * qx, gy + 3 * qy
                colref = -1
                colmv = np.zeros(2, np.int32)
                colid = -1
                if col.refs is not None and int(col.refs[cby, cbx]) >= 0:
                    colref = int(col.refs[cby, cbx])
                    colmv = col.mvs[cby, cbx]
                    if col.refid0 is not None:
                        colid = int(col.refid0[cby, cbx])
                elif (getattr(col, "refs1", None) is not None
                      and int(col.refs1[cby, cbx]) >= 0):
                    colref = int(col.refs1[cby, cbx])
                    colmv = col.mvs1[cby, cbx]
                    if col.refid1 is not None:
                        colid = int(col.refid1[cby, cbx])
                refIdx = 0
                if colref >= 0 and colid >= 0:
                    for i, fid in enumerate(ids0):
                        if fid == colid:
                            refIdx = i
                            break
                refpic = self.ref_list0[refIdx]
                r0q[qy, qx] = refIdx
                if colref < 0:          # colocated intra: mvCol = 0
                    colmv = np.zeros(2, np.int32)
                td = min(max(col.poc - refpic.poc, -128), 127)
                if refpic.long_term or td == 0:
                    mv0 = colmv.astype(np.int32)
                    mv1 = np.zeros(2, np.int32)
                else:
                    tb = min(max(self.poc - refpic.poc, -128), 127)
                    tx = self._trunc_div(16384 + (abs(td) >> 1), td)
                    dsf = min(max((tb * tx + 32) >> 6, -1024), 1023)
                    mv0 = (dsf * colmv.astype(np.int64) + 128) >> 8
                    mv0 = mv0.astype(np.int32)
                    mv1 = mv0 - colmv
                mv0q[qy, qx] = mv0
                mv1q[qy, qx] = mv1
        return True, True, r0q, np.zeros((2, 2), np.int32), mv0q, mv1q

    def _b_direct_recon(self, mx: int, my: int) -> None:
        f0, f1, r0q, r1q, mv0q, mv1q = self._b_direct_motion(mx, my)
        for qy in (0, 1):
            for qx in (0, 1):
                r0, r1 = int(r0q[qy, qx]), int(r1q[qy, qx])
                self._inter_recon_b(mx, my, (8 * qx, 8 * qy, 8, 8), f0, f1,
                                    mv0q[qy, qx], r0, mv1q[qy, qx], r1)
                self._set_motion(mx, my, (2 * qx, 2 * qy, 2, 2), f0, f1,
                                 mv0q[qy, qx], r0, mv1q[qy, qx], r1)

    def _decode_b_skip(self, mx: int, my: int) -> None:
        self.qp_map[my, mx] = self.qp
        self.mb_type[my, mx] = 1001  # B_Skip marker
        self._b_direct_recon(mx, my)
        gx, gy = mx * 4, my * 4
        self.tc_luma[gy:gy + 4, gx:gx + 4] = 0
        self.tc_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0

    # Table 7-14 list usage for two-partition B types 4..21:
    #   (partition0_lists, partition1_lists), type&1 -> 8x16 else 16x8
    _B2_COMBO = {
        4: ((1, 0), (1, 0)), 5: ((1, 0), (1, 0)),
        6: ((0, 1), (0, 1)), 7: ((0, 1), (0, 1)),
        8: ((1, 0), (0, 1)), 9: ((1, 0), (0, 1)),
        10: ((0, 1), (1, 0)), 11: ((0, 1), (1, 0)),
        12: ((1, 0), (1, 1)), 13: ((1, 0), (1, 1)),
        14: ((0, 1), (1, 1)), 15: ((0, 1), (1, 1)),
        16: ((1, 1), (1, 0)), 17: ((1, 1), (1, 0)),
        18: ((1, 1), (0, 1)), 19: ((1, 1), (0, 1)),
        20: ((1, 1), (1, 1)), 21: ((1, 1), (1, 1)),
    }

    def _decode_b_mb(self, r: BitReader, mx: int, my: int, mb_type: int) -> None:
        h = self.h
        nref = (h.num_ref_idx_l0_active_minus1 + 1,
                h.num_ref_idx_l1_active_minus1 + 1)
        self.mb_type[my, mx] = 200 + mb_type
        self._can_t8 = True

        def read_ref(n):
            if n == 1:
                return 0
            if n == 2:
                return 1 - r.u(1)
            return r.ue()

        if mb_type == 0:                      # B_Direct_16x16
            self._b_direct_recon(mx, my)
        elif mb_type <= 3:                    # 16x16 L0/L1/Bi
            use = (mb_type in (1, 3), mb_type in (2, 3))
            refs = [read_ref(nref[x]) if use[x] else 0 for x in (0, 1)]
            mvs = [np.zeros(2, np.int32), np.zeros(2, np.int32)]
            for x in (0, 1):
                if use[x]:
                    pmv = self._mv_pred(mx, my, 0, 0, 4, 4, refs[x], x)
                    mvs[x] = pmv + np.array([r.se(), r.se()], np.int32)
            self._set_motion(mx, my, (0, 0, 4, 4), use[0], use[1],
                             mvs[0], refs[0], mvs[1], refs[1])
            self._inter_recon_b(mx, my, (0, 0, 16, 16), use[0], use[1],
                                mvs[0], refs[0], mvs[1], refs[1])
        elif mb_type <= 21:                   # two partitions
            combo = self._B2_COMBO[mb_type]
            vert = mb_type & 1                # odd -> 8x16
            parts4 = [(0, 0, 2, 4), (2, 0, 2, 4)] if vert else \
                     [(0, 0, 4, 2), (0, 2, 4, 2)]
            refs = [[0, 0], [0, 0]]           # [part][list]
            for x in (0, 1):
                for p in (0, 1):
                    if combo[p][x]:
                        refs[p][x] = read_ref(nref[x])
            mvs = [[np.zeros(2, np.int32) for _ in range(2)] for _ in range(2)]
            for x in (0, 1):
                for p in (0, 1):
                    if not combo[p][x]:
                        continue
                    px, py, pw, ph = parts4[p]
                    pmv = self._mv_pred(mx, my, px, py, pw, ph, refs[p][x], x)
                    mvs[p][x] = pmv + np.array([r.se(), r.se()], np.int32)
                    # store progressively: partition 1's prediction sees
                    # partition 0's decoded motion (this list only)
                    gx, gy = mx * 4 + px, my * 4 + py
                    sl = np.s_[gy:gy + ph, gx:gx + pw]
                    if x == 0:
                        self.mv[sl] = mvs[p][x]
                        self.ref[sl] = refs[p][x]
                    else:
                        self.mv1[sl] = mvs[p][x]
                        self.ref1[sl] = refs[p][x]
                    self.blk_done[sl] = True
            for p in (0, 1):
                px, py, pw, ph = parts4[p]
                self._set_motion(mx, my, parts4[p], combo[p][0], combo[p][1],
                                 mvs[p][0], refs[p][0], mvs[p][1], refs[p][1])
                self._inter_recon_b(mx, my, (px * 4, py * 4, pw * 4, ph * 4),
                                    combo[p][0], combo[p][1],
                                    mvs[p][0], refs[p][0], mvs[p][1], refs[p][1])
        elif mb_type == 22:                   # B_8x8
            self._decode_b_8x8(r, mx, my, nref, read_ref)
        else:
            raise ValueError(f"invalid B mb_type {mb_type}")
        self._inter_mb_tail(r, mx, my)

    # sub_mb_type tables (Table 7-18): list usage and partition geometry
    # (4-pel units inside the 8x8 block)
    _BSUB_LISTS = {1: (1, 0), 2: (0, 1), 3: (1, 1), 4: (1, 0), 5: (1, 0),
                   6: (0, 1), 7: (0, 1), 8: (1, 1), 9: (1, 1), 10: (1, 0),
                   11: (0, 1), 12: (1, 1)}
    _BSUB_PARTS = {
        1: [(0, 0, 2, 2)], 2: [(0, 0, 2, 2)], 3: [(0, 0, 2, 2)],
        4: [(0, 0, 2, 1), (0, 1, 2, 1)], 6: [(0, 0, 2, 1), (0, 1, 2, 1)],
        8: [(0, 0, 2, 1), (0, 1, 2, 1)],
        5: [(0, 0, 1, 2), (1, 0, 1, 2)], 7: [(0, 0, 1, 2), (1, 0, 1, 2)],
        9: [(0, 0, 1, 2), (1, 0, 1, 2)],
        10: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
        11: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
        12: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
    }

    def _decode_b_8x8(self, r: BitReader, mx: int, my: int, nref,
                      read_ref) -> None:
        """B_8x8 sub-macroblock prediction (§7.3.5.2 + Table 7-18)."""
        subt = [r.ue() for _ in range(4)]
        if any(s > 12 for s in subt):
            raise ValueError(f"invalid B sub_mb_type {subt}")
        # 8x8 transform allowed only when every sub-part is >= 8x8
        self._can_t8 = all(s <= 3 for s in subt)
        refs = [[0, 0] for _ in range(4)]
        for x in (0, 1):
            for sb in range(4):
                st = subt[sb]
                if st != 0 and self._BSUB_LISTS[st][x]:
                    refs[sb][x] = read_ref(nref[x])
        # direct motion derives from MB-external neighbors only, so it is
        # safe (and required, for x264 parity) to compute it up front
        direct = (self._b_direct_motion(mx, my)
                  if any(s == 0 for s in subt) else None)
        # mvd parse order: every L0 mvd, then every L1 mvd (§7.3.5.2) —
        # raw values only; MV *derivation* happens afterwards in
        # sub-block order so each partition's predictor sees every
        # earlier partition (including direct subs) of this MB (§8.4.1)
        mvd_raw = [[None] * 4, [None] * 4]   # [list][sb] -> [mvd per part]
        for x in (0, 1):
            for sb in range(4):
                st = subt[sb]
                if st == 0 or not self._BSUB_LISTS[st][x]:
                    continue
                mvd_raw[x][sb] = [np.array([r.se(), r.se()], np.int32)
                                  for _ in self._BSUB_PARTS[st]]
        # derivation + reconstruction per sub-block, in order
        for sb in range(4):
            st = subt[sb]
            sbx, sby = (sb & 1) * 2, (sb >> 1) * 2
            qx, qy = sb & 1, sb >> 1
            if st == 0:
                f0, f1, r0q, r1q, mv0q, mv1q = direct
                r0, r1 = int(r0q[qy, qx]), int(r1q[qy, qx])
                self._set_motion(mx, my, (sbx, sby, 2, 2), f0, f1,
                                 mv0q[qy, qx], r0, mv1q[qy, qx], r1)
                self._inter_recon_b(mx, my, (8 * qx, 8 * qy, 8, 8), f0, f1,
                                    mv0q[qy, qx], r0, mv1q[qy, qx], r1)
                continue
            use = self._BSUB_LISTS[st]
            for pi, (ox, oy, pw, ph) in enumerate(self._BSUB_PARTS[st]):
                px, py = sbx + ox, sby + oy
                mvp = [None, None]
                for x in (0, 1):
                    if use[x]:
                        pmv = self._mv_pred(mx, my, px, py, pw, ph,
                                            refs[sb][x], x)
                        mvp[x] = pmv + mvd_raw[x][sb][pi]
                self._set_motion(mx, my, (px, py, pw, ph), use[0], use[1],
                                 mvp[0], refs[sb][0], mvp[1], refs[sb][1])
                self._inter_recon_b(mx, my, (px * 4, py * 4, pw * 4, ph * 4),
                                    use[0], use[1], mvp[0], refs[sb][0],
                                    mvp[1], refs[sb][1])

    # ---------------------------------------------------------------- MB
    def _decode_mb(self, r: BitReader, mx: int, my: int) -> None:
        h = self.h
        mb_type = r.ue()
        intra_offset = 5 if h.is_p() else (23 if h.is_b() else 0)
        if h.is_p() and mb_type < 5:
            self._decode_p_mb(r, mx, my, mb_type)
            return
        if h.is_b() and mb_type < 23:
            self._decode_b_mb(r, mx, my, mb_type)
            return
        it = mb_type - intra_offset
        if h.is_p() or h.is_b():
            self.collect["eligible"] = False
        if it == I_PCM:
            self._decode_i_pcm(r, mx, my)
            return
        self.mb_type[my, mx] = it

        if it == I_NXN:
            if self.pps.transform_8x8_mode_flag and r.u(1):
                self._decode_mb_i8x8(r, mx, my)
                return
            modes = np.zeros(16, dtype=np.int32)
            for blk in range(16):
                modes[blk] = self._parse_i4_mode(r, mx, my, blk, modes)
            chroma_mode = r.ue()
            code = r.ue()
            cbp = int(CBP_FROM_CODE[code][0])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
            if cbp != 0:
                self.qp += _parse_qp_delta(r)
            self.qp_map[my, mx] = self.qp
            qp = self.qp
            qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
            # record modes for later mode prediction
            for blk in range(16):
                gx, gy = mx * 4 + int(BLK_X[blk]), my * 4 + int(BLK_Y[blk])
                self.i4_modes[gy, gx] = modes[blk]
            self._decode_intra4x4(r, mx, my, modes, cbp_luma, qp)
            preds = self._chroma_pred_pair(mx, my, chroma_mode)
            resid = self._parse_chroma_residuals(r, mx, my, cbp_chroma)
            self._recon_chroma(preds, resid, mx, my, qpc)
        else:
            pred_mode, cbp_chroma, cbp_luma = parse_i16x16_mb_type(it)
            chroma_mode = r.ue()
            self.qp += _parse_qp_delta(r)
            self.qp_map[my, mx] = self.qp
            qp = self.qp
            qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
            self._decode_intra16x16(r, mx, my, pred_mode, cbp_luma, cbp_chroma, qp)
            preds = self._chroma_pred_pair(mx, my, chroma_mode)
            resid = self._parse_chroma_residuals(r, mx, my, cbp_chroma)
            self._recon_chroma(preds, resid, mx, my, qpc)
        # intra MB: motion field marked intra
        gx, gy = mx * 4, my * 4
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    def _decode_i_pcm(self, r: BitReader, mx: int, my: int) -> None:
        """I_PCM macroblock (§7.3.5 pcm_sample path, §8.3.5): raw samples,
        byte-aligned; QPY becomes 0 and nC contexts read as 16."""
        self.mb_type[my, mx] = I_PCM
        while r.bit_position % 8:
            if r.u(1):
                raise ValueError("pcm_alignment_zero_bit not zero")
        x0, y0 = mx * 16, my * 16
        self.y[y0:y0 + 16, x0:x0 + 16] = np.array(
            [r.u(8) for _ in range(256)], np.int32).reshape(16, 16)
        xc, yc = mx * 8, my * 8
        for plane in (self.u, self.v):
            plane[yc:yc + 8, xc:xc + 8] = np.array(
                [r.u(8) for _ in range(64)], np.int32).reshape(8, 8)
        # QP prediction for subsequent MBs continues from 0 (§7.4.5)
        self.qp = 0
        self.qp_map[my, mx] = 0
        gx, gy = mx * 4, my * 4
        self.tc_luma[gy:gy + 4, gx:gx + 4] = 16
        self.tc_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
        self.i4_modes[gy:gy + 4, gx:gx + 4] = -1
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    # --------------------------------------- High profile 8x8 transform
    def _i8_pred_mode(self, mx: int, my: int, blk: int,
                      modes8: np.ndarray) -> int:
        """§8.3.2.1 predIntra8x8PredMode: min of the neighbor blocks'
        modes (replicated 4x4 cache convention), DC when unavailable."""
        bx, by = blk & 1, blk >> 1
        gx, gy = mx * 4 + bx * 2, my * 4 + by * 2

        def nb_mode(nbx, nby, in_mb):
            if in_mb is not None:
                return int(in_mb)
            if nbx < 0 or nby < 0:
                return None
            if not self.mb_avail(nbx // 4, nby // 4):
                return None
            m = int(self.i4_modes[nby, nbx])
            return m if m >= 0 else 2
        left_in = modes8[blk - 1] if bx > 0 else None
        top_in = modes8[blk - 2] if by > 0 else None
        mA = nb_mode(gx - 1, gy, left_in)
        mB = nb_mode(gx, gy - 1, top_in)
        return 2 if (mA is None or mB is None) else min(mA, mB)

    def _decode_mb_i8x8(self, r: BitReader, mx: int, my: int) -> None:
        """I_NxN with transform_size_8x8_flag == 1 (CAVLC)."""
        self.mb_type[my, mx] = I_NXN
        self.t8x8[my, mx] = True
        modes8 = np.zeros(4, dtype=np.int32)
        for blk in range(4):
            pred = self._i8_pred_mode(mx, my, blk, modes8)
            if r.u(1):
                modes8[blk] = pred
            else:
                rem = r.u(3)
                modes8[blk] = rem if rem < pred else rem + 1
        chroma_mode = r.ue()
        code = r.ue()
        cbp = int(CBP_FROM_CODE[code][0])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp != 0:
            self.qp += _parse_qp_delta(r)
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        for blk in range(4):
            bx, by = blk & 1, blk >> 1
            self.i4_modes[my * 4 + by * 2:my * 4 + by * 2 + 2,
                          mx * 4 + bx * 2:mx * 4 + bx * 2 + 2] = modes8[blk]
        lv64 = self._parse_luma8x8_cavlc(r, mx, my, cbp_luma)
        for blk in range(4):
            self._recon_i8_block(mx, my, blk, int(modes8[blk]),
                                 lv64[blk], qp)
        preds = self._chroma_pred_pair(mx, my, chroma_mode)
        resid = self._parse_chroma_residuals(r, mx, my, cbp_chroma)
        self._recon_chroma(preds, resid, mx, my, qpc)
        gx, gy = mx * 4, my * 4
        self.mv[gy:gy + 4, gx:gx + 4] = 0
        self.ref[gy:gy + 4, gx:gx + 4] = -1
        self.blk_done[gy:gy + 4, gx:gx + 4] = True

    def _parse_luma8x8_cavlc(self, r: BitReader, mx: int, my: int,
                             cbp_luma: int) -> np.ndarray:
        """CAVLC luma residual of an 8x8-transform MB: each coded 8x8
        block is sent as 4 interleaved 4x4 CAVLC blocks — sub-block b
        holds scan positions 4*j + b of the 8x8 zigzag (§7.4.5.3.3).
        Returns (4, 64) scan-order levels, and maintains the per-4x4
        total_coeff contexts + 8x8 coded map."""
        lv64 = np.zeros((4, 64), np.int32)
        for b8 in range(4):
            b8x, b8y = b8 & 1, b8 >> 1
            if not (cbp_luma >> b8) & 1:
                self.tc_luma[my * 4 + b8y * 2:my * 4 + b8y * 2 + 2,
                             mx * 4 + b8x * 2:mx * 4 + b8x * 2 + 2] = 0
                continue
            for sub in range(4):
                sbx, sby = sub & 1, sub >> 1
                gx = mx * 4 + b8x * 2 + sbx
                gy = my * 4 + b8y * 2 + sby
                nc = self._nc_luma(gx, gy)
                lv = decode_residual_block(r, nc, 16)
                self.tc_luma[gy, gx] = int(np.count_nonzero(lv))
                lv64[b8, sub::4] = lv
            self.t8_coded[my * 2 + b8y, mx * 2 + b8x] = bool(
                lv64[b8].any())
        return lv64

    def _recon_i8_block(self, mx: int, my: int, b8: int, mode: int,
                        lv: np.ndarray, qp: int) -> None:
        """Reconstruct one Intra_8x8 luma block from scan-order levels."""
        bx, by = b8 & 1, b8 >> 1
        x0, y0 = mx * 16 + bx * 8, my * 16 + by * 8
        availB = (y0 > 0) and (by > 0 or self.mb_avail(mx, my - 1))
        availA = (x0 > 0) and (bx > 0 or self.mb_avail(mx - 1, my))
        if bx > 0 and by > 0:
            availD = True
        elif by == 0 and bx > 0:
            availD = self.mb_avail(mx, my - 1)
        elif bx == 0 and by > 0:
            availD = self.mb_avail(mx - 1, my)
        else:
            availD = self.mb_avail(mx - 1, my - 1)
        availD = availD and x0 > 0 and y0 > 0
        # top-right 8 samples (§6.4.11 block order): b8 0 -> above MB,
        # 1 -> above-right MB, 2 -> inside MB (block 1's bottom), 3 -> off
        if b8 == 0:
            availC = self.mb_avail(mx, my - 1)
        elif b8 == 1:
            availC = self.mb_avail(mx + 1, my - 1)
        elif b8 == 2:
            availC = True
        else:
            availC = False
        availC = availC and availB and x0 + 16 <= self.mbw * 16
        top = self.y[y0 - 1, x0:x0 + 8].copy() if availB else None
        tr = (self.y[y0 - 1, x0 + 8:x0 + 16].copy()
              if (availB and availC) else None)
        left = self.y[y0:y0 + 8, x0 - 1].copy() if availA else None
        tl = int(self.y[y0 - 1, x0 - 1]) if availD else None
        pred = ipred.pred8x8(mode, top, tr, left, tl)
        if lv.any():
            d = tnp.dequant8x8(tnp.zigzag8x8_unscan(lv), qp)
            res = tnp.idct8x8_core(d)
        else:
            res = 0
        self.y[y0:y0 + 8, x0:x0 + 8] = np.clip(pred + res, 0, 255)

    def _decode_inter_residual8x8(self, r: BitReader, mx: int, my: int,
                                  cbp_luma: int, qp: int) -> None:
        """Inter MB luma residual with transform_size_8x8_flag == 1."""
        self.t8x8[my, mx] = True
        lv64 = self._parse_luma8x8_cavlc(r, mx, my, cbp_luma)
        for b8 in range(4):
            if not lv64[b8].any():
                continue
            bx, by = b8 & 1, b8 >> 1
            x0, y0 = mx * 16 + bx * 8, my * 16 + by * 8
            d = tnp.dequant8x8(tnp.zigzag8x8_unscan(lv64[b8]), qp)
            res = tnp.idct8x8_core(d)
            self.y[y0:y0 + 8, x0:x0 + 8] = np.clip(
                self.y[y0:y0 + 8, x0:x0 + 8] + res, 0, 255)

    def _chroma_pred_pair(self, mx, my, mode):
        x0, y0 = mx * 8, my * 8
        preds = []
        for plane in (self.u, self.v):
            top = plane[y0 - 1, x0:x0 + 8].copy() if self.mb_avail(mx, my - 1) else None
            left = plane[y0:y0 + 8, x0 - 1].copy() if self.mb_avail(mx - 1, my) else None
            tl = int(plane[y0 - 1, x0 - 1]) if self.mb_avail(mx - 1, my - 1) else None
            preds.append(ipred.pred_chroma8x8(mode, top, left, tl))
        return preds

    def _i4_pred_mode(self, mx: int, my: int, blk: int,
                      modes_sofar: np.ndarray) -> int:
        """§8.3.1.1 predIntra4x4PredMode (entropy-agnostic)."""
        bx, by = int(BLK_X[blk]), int(BLK_Y[blk])
        gx, gy = mx * 4 + bx, my * 4 + by

        def nb_mode(nbx, nby, in_mb_mode):
            if in_mb_mode is not None:
                return int(in_mb_mode)
            if nbx < 0 or nby < 0:
                return None  # unavailable
            if not self.mb_avail(nbx // 4, nby // 4):
                return None  # undecoded or different slice
            m = int(self.i4_modes[nby, nbx])
            return m if m >= 0 else 2  # non-I4x4 neighbor -> DC

        left_in_mb = modes_sofar[RASTER_TO_BLK[by * 4 + bx - 1]] if bx > 0 else None
        top_in_mb = modes_sofar[RASTER_TO_BLK[(by - 1) * 4 + bx]] if by > 0 else None
        mA = nb_mode(gx - 1, gy, left_in_mb)
        mB = nb_mode(gx, gy - 1, top_in_mb)
        return 2 if (mA is None or mB is None) else min(mA, mB)

    def _parse_i4_mode(self, r: BitReader, mx: int, my: int, blk: int,
                       modes_sofar: np.ndarray) -> int:
        pred = self._i4_pred_mode(mx, my, blk, modes_sofar)
        if r.u(1):  # prev_intra4x4_pred_mode_flag
            return pred
        rem = r.u(3)
        return rem if rem < pred else rem + 1

    # ------------------------------------------------------------- P MBs
    def _decode_p_mb(self, r: BitReader, mx: int, my: int, mb_type: int) -> None:
        h = self.h
        nref = h.num_ref_idx_l0_active_minus1 + 1
        self.mb_type[my, mx] = 100 + mb_type  # inter marker
        self._can_t8 = True
        gx, gy = mx * 4, my * 4

        def read_ref():
            if nref == 1:
                return 0
            if nref == 2:
                return 1 - r.u(1)  # te(v) with max 1
            return r.ue()

        if mb_type != P_L0_16X16:
            self.collect["eligible"] = False
        if mb_type == P_L0_16X16:
            ref = read_ref()
            pmv = self._mv_pred(mx, my, 0, 0, 4, 4, ref)
            mvd = np.array([r.se(), r.se()], np.int32)
            mv = pmv + mvd
            self._set_motion(mx, my, (0, 0, 4, 4), True, False,
                             mv, ref, None, None)
            self._inter_recon_16x16(mx, my, mv, ref)
        elif mb_type in (P_L0_L0_16X8, P_L0_L0_8X16):
            refs = [read_ref(), read_ref()]
            for p in range(2):
                if mb_type == P_L0_L0_16X8:
                    px, py, pw, ph = 0, p * 2, 4, 2
                else:
                    px, py, pw, ph = p * 2, 0, 2, 4
                pmv = self._mv_pred(mx, my, px, py, pw, ph, refs[p])
                mvd = np.array([r.se(), r.se()], np.int32)
                mv = pmv + mvd
                self._set_motion(mx, my, (px, py, pw, ph), True, False,
                                 mv, refs[p], None, None)
                self._inter_recon_16x16(mx, my, mv, refs[p],
                                        part=(px * 4, py * 4, pw * 4, ph * 4))
        elif mb_type in (P_8X8, P_8X8REF0):
            sub_types = [r.ue() for _ in range(4)]
            # transform_size_8x8_flag requires no sub-part below 8x8
            self._can_t8 = all(st == 0 for st in sub_types)
            refs = [0, 0, 0, 0]
            if mb_type == P_8X8:
                refs = [read_ref() for _ in range(4)]
            for sb in range(4):
                sbx, sby = (sb & 1) * 2, (sb >> 1) * 2
                st = sub_types[sb]
                if st == 0:  # 8x8
                    parts = [(0, 0, 2, 2)]
                elif st == 1:  # 8x4
                    parts = [(0, 0, 2, 1), (0, 1, 2, 1)]
                elif st == 2:  # 4x8
                    parts = [(0, 0, 1, 2), (1, 0, 1, 2)]
                else:  # 4x4
                    parts = [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)]
                for (ox, oy, pw, ph) in parts:
                    px, py = sbx + ox, sby + oy
                    pmv = self._mv_pred(mx, my, px, py, pw, ph, refs[sb])
                    mvd = np.array([r.se(), r.se()], np.int32)
                    mv = pmv + mvd
                    self._set_motion(mx, my, (px, py, pw, ph), True, False,
                                     mv, refs[sb], None, None)
                    self._inter_recon_16x16(mx, my, mv, refs[sb],
                                            part=(px * 4, py * 4, pw * 4, ph * 4))
        else:
            raise NotImplementedError(f"P mb_type {mb_type}")
        self._inter_mb_tail(r, mx, my)

    def _inter_mb_tail(self, r: BitReader, mx: int, my: int) -> None:
        """Shared inter-MB residual tail: CBP, optional 8x8-transform
        flag, qp_delta, luma + chroma residuals (identical for P/B)."""
        code = r.ue()
        cbp = int(CBP_FROM_CODE[code][1])
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        self.collect["cbp_luma"][my * self.mbw + mx] = cbp_luma
        self.collect["cbp_chroma"][my * self.mbw + mx] = cbp_chroma
        t8 = False
        if (cbp_luma and self.pps.transform_8x8_mode_flag
                and getattr(self, "_can_t8", True)):
            t8 = bool(r.u(1))
        if cbp != 0:
            self.qp += _parse_qp_delta(r)
        self.qp_map[my, mx] = self.qp
        qp = self.qp
        qpc = int(tnp.chroma_qp(qp, self.pps.chroma_qp_index_offset))
        if t8:
            self._decode_inter_residual8x8(r, mx, my, cbp_luma, qp)
        else:
            self._decode_inter_residual(r, mx, my, cbp_luma, qp)
        # chroma: prediction is the MC result already in-plane; treat as pred
        x0, y0 = mx * 8, my * 8
        preds = [self.u[y0:y0 + 8, x0:x0 + 8].copy(),
                 self.v[y0:y0 + 8, x0:x0 + 8].copy()]
        resid = self._parse_chroma_residuals(r, mx, my, cbp_chroma)
        self._recon_chroma(preds, resid, mx, my, qpc)


def _parse_qp_delta(r: BitReader) -> int:
    return r.se()
