# Frozen copy of x264vfw_tpu_torch/bitstream/slice.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""Slice header write/parse (ITU-T H.264 §7.3.3).

The reference obtains slice headers from libx264 (encode) and FFmpeg
(decode); here both directions are native.  Feature scope: progressive
frames, one slice group, CAVLC/CABAC flag passthrough, P/B/I slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader, BitWriter
from .params import PPS, SPS
from .mb_syntax import SLICE_B, SLICE_I, SLICE_P, is_slice_type
from .nal import NAL_SLICE_IDR


@dataclass
class MMCOOp:
    op: int
    args: tuple = ()


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = SLICE_I  # may be +5 variant
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    direct_spatial_mv_pred_flag: int = 1
    ref_pic_list_mod_l0: list = field(default_factory=list)  # (modification_of_pic_nums_idc, value)
    ref_pic_list_mod_l1: list = field(default_factory=list)
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    mmco_ops: list = field(default_factory=list)
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    # pred_weight_table (§7.3.3.2), present in P slices when the PPS sets
    # weighted_pred_flag (and in B slices when weighted_bipred_idc == 1).
    # luma_weights_lX[i] is (w, o) or None (defaults); chroma_weights_lX[i]
    # is ((wCb, oCb), (wCr, oCr)) or None.  The encoder write side emits
    # luma-only L0 tables; the parse side accepts the full syntax.
    luma_log2_weight_denom: int = 6
    chroma_log2_weight_denom: int = 0
    luma_weights_l0: list = field(default_factory=list)
    luma_weights_l1: list = field(default_factory=list)
    chroma_weights_l0: list = field(default_factory=list)
    chroma_weights_l1: list = field(default_factory=list)

    @property
    def type(self) -> int:
        return self.slice_type % 5

    def is_p(self) -> bool:
        return is_slice_type(self.slice_type, SLICE_P)

    def is_b(self) -> bool:
        return is_slice_type(self.slice_type, SLICE_B)

    def is_i(self) -> bool:
        return is_slice_type(self.slice_type, SLICE_I)

    # -- write --
    def write(self, w: BitWriter, sps: SPS, pps: PPS, nal_unit_type: int,
              nal_ref_idc: int) -> None:
        idr = nal_unit_type == NAL_SLICE_IDR
        w.ue(self.first_mb_in_slice)
        w.ue(self.slice_type)
        w.ue(self.pic_parameter_set_id)
        w.u(sps.log2_max_frame_num_minus4 + 4, self.frame_num)
        assert sps.frame_mbs_only_flag
        if idr:
            w.ue(self.idr_pic_id)
        if sps.pic_order_cnt_type == 0:
            w.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4, self.pic_order_cnt_lsb)
        if self.is_b():
            w.u(1, self.direct_spatial_mv_pred_flag)
        if self.is_p() or self.is_b():
            w.u(1, self.num_ref_idx_active_override_flag)
            if self.num_ref_idx_active_override_flag:
                w.ue(self.num_ref_idx_l0_active_minus1)
                if self.is_b():
                    w.ue(self.num_ref_idx_l1_active_minus1)
        # ref_pic_list_modification
        if self.is_p() or self.is_b():
            w.u(1, 1 if self.ref_pic_list_mod_l0 else 0)
            for idc, val in self.ref_pic_list_mod_l0:
                w.ue(idc)
                w.ue(val)
            if self.ref_pic_list_mod_l0:
                w.ue(3)  # end
        if self.is_b():
            w.u(1, 1 if self.ref_pic_list_mod_l1 else 0)
            for idc, val in self.ref_pic_list_mod_l1:
                w.ue(idc)
                w.ue(val)
            if self.ref_pic_list_mod_l1:
                w.ue(3)
        if pps.weighted_pred_flag and self.is_p():
            self._write_pred_weight_table(w, sps)
        if nal_ref_idc != 0:
            if idr:
                w.u(1, self.no_output_of_prior_pics_flag)
                w.u(1, self.long_term_reference_flag)
            else:
                w.u(1, self.adaptive_ref_pic_marking_mode_flag)
                if self.adaptive_ref_pic_marking_mode_flag:
                    for op in self.mmco_ops:
                        w.ue(op.op)
                        for a in op.args:
                            w.ue(a)
                    w.ue(0)  # end
        if pps.entropy_coding_mode_flag and not self.is_i():
            w.ue(self.cabac_init_idc)
        w.se(self.slice_qp_delta)
        if pps.deblocking_filter_control_present_flag:
            w.ue(self.disable_deblocking_filter_idc)
            if self.disable_deblocking_filter_idc != 1:
                w.se(self.slice_alpha_c0_offset_div2)
                w.se(self.slice_beta_offset_div2)

    def _write_pred_weight_table(self, w: BitWriter, sps: SPS) -> None:
        w.ue(self.luma_log2_weight_denom)
        if sps.chroma_format_idc != 0:
            w.ue(self.chroma_log2_weight_denom)
        for i in range(self.num_ref_idx_l0_active_minus1 + 1):
            ent = (self.luma_weights_l0[i]
                   if i < len(self.luma_weights_l0) else None)
            w.u(1, 0 if ent is None else 1)
            if ent is not None:
                w.se(ent[0])
                w.se(ent[1])
            if sps.chroma_format_idc != 0:
                w.u(1, 0)  # chroma_weight_l0_flag: defaults

    def _parse_pred_weight_table(self, r: BitReader, sps: SPS) -> None:
        self.luma_log2_weight_denom = r.ue()
        if sps.chroma_format_idc != 0:
            self.chroma_log2_weight_denom = r.ue()

        def one_list(count: int):
            lw, cw = [], []
            for _ in range(count):
                if r.u(1):
                    lw.append((r.se(), r.se()))
                else:
                    lw.append(None)
                if sps.chroma_format_idc != 0:
                    if r.u(1):
                        cw.append(((r.se(), r.se()), (r.se(), r.se())))
                    else:
                        cw.append(None)
            return lw, cw

        self.luma_weights_l0, self.chroma_weights_l0 = one_list(
            self.num_ref_idx_l0_active_minus1 + 1)
        if self.is_b():
            self.luma_weights_l1, self.chroma_weights_l1 = one_list(
                self.num_ref_idx_l1_active_minus1 + 1)

    # -- parse --
    @classmethod
    def parse(cls, r: BitReader, sps: SPS, pps: PPS, nal_unit_type: int,
              nal_ref_idc: int) -> "SliceHeader":
        idr = nal_unit_type == NAL_SLICE_IDR
        h = cls()
        h.first_mb_in_slice = r.ue()
        h.slice_type = r.ue()
        h.pic_parameter_set_id = r.ue()
        h.frame_num = r.u(sps.log2_max_frame_num_minus4 + 4)
        if not sps.frame_mbs_only_flag:
            raise NotImplementedError("interlaced streams not supported")
        if idr:
            h.idr_pic_id = r.ue()
        if sps.pic_order_cnt_type == 0:
            h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            if pps.bottom_field_pic_order_in_frame_present_flag:
                r.se()  # delta_pic_order_cnt_bottom
        if h.is_b():
            h.direct_spatial_mv_pred_flag = r.u(1)
        if h.is_p() or h.is_b():
            h.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
            h.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_active_minus1
            h.num_ref_idx_active_override_flag = r.u(1)
            if h.num_ref_idx_active_override_flag:
                h.num_ref_idx_l0_active_minus1 = r.ue()
                if h.is_b():
                    h.num_ref_idx_l1_active_minus1 = r.ue()
            if r.u(1):  # ref_pic_list_modification_flag_l0
                while True:
                    idc = r.ue()
                    if idc == 3:
                        break
                    h.ref_pic_list_mod_l0.append((idc, r.ue()))
        if h.is_b():
            if r.u(1):
                while True:
                    idc = r.ue()
                    if idc == 3:
                        break
                    h.ref_pic_list_mod_l1.append((idc, r.ue()))
        if pps.weighted_pred_flag and h.is_p():
            h._parse_pred_weight_table(r, sps)
        if pps.weighted_bipred_idc == 1 and h.is_b():
            h._parse_pred_weight_table(r, sps)
        if nal_ref_idc != 0:
            if idr:
                h.no_output_of_prior_pics_flag = r.u(1)
                h.long_term_reference_flag = r.u(1)
            else:
                h.adaptive_ref_pic_marking_mode_flag = r.u(1)
                if h.adaptive_ref_pic_marking_mode_flag:
                    while True:
                        op = r.ue()
                        if op == 0:
                            break
                        nargs = {1: 1, 2: 1, 3: 2, 4: 1, 5: 0, 6: 1}[op]
                        h.mmco_ops.append(MMCOOp(op, tuple(r.ue() for _ in range(nargs))))
        if pps.entropy_coding_mode_flag and not h.is_i():
            h.cabac_init_idc = r.ue()
        h.slice_qp_delta = r.se()
        if pps.deblocking_filter_control_present_flag:
            h.disable_deblocking_filter_idc = r.ue()
            if h.disable_deblocking_filter_idc != 1:
                h.slice_alpha_c0_offset_div2 = r.se()
                h.slice_beta_offset_div2 = r.se()
        return h
