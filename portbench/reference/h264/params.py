# Frozen copy of x264vfw_tpu_torch/bitstream/params.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""H.264 sequence / picture parameter sets (ITU-T H.264 §7.3.2.1, §7.3.2.2).

The reference obtains SPS/PPS from `x264_encoder_headers`
(reference codec.c:1650) and parses them in its muxers (e.g.
avcC construction, reference output/matroska.c:137-158).  Here both the
writer (encode path) and the parser (decode path, muxers, tests) are native.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitstream import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100

# Extended_SAR
EXTENDED_SAR = 255

# fixed HRD delay field lengths (bits) — shared with the buffering-period SEI
HRD_INIT_DELAY_LEN = 24
HRD_DELAY_LEN = 24
# Table E-1 sample aspect ratios
SAR_TABLE = [
    (0, 0), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
    (20, 11), (32, 11), (80, 33), (18, 11), (15, 11), (64, 33), (160, 99),
    (4, 3), (3, 2), (2, 1),
]


@dataclass
class SPS:
    profile_idc: int = PROFILE_HIGH
    constraint_set0: int = 0
    constraint_set1: int = 0
    constraint_set2: int = 0
    constraint_set3: int = 0
    level_idc: int = 40
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1  # 4:2:0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    log2_max_frame_num_minus4: int = 0
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb_minus4: int = 2
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs_minus1: int = 0
    pic_height_in_map_units_minus1: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    frame_crop_left_offset: int = 0
    frame_crop_right_offset: int = 0
    frame_crop_top_offset: int = 0
    frame_crop_bottom_offset: int = 0
    # VUI
    vui_parameters_present_flag: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_info_present_flag: int = 0
    video_signal_type_present_flag: int = 0
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_description_present_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_loc_info_present_flag: int = 0
    timing_info_present_flag: int = 0
    num_units_in_tick: int = 1
    time_scale: int = 50
    fixed_frame_rate_flag: int = 1
    # NAL HRD (x264 --nal-hrd vbr/cbr, codec.c:917-919 VBV surface):
    # bitrate in bits/s, cpb size in bits; cbr sets the CBR flag
    nal_hrd_present: int = 0
    hrd_bitrate: int = 0
    hrd_cpb_size: int = 0
    hrd_cbr: int = 0

    # -- derived --
    @property
    def width(self) -> int:
        w = (self.pic_width_in_mbs_minus1 + 1) * 16
        if self.frame_cropping_flag:
            w -= 2 * (self.frame_crop_left_offset + self.frame_crop_right_offset)
        return w

    @property
    def height(self) -> int:
        h = (self.pic_height_in_map_units_minus1 + 1) * 16 * (2 - self.frame_mbs_only_flag)
        if self.frame_cropping_flag:
            h -= 2 * (self.frame_crop_top_offset + self.frame_crop_bottom_offset)
        return h

    @property
    def mb_width(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def mb_height(self) -> int:
        return self.pic_height_in_map_units_minus1 + 1

    def _write_vui(self, w: BitWriter) -> None:
        aspect_present = int(self.sar_width > 0 and self.sar_height > 0)
        w.u(1, aspect_present)
        if aspect_present:
            try:
                idc = SAR_TABLE.index((self.sar_width, self.sar_height))
            except ValueError:
                idc = EXTENDED_SAR
            w.u(8, idc)
            if idc == EXTENDED_SAR:
                w.u(16, self.sar_width)
                w.u(16, self.sar_height)
        w.u(1, self.overscan_info_present_flag)
        w.u(1, self.video_signal_type_present_flag)
        if self.video_signal_type_present_flag:
            w.u(3, self.video_format)
            w.u(1, self.video_full_range_flag)
            w.u(1, self.colour_description_present_flag)
            if self.colour_description_present_flag:
                w.u(8, self.colour_primaries)
                w.u(8, self.transfer_characteristics)
                w.u(8, self.matrix_coefficients)
        w.u(1, self.chroma_loc_info_present_flag)
        w.u(1, self.timing_info_present_flag)
        if self.timing_info_present_flag:
            w.u(32, self.num_units_in_tick)
            w.u(32, self.time_scale)
            w.u(1, self.fixed_frame_rate_flag)
        w.u(1, self.nal_hrd_present)  # nal_hrd_parameters_present_flag
        if self.nal_hrd_present:
            self._write_hrd(w)
        w.u(1, 0)  # vcl_hrd_parameters_present_flag
        if self.nal_hrd_present:
            w.u(1, 0)  # low_delay_hrd_flag
        w.u(1, 0)  # pic_struct_present_flag
        w.u(1, 0)  # bitstream_restriction_flag

    def _write_hrd(self, w: BitWriter) -> None:
        """hrd_parameters() (§E.1.2): one CPB, scales chosen so the
        signaled value loses no precision (x264's scale fitting)."""
        def scale_of(x: int, base: int) -> tuple[int, int]:
            s = 0
            while s < 15 and x % (1 << (base + s + 1)) == 0:
                s += 1
            return s, (x >> (base + s)) - 1
        br_scale, br_val = scale_of(max(self.hrd_bitrate, 64), 6)
        cpb_scale, cpb_val = scale_of(max(self.hrd_cpb_size, 16), 4)
        w.ue(0)            # cpb_cnt_minus1
        w.u(4, br_scale)
        w.u(4, cpb_scale)
        w.ue(br_val)
        w.ue(cpb_val)
        w.u(1, self.hrd_cbr)
        w.u(5, HRD_INIT_DELAY_LEN - 1)   # initial_cpb_removal_delay_length
        w.u(5, HRD_DELAY_LEN - 1)        # cpb_removal_delay_length
        w.u(5, HRD_DELAY_LEN - 1)        # dpb_output_delay_length
        w.u(5, 0)                        # time_offset_length

    def to_rbsp(self) -> np.ndarray:
        w = BitWriter()
        w.u(8, self.profile_idc)
        w.u(1, self.constraint_set0)
        w.u(1, self.constraint_set1)
        w.u(1, self.constraint_set2)
        w.u(1, self.constraint_set3)
        w.u(4, 0)  # reserved
        w.u(8, self.level_idc)
        w.ue(self.seq_parameter_set_id)
        if self.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            w.ue(self.chroma_format_idc)
            w.ue(self.bit_depth_luma_minus8)
            w.ue(self.bit_depth_chroma_minus8)
            w.u(1, self.qpprime_y_zero_transform_bypass_flag)
            w.u(1, self.seq_scaling_matrix_present_flag)
        w.ue(self.log2_max_frame_num_minus4)
        w.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            w.ue(self.log2_max_pic_order_cnt_lsb_minus4)
        elif self.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1 not used")
        w.ue(self.max_num_ref_frames)
        w.u(1, self.gaps_in_frame_num_value_allowed_flag)
        w.ue(self.pic_width_in_mbs_minus1)
        w.ue(self.pic_height_in_map_units_minus1)
        w.u(1, self.frame_mbs_only_flag)
        if not self.frame_mbs_only_flag:
            w.u(1, self.mb_adaptive_frame_field_flag)
        w.u(1, self.direct_8x8_inference_flag)
        w.u(1, self.frame_cropping_flag)
        if self.frame_cropping_flag:
            w.ue(self.frame_crop_left_offset)
            w.ue(self.frame_crop_right_offset)
            w.ue(self.frame_crop_top_offset)
            w.ue(self.frame_crop_bottom_offset)
        w.u(1, self.vui_parameters_present_flag)
        if self.vui_parameters_present_flag:
            self._write_vui(w)
        w.rbsp_trailing_bits()
        return w.to_rbsp()

    @classmethod
    def from_rbsp(cls, rbsp: bytes | np.ndarray) -> "SPS":
        r = BitReader(rbsp)
        s = cls()
        s.profile_idc = r.u(8)
        s.constraint_set0 = r.u(1)
        s.constraint_set1 = r.u(1)
        s.constraint_set2 = r.u(1)
        s.constraint_set3 = r.u(1)
        r.u(4)
        s.level_idc = r.u(8)
        s.seq_parameter_set_id = r.ue()
        if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            s.chroma_format_idc = r.ue()
            if s.chroma_format_idc == 3:
                r.u(1)  # separate_colour_plane_flag
            s.bit_depth_luma_minus8 = r.ue()
            s.bit_depth_chroma_minus8 = r.ue()
            s.qpprime_y_zero_transform_bypass_flag = r.u(1)
            s.seq_scaling_matrix_present_flag = r.u(1)
            if s.seq_scaling_matrix_present_flag:
                raise NotImplementedError("scaling matrices not supported")
        s.log2_max_frame_num_minus4 = r.ue()
        s.pic_order_cnt_type = r.ue()
        if s.pic_order_cnt_type == 0:
            s.log2_max_pic_order_cnt_lsb_minus4 = r.ue()
        elif s.pic_order_cnt_type == 1:
            raise NotImplementedError("pic_order_cnt_type 1 not supported")
        s.max_num_ref_frames = r.ue()
        s.gaps_in_frame_num_value_allowed_flag = r.u(1)
        s.pic_width_in_mbs_minus1 = r.ue()
        s.pic_height_in_map_units_minus1 = r.ue()
        s.frame_mbs_only_flag = r.u(1)
        if not s.frame_mbs_only_flag:
            s.mb_adaptive_frame_field_flag = r.u(1)
        s.direct_8x8_inference_flag = r.u(1)
        s.frame_cropping_flag = r.u(1)
        if s.frame_cropping_flag:
            s.frame_crop_left_offset = r.ue()
            s.frame_crop_right_offset = r.ue()
            s.frame_crop_top_offset = r.ue()
            s.frame_crop_bottom_offset = r.ue()
        s.vui_parameters_present_flag = r.u(1)
        if s.vui_parameters_present_flag:
            s._parse_vui(r)
        return s

    def _parse_vui(self, r: BitReader) -> None:
        if r.u(1):  # aspect_ratio_info_present
            idc = r.u(8)
            if idc == EXTENDED_SAR:
                self.sar_width = r.u(16)
                self.sar_height = r.u(16)
            elif idc < len(SAR_TABLE):
                self.sar_width, self.sar_height = SAR_TABLE[idc]
        self.overscan_info_present_flag = r.u(1)
        if self.overscan_info_present_flag:
            r.u(1)
        self.video_signal_type_present_flag = r.u(1)
        if self.video_signal_type_present_flag:
            self.video_format = r.u(3)
            self.video_full_range_flag = r.u(1)
            self.colour_description_present_flag = r.u(1)
            if self.colour_description_present_flag:
                self.colour_primaries = r.u(8)
                self.transfer_characteristics = r.u(8)
                self.matrix_coefficients = r.u(8)
        self.chroma_loc_info_present_flag = r.u(1)
        if self.chroma_loc_info_present_flag:
            r.ue()
            r.ue()
        self.timing_info_present_flag = r.u(1)
        if self.timing_info_present_flag:
            self.num_units_in_tick = r.u(32)
            self.time_scale = r.u(32)
            self.fixed_frame_rate_flag = r.u(1)
        # hrd / pic_struct / bitstream_restriction: parse-and-ignore
        nal_hrd = r.u(1)
        if nal_hrd:
            _skip_hrd(r)
        vcl_hrd = r.u(1)
        if vcl_hrd:
            _skip_hrd(r)
        if nal_hrd or vcl_hrd:
            r.u(1)  # low_delay_hrd_flag
        r.u(1)  # pic_struct_present_flag
        if r.u(1):  # bitstream_restriction_flag
            r.u(1)
            for _ in range(6):
                r.ue()


def _skip_hrd(r: BitReader) -> None:
    cpb_cnt = r.ue() + 1
    r.u(4)
    r.u(4)
    for _ in range(cpb_cnt):
        r.ue()
        r.ue()
        r.u(1)
    r.u(5)
    r.u(5)
    r.u(5)
    r.u(5)


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0  # 0 = CAVLC, 1 = CABAC
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups_minus1: int = 0
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 1
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # High-profile extension
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    second_chroma_qp_index_offset: int | None = None

    def to_rbsp(self) -> np.ndarray:
        w = BitWriter()
        w.ue(self.pic_parameter_set_id)
        w.ue(self.seq_parameter_set_id)
        w.u(1, self.entropy_coding_mode_flag)
        w.u(1, self.bottom_field_pic_order_in_frame_present_flag)
        w.ue(self.num_slice_groups_minus1)
        assert self.num_slice_groups_minus1 == 0, "FMO not supported"
        w.ue(self.num_ref_idx_l0_default_active_minus1)
        w.ue(self.num_ref_idx_l1_default_active_minus1)
        w.u(1, self.weighted_pred_flag)
        w.u(2, self.weighted_bipred_idc)
        w.se(self.pic_init_qp_minus26)
        w.se(self.pic_init_qs_minus26)
        w.se(self.chroma_qp_index_offset)
        w.u(1, self.deblocking_filter_control_present_flag)
        w.u(1, self.constrained_intra_pred_flag)
        w.u(1, self.redundant_pic_cnt_present_flag)
        if self.transform_8x8_mode_flag or self.second_chroma_qp_index_offset is not None:
            w.u(1, self.transform_8x8_mode_flag)
            w.u(1, self.pic_scaling_matrix_present_flag)
            off = (self.second_chroma_qp_index_offset
                   if self.second_chroma_qp_index_offset is not None
                   else self.chroma_qp_index_offset)
            w.se(off)
        w.rbsp_trailing_bits()
        return w.to_rbsp()

    @classmethod
    def from_rbsp(cls, rbsp: bytes | np.ndarray) -> "PPS":
        r = BitReader(rbsp)
        p = cls()
        p.pic_parameter_set_id = r.ue()
        p.seq_parameter_set_id = r.ue()
        p.entropy_coding_mode_flag = r.u(1)
        p.bottom_field_pic_order_in_frame_present_flag = r.u(1)
        p.num_slice_groups_minus1 = r.ue()
        if p.num_slice_groups_minus1 != 0:
            raise NotImplementedError("FMO not supported")
        p.num_ref_idx_l0_default_active_minus1 = r.ue()
        p.num_ref_idx_l1_default_active_minus1 = r.ue()
        p.weighted_pred_flag = r.u(1)
        p.weighted_bipred_idc = r.u(2)
        p.pic_init_qp_minus26 = r.se()
        p.pic_init_qs_minus26 = r.se()
        p.chroma_qp_index_offset = r.se()
        p.deblocking_filter_control_present_flag = r.u(1)
        p.constrained_intra_pred_flag = r.u(1)
        p.redundant_pic_cnt_present_flag = r.u(1)
        if r.more_rbsp_data():
            p.transform_8x8_mode_flag = r.u(1)
            p.pic_scaling_matrix_present_flag = r.u(1)
            if p.pic_scaling_matrix_present_flag:
                raise NotImplementedError("scaling matrices not supported")
            p.second_chroma_qp_index_offset = r.se()
        return p
