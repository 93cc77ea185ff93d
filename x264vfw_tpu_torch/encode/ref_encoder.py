"""Encoder configuration record.

Copy of the EncoderConfig dataclass of x264vfw_tpu/encode/ref_encoder.py
(the numpy reference encoder itself has no counterpart in the port).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EncoderConfig"]


@dataclass
class EncoderConfig:
    width: int = 64
    height: int = 64
    qp: int = 26
    keyint: int = 25
    min_keyint: int = 1      # minimum IDR distance (scenecut floor)
    scenecut: int = 0        # scene-cut strength, 0 = off (x264 --scenecut)
    deblock: bool = False
    deblock_alpha: int = 0   # slice_alpha_c0_offset_div2
    deblock_beta: int = 0    # slice_beta_offset_div2
    num_ref_frames: int = 1
    search_range: int = 8
    subpel: int = 2          # 0 = integer-pel, 1 = half, 2 = quarter
    bframes: int = 0         # consecutive B frames between anchors
    cabac: bool = False      # CABAC entropy coding (Main profile)
    aq_strength: float = 0.0  # variance AQ (0 = off); applies to P frames
    trellis: bool = False    # RD-quant refinement (approximate trellis)
    weightp: int = 0         # explicit weighted prediction for P (0 = off)
    chroma_qp_offset: int = 0  # PPS chroma_qp_index_offset (x264 flag)
    i4x4: bool = False
    # High-profile 8x8 transform for P luma residuals (x264 --8x8dct,
    # codec.c:904); per-MB 4x4-vs-8x8 decision in the device pipeline
    dct8x8: bool = False
    # P-frame inter partitions 16x8/8x16/8x8 (x264 --partitions surface,
    # codec.c:887).  Effective on the device encoder when nref == 1 and
    # entropy is CAVLC (CABAC partition binarization lands separately).
    partitions: bool = False
    fps_num: int = 25
    fps_den: int = 1
    # VUI signaling (reference forwards these to x264's SPS writer,
    # codec.c:973-979 + the range/colmatrix fixup codec.c:1566-1577)
    sar_width: int = 0
    sar_height: int = 0
    fullrange: bool = False
    colorprim: int = 2       # colour_primaries code (2 = unspecified)
    transfer: int = 2        # transfer_characteristics code
    colmatrix: int = 2       # matrix_coefficients code
    vui_timing: bool = True  # write timing_info (fps) into the SPS VUI
    # NAL HRD signaling (x264 --nal-hrd, requires VBV; codec.c:917-919):
    # "none" | "vbr" | "cbr"; rates in kbit/s, kbit (x264 flag units)
    nal_hrd: str = "none"
    vbv_maxrate: int = 0
    vbv_bufsize: int = 0
    # motion-search method as the JAX package spells it: a backend name
    # ("auto", "xla", "pallas", "pallas_interpret": in the port the SAD
    # kernel runs on CUDA tensors and its plain version on CPU tensors,
    # whatever the name) with an optional ":hier" suffix selecting the
    # hierarchical search (dia/hex/umh)
    me_backend: str = "auto"
