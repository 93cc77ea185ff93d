# Frozen copy of x264vfw_tpu_torch/bitstream/mb_syntax.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""Macroblock-layer syntax tables shared by encoder and decoder (§7.3.5, §7.4.5).

Covers the capability the reference gets from libx264/FFmpeg's internal MB
syntax handling (mb_type, coded_block_pattern, pred mode coding).
"""

from __future__ import annotations

import numpy as np

# --- mb_type (I slices, Table 7-11) ----------------------------------------
# I_NxN = 0; I_16x16_<predmode>_<cbp_chroma>_<cbp_luma> = 1..24; I_PCM = 25.

I_NXN = 0
I_PCM = 25


def i16x16_mb_type(pred_mode: int, cbp_chroma: int, cbp_luma_nonzero: bool) -> int:
    """mb_type for I_16x16 (Table 7-11): 1 + pred + 4*cbpC + 12*(cbpY!=0)."""
    return 1 + pred_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma_nonzero else 0)


def parse_i16x16_mb_type(mb_type: int) -> tuple[int, int, int]:
    """-> (pred_mode, cbp_chroma, cbp_luma) for mb_type in 1..24."""
    t = mb_type - 1
    pred = t % 4
    cbp_chroma = (t // 4) % 3
    cbp_luma = 15 if t >= 12 else 0
    return pred, cbp_chroma, cbp_luma


# --- mb_type (P slices, Table 7-13) -----------------------------------------
P_L0_16X16 = 0
P_L0_L0_16X8 = 1
P_L0_L0_8X16 = 2
P_8X8 = 3
P_8X8REF0 = 4
# intra types in P slice: 5 + I-slice type

# --- sub_mb_type (P slices, Table 7-17) -------------------------------------
P_SUB_8X8 = 0
P_SUB_8X4 = 1
P_SUB_4X8 = 2
P_SUB_4X4 = 3

# --- mb_type (B slices, Table 7-14) -----------------------------------------
B_DIRECT_16X16 = 0
B_L0_16X16 = 1
B_L1_16X16 = 2
B_BI_16X16 = 3
B_L0_L0_16X8 = 4
B_L0_L0_8X16 = 5
B_L1_L1_16X8 = 6
B_L1_L1_8X16 = 7
B_L0_L1_16X8 = 8
B_L0_L1_8X16 = 9
B_L1_L0_16X8 = 10
B_L1_L0_8X16 = 11
B_L0_BI_16X8 = 12
B_L0_BI_8X16 = 13
B_L1_BI_16X8 = 14
B_L1_BI_8X16 = 15
B_BI_L0_16X8 = 16
B_BI_L0_8X16 = 17
B_BI_L1_16X8 = 18
B_BI_L1_8X16 = 19
B_BI_BI_16X8 = 20
B_BI_BI_8X16 = 21
B_8X8 = 22
# intra types in B slice: 23 + I-slice type

# per-B-mb-type: (partitioning, list-usage) table (Table 7-14)
# part: 0=16x16(or direct), 1=16x8, 2=8x16; lists: tuple per partition,
# each 0=L0, 1=L1, 2=BI
B_MB_INFO = {
    B_DIRECT_16X16: (0, (None,)),
    B_L0_16X16: (0, (0,)),
    B_L1_16X16: (0, (1,)),
    B_BI_16X16: (0, (2,)),
    B_L0_L0_16X8: (1, (0, 0)),
    B_L0_L0_8X16: (2, (0, 0)),
    B_L1_L1_16X8: (1, (1, 1)),
    B_L1_L1_8X16: (2, (1, 1)),
    B_L0_L1_16X8: (1, (0, 1)),
    B_L0_L1_8X16: (2, (0, 1)),
    B_L1_L0_16X8: (1, (1, 0)),
    B_L1_L0_8X16: (2, (1, 0)),
    B_L0_BI_16X8: (1, (0, 2)),
    B_L0_BI_8X16: (2, (0, 2)),
    B_L1_BI_16X8: (1, (1, 2)),
    B_L1_BI_8X16: (2, (1, 2)),
    B_BI_L0_16X8: (1, (2, 0)),
    B_BI_L0_8X16: (2, (2, 0)),
    B_BI_L1_16X8: (1, (2, 1)),
    B_BI_L1_8X16: (2, (2, 1)),
    B_BI_BI_16X8: (1, (2, 2)),
    B_BI_BI_8X16: (2, (2, 2)),
}

# --- coded_block_pattern mapping (Table 9-4, ChromaArrayType = 1) -----------
# CBP_FROM_CODE[codeNum] = (cbp_intra, cbp_inter)
CBP_FROM_CODE = np.array([
    (47, 0), (31, 16), (15, 1), (0, 2), (23, 4), (27, 8), (29, 32), (30, 3),
    (7, 5), (11, 10), (13, 12), (14, 15), (39, 47), (43, 7), (45, 11), (46, 13),
    (16, 14), (3, 6), (5, 9), (10, 31), (12, 35), (19, 37), (21, 42), (26, 44),
    (28, 33), (35, 34), (37, 36), (42, 40), (44, 39), (1, 43), (2, 45), (4, 46),
    (8, 17), (17, 18), (18, 20), (20, 24), (24, 19), (6, 21), (9, 26), (22, 28),
    (25, 23), (32, 27), (33, 29), (34, 30), (36, 22), (40, 25), (38, 38), (41, 41),
], dtype=np.int32)

# inverse: CBP_TO_CODE[intra?][cbp] = codeNum
CBP_TO_CODE = np.zeros((2, 48), dtype=np.int32)
for _code, (_ci, _cp) in enumerate(CBP_FROM_CODE):
    CBP_TO_CODE[1, _ci] = _code
    CBP_TO_CODE[0, _cp] = _code

# --- slice types (§7.4.3) ----------------------------------------------------
SLICE_P = 0
SLICE_B = 1
SLICE_I = 2
# +5 variants mean "all slices in this picture have this type"


def is_slice_type(slice_type: int, t: int) -> bool:
    return slice_type % 5 == t
