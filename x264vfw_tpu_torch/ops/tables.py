"""Quantisation, scan and chroma-QP tables of the integer transform path.

Copy of the tables of x264vfw_tpu/ops/transform_np.py that the device path
reads (ITU-T H.264 Table 8-15 normAdjust / x264 MF tables, Table 8-12,
§8.5.6 zigzag), plus its host chroma_qp.
"""

from __future__ import annotations

import numpy as np

# Dequant scale V[qp%6][class], classes: a=(0,0)-like, b=(1,1)-like, c=other
DEQUANT_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Forward quant multipliers MF[qp%6][class] (2^15 * 2^4 / (V*16) scaled)
QUANT_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# position class for each (i, j) in a 4x4 block
_POS_CLASS = np.array([
    [0, 2, 0, 2],
    [2, 1, 2, 1],
    [0, 2, 0, 2],
    [2, 1, 2, 1],
], dtype=np.int32)

# per-position tables indexed [qp%6, i, j]
DEQUANT_TABLE = DEQUANT_V[:, _POS_CLASS]          # (6, 4, 4)
QUANT_TABLE = QUANT_MF[:, _POS_CLASS]             # (6, 4, 4)

# chroma QP mapping (H.264 Table 8-12): qPi 30..51 -> QPc
_CHROMA_QP_TABLE = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
     37, 37, 37, 38, 38, 38, 39, 39, 39, 39], dtype=np.int32)

# zigzag scan for 4x4 blocks (§8.5.6): raster index of k-th scan position
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      dtype=np.int32)


def chroma_qp(qp_luma: np.ndarray | int, chroma_qp_offset: int = 0) -> np.ndarray | int:
    """Luma QP -> chroma QP (Table 8-12)."""
    qpi = np.clip(np.asarray(qp_luma) + chroma_qp_offset, 0, 51)
    idx = np.clip(qpi - 30, 0, 21)
    return np.where(qpi < 30, qpi, _CHROMA_QP_TABLE[idx]).astype(np.int32)


# --- 8x8 transform (High profile, §8.5.12.3 / §8.5.13) ---

# 8x8 zigzag scan (§8.5.8): raster index of the k-th scan position
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# dequant scale values per qp%6, one per position class
_DEQUANT8_INIT = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int64)

# position class of raster position i (0..63): _D8_SCAN[((i >> 1) & 12) | (i & 3)]
_D8_SCAN = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                    dtype=np.int64)
_D8_CLASS = _D8_SCAN[((np.arange(64) >> 1) & 12) | (np.arange(64) & 3)]

# (6, 8, 8) LevelScale8x8 = weightScale (16, flat lists) x normAdjust8x8
DEQUANT8_TABLE = (_DEQUANT8_INIT[:, _D8_CLASS] * 16).reshape(6, 8, 8) \
    .astype(np.int32)

# forward 8x8 multipliers MF8[qp%6][class], the values the JAX package's
# transform_np derives from DEQUANT8_TABLE (_derive_quant8_mf)
QUANT8_MF = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int32)
QUANT8_TABLE = QUANT8_MF[:, _D8_CLASS].reshape(6, 8, 8)
