"""H.264 integer 4x4 and 8x8 transforms + quantisation on tensors
(PyTorch).

Port of x264vfw_tpu/ops/transform.py, bit-exact with it and with the
spec-derived golden model (x264vfw_tpu/ops/transform_np.py).  All sample
arithmetic is int32 (|W| <= 9180 for 8-bit residuals, |W| * MF <= 1.2e8 <
2^31; 8x8: |W8| <= ~2e4, |W8| * MF8 <= 4.3e8); the transforms are
butterflies, never matrix products.

Shapes: every function is batched over leading dims; blocks are
(..., 4, 4) or (..., 8, 8) int32.  qp is a Python int (one QP for the
call) or an integer tensor broadcastable against the blocks' leading dims
(per-MB adaptive quantisation: (n, 1) against (n, 16, 4, 4), say).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables

_NAMED = {
    "dequant": tables.DEQUANT_TABLE,      # (6, 4, 4)
    "quant": tables.QUANT_TABLE,          # (6, 4, 4)
    "mf0": tables.QUANT_MF[:, 0],         # (6,) DC-mode multipliers
    "v0": tables.DEQUANT_V[:, 0],         # (6,) DC dequant scales
    "dequant8": tables.DEQUANT8_TABLE,    # (6, 8, 8)
    "quant8": tables.QUANT8_TABLE,        # (6, 8, 8)
    "chroma_qp": tables._CHROMA_QP_TABLE,
    "zigzag": tables.ZIGZAG_4x4,
    "unzigzag": np.argsort(tables.ZIGZAG_4x4),
    "zigzag8": tables.ZIGZAG_8x8,
    "unzigzag8": np.argsort(tables.ZIGZAG_8x8),
}
_INDEX_TABLES = ("zigzag", "unzigzag", "zigzag8", "unzigzag8")


@lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A constant table as a tensor on `device` (uploaded once)."""
    a = np.asarray(_NAMED[name])
    dt = torch.int64 if name in _INDEX_TABLES else torch.int32
    return torch.as_tensor(a, dtype=dt, device=device)


def _per_qp(name: str, qp, device: torch.device) -> torch.Tensor:
    """table[qp % 6]: the table's row for an int qp, qp.shape + the row's
    shape for a tensor qp."""
    t = const(name, device)
    return t[qp % 6] if isinstance(qp, int) else t[(qp % 6).long()]


def _bc(v, qp):
    """A per-QP quantity (int, or a tensor shaped like qp) made to
    broadcast against blocks: a tensor gets two trailing dims."""
    return v[..., None, None] if isinstance(qp, torch.Tensor) else v


def _qp(qp):
    """An int qp as a Python int, a tensor qp as int32."""
    return qp.to(torch.int32) if isinstance(qp, torch.Tensor) else int(qp)


def _pow2(e):
    """1 << e for an int or an int32 tensor."""
    return torch.ones_like(e) << e if isinstance(e, torch.Tensor) else 1 << e


def chroma_qp(qp_luma, chroma_qp_offset: int = 0):
    """Luma QP -> chroma QP (Table 8-12) for an int or a tensor."""
    if not isinstance(qp_luma, torch.Tensor):
        return int(tables.chroma_qp(qp_luma, chroma_qp_offset))
    qpi = (qp_luma.to(torch.int32) + chroma_qp_offset).clamp(0, 51)
    table = const("chroma_qp", qp_luma.device)
    return torch.where(qpi < 30, qpi, table[(qpi - 30).clamp(0, 21).long()])


def fdct4x4(x: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 integer transform via butterflies (x264 dct4x4 structure).

    Equivalent to Cf @ X @ Cf^T with Cf = [[1,1,1,1],[2,1,-1,-2],
    [1,-1,-1,1],[1,-2,2,-1]]."""
    x = x.to(torch.int32)
    # columns pass (transform along dim -2)
    s0 = x[..., 0, :] + x[..., 3, :]
    s3 = x[..., 0, :] - x[..., 3, :]
    s1 = x[..., 1, :] + x[..., 2, :]
    s2 = x[..., 1, :] - x[..., 2, :]
    y = torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-2)
    # rows pass (transform along dim -1)
    s0 = y[..., 0] + y[..., 3]
    s3 = y[..., 0] - y[..., 3]
    s1 = y[..., 1] + y[..., 2]
    s2 = y[..., 1] - y[..., 2]
    return torch.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-1)


def quant4x4(w: torch.Tensor, qp, intra: bool,
             dc_mode: bool = False) -> torch.Tensor:
    """Dead-zone quant: sign * ((|w| * MF + f) >> qbits)."""
    w = w.to(torch.int32)
    qp = _qp(qp)
    if dc_mode:
        mf = _bc(_per_qp("mf0", qp, w.device), qp)
        qbits = 16 + qp // 6
    else:
        mf = _per_qp("quant", qp, w.device)
        qbits = 15 + qp // 6
    f = _pow2(qbits) // (3 if intra else 6)
    level = (w.abs() * mf + _bc(f, qp)) >> _bc(qbits, qp)
    if not dc_mode:
        # int16 dynamic-range clamp (see transform_np.quant4x4)
        v = _per_qp("dequant", qp, w.device) << _bc(qp // 6, qp)
        level = torch.minimum(level, 32767 // v)
    return torch.sign(w) * level


def dequant4x4(coef: torch.Tensor, qp) -> torch.Tensor:
    """d = c * V[qp%6][pos] << (qp/6)."""
    qp = _qp(qp)
    v = _per_qp("dequant", qp, coef.device)
    return (coef.to(torch.int32) * v) << _bc(qp // 6, qp)


def idct4x4_core(d: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 butterflies + (x+32)>>6 (§8.5.12.2).

    ROW transform first, then columns: the >>1 floors make the stage order
    observable at qP/6 < 2 (see transform_np.idct4x4_core)."""
    d = d.to(torch.int32)
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0, g1, g2, g3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    h0 = g0 + g2
    h1 = g0 - g2
    h2 = (g1 >> 1) - g3
    h3 = g1 + (g3 >> 1)
    r = torch.stack([h0 + h3, h1 + h2, h1 - h2, h0 - h3], dim=-2)
    return (r + 32) >> 6


def hadamard4x4(x: torch.Tensor) -> torch.Tensor:
    """H X H^T with H the +-1 butterfly matrix (exact)."""
    x = x.to(torch.int32)
    s0 = x[..., 0, :] + x[..., 2, :]
    s1 = x[..., 0, :] - x[..., 2, :]
    s2 = x[..., 1, :] + x[..., 3, :]
    s3 = x[..., 1, :] - x[..., 3, :]
    y = torch.stack([s0 + s2, s1 + s3, s1 - s3, s0 - s2], dim=-2)
    s0 = y[..., 0] + y[..., 2]
    s1 = y[..., 0] - y[..., 2]
    s2 = y[..., 1] + y[..., 3]
    s3 = y[..., 1] - y[..., 3]
    return torch.stack([s0 + s2, s1 + s3, s1 - s3, s0 - s2], dim=-1)


def luma_dc_fwd_quant(dc: torch.Tensor, qp,
                      intra: bool = True) -> torch.Tensor:
    """Encoder luma DC: Hadamard, >>1 (floor), DC-mode quant."""
    return quant4x4(hadamard4x4(dc) >> 1, qp, intra=intra, dc_mode=True)


def luma_dc_dequant(levels: torch.Tensor, qp) -> torch.Tensor:
    """Decoder §8.5.10: inverse Hadamard then LevelScale."""
    f = hadamard4x4(levels)
    qp = _qp(qp)
    ls = 16 * _bc(_per_qp("v0", qp, levels.device), qp)
    if isinstance(qp, int):
        qp6 = qp // 6
        if qp >= 36:
            return (f * ls) << (qp6 - 6)
        return (f * ls + (1 << (5 - qp6))) >> (6 - qp6)
    qp6 = _bc(qp // 6, qp)
    hi = (f * ls) << (qp6 - 6).clamp(min=0)
    lo = (f * ls + _pow2((5 - qp6).clamp(min=0))) >> (6 - qp6).clamp(min=0)
    return torch.where(_bc(qp, qp) >= 36, hi, lo)


def hadamard2x2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    r0 = torch.stack([a + b + c + d, a - b + c - d], dim=-1)
    r1 = torch.stack([a + b - c - d, a - b - c + d], dim=-1)
    return torch.stack([r0, r1], dim=-2)


def chroma_dc_fwd_quant(dc: torch.Tensor, qp,
                        intra: bool) -> torch.Tensor:
    return quant4x4(hadamard2x2(dc), qp, intra=intra, dc_mode=True)


def chroma_dc_dequant(levels: torch.Tensor, qp) -> torch.Tensor:
    f = hadamard2x2(levels)
    qp = _qp(qp)
    ls = 16 * _bc(_per_qp("v0", qp, levels.device), qp)
    return ((f * ls) << _bc(qp // 6, qp)) >> 5


def zigzag_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 16) in zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 16)
    return flat.index_select(-1, const("zigzag", blocks.device))


def zigzag_unscan(scanned: torch.Tensor) -> torch.Tensor:
    """(..., 16) zigzag order -> (..., 4, 4)."""
    out = scanned.index_select(-1, const("unzigzag", scanned.device))
    return out.reshape(*scanned.shape[:-1], 4, 4)


# --- 8x8 transform family (High profile) -------------------------------

def _fdct8_1d(x: torch.Tensor, dim: int) -> torch.Tensor:
    p = x.unbind(dim)
    s07, s16, s25, s34 = p[0] + p[7], p[1] + p[6], p[2] + p[5], p[3] + p[4]
    a0, a1, a2, a3 = s07 + s34, s16 + s25, s07 - s34, s16 - s25
    d07, d16, d25, d34 = p[0] - p[7], p[1] - p[6], p[2] - p[5], p[3] - p[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    return torch.stack([a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1),
                        a5 + (a6 >> 2), a0 - a1, a6 - (a5 >> 2),
                        (a2 >> 1) - a3, (a4 >> 2) - a7], dim=dim)


def fdct8x8(x: torch.Tensor) -> torch.Tensor:
    """Forward 8x8 integer transform; x: (..., 8, 8) int residual.  Rows
    (the last dim) first, then columns."""
    return _fdct8_1d(_fdct8_1d(x.to(torch.int32), -1), -2)


def _gain8(qp, device):
    """(LevelScale8x8, qp // 6) and the dequant gain of each position."""
    ls = _per_qp("dequant8", qp, device)
    dv = qp // 6
    if isinstance(qp, int):
        gain = ls << (dv - 6) if dv >= 6 else (ls >> (6 - dv)).clamp(min=1)
        return ls, dv, gain
    dv = _bc(dv, qp)
    gain = torch.where(dv >= 6, ls << (dv - 6).clamp(min=0),
                       (ls >> (6 - dv).clamp(min=0)).clamp(min=1))
    return ls, dv, gain


def quant8x8(w: torch.Tensor, qp, intra: bool) -> torch.Tensor:
    """Forward 8x8 quant (dead-zone, derived MF8, 16-bit dequant-range
    clamp), as transform_np.quant8x8."""
    w = w.to(torch.int32)
    qp = _qp(qp)
    qbits = 16 + qp // 6
    mf = _per_qp("quant8", qp, w.device)
    f = _pow2(qbits) // (3 if intra else 6)
    level = (w.abs() * mf + _bc(f, qp)) >> _bc(qbits, qp)
    _, _, gain = _gain8(qp, w.device)
    level = torch.minimum(level, 32767 // gain.clamp(min=1))
    return torch.sign(w) * level


def dequant8x8(coef: torch.Tensor, qp) -> torch.Tensor:
    """§8.5.13.1 with flat scaling lists."""
    qp = _qp(qp)
    ls, dv, _ = _gain8(qp, coef.device)
    c = coef.to(torch.int32)
    if isinstance(qp, int):
        if dv >= 6:
            return (c * ls) << (dv - 6)
        return (c * ls + (1 << (5 - dv))) >> (6 - dv)
    hi = (c * ls) << (dv - 6).clamp(min=0)
    lo = (c * ls + _pow2((5 - dv).clamp(min=0))) >> (6 - dv).clamp(min=0)
    return torch.where(dv >= 6, hi, lo)


def _idct8_1d(p: torch.Tensor, dim: int) -> torch.Tensor:
    c = p.unbind(dim)
    a0 = c[0] + c[4]
    a2 = c[0] - c[4]
    a4 = (c[2] >> 1) - c[6]
    a6 = (c[6] >> 1) + c[2]
    b0, b2, b4, b6 = a0 + a6, a2 + a4, a2 - a4, a0 - a6
    a1 = -c[3] + c[5] - c[7] - (c[7] >> 1)
    a3 = c[1] + c[7] - c[3] - (c[3] >> 1)
    a5 = -c[1] + c[7] + c[5] + (c[5] >> 1)
    a7 = c[3] + c[5] + c[1] + (c[1] >> 1)
    b1 = (a7 >> 2) + a1
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    b7 = a7 - (a1 >> 2)
    return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                        b6 - b1, b4 - b3, b2 - b5, b0 - b7], dim=dim)


def idct8x8_core(d: torch.Tensor) -> torch.Tensor:
    """Inverse 8x8 transform (§8.5.12.3): rows, then columns, (x+32)>>6."""
    r = _idct8_1d(_idct8_1d(d.to(torch.int32), -1), -2)
    return (r + 32) >> 6


def zigzag8x8_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 64) in 8x8 zigzag order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat.index_select(-1, const("zigzag8", blocks.device))


def zigzag8x8_unscan(scanned: torch.Tensor) -> torch.Tensor:
    """(..., 64) 8x8 zigzag order -> (..., 8, 8)."""
    out = scanned.index_select(-1, const("unzigzag8", scanned.device))
    return out.reshape(*scanned.shape[:-1], 8, 8)
