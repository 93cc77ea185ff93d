"""CAVLC -> CABAC entropy transcode of one slice (host).

Port of x264vfw_tpu/bitstream/cabac_transcode.py (I, P and B slices).
The device phase writes a complete CAVLC slice (encode/device_finalize);
with --cabac the host re-codes it: the C parser (native_parse, from
csrc/host/cavlc_parse.c) reads its syntax elements back and the C CABAC
coder (cabac_native, from csrc/host/cabac_ext.c) writes them again.  Two
passes over bitstream-sized data, no syntax-tensor pull.  The C passes
release the GIL, so the batched session runs a window's transcodes in a
thread pool.
"""

from __future__ import annotations

import numpy as np

from . import cabac_native as cn
from . import native_parse


def _header_bytes(payload: np.ndarray, hdr_bits: int) -> bytes:
    """The first hdr_bits of the slice as bytes, with the
    cabac_alignment_one_bits (§7.3.4: CABAC slice data starts
    byte-aligned)."""
    nbytes = (hdr_bits + 7) // 8
    hdr = bytearray(payload[:nbytes].tobytes())
    pad = (-hdr_bits) % 8
    if pad:
        hdr[-1] |= (1 << pad) - 1
    return bytes(hdr)


def transcode_slice(payload: np.ndarray, hdr_bits: int, slice_type: str,
                    mbh: int, mbw: int, qp: int, nref: int = 1,
                    t8_mode: bool = False) -> bytes | None:
    """Re-code one CAVLC slice RBSP (header + data) as a CABAC slice.

    payload: uint8 RBSP.  slice_type: "I", "P" or "B".  qp: the slice QP.
    Returns the CABAC slice RBSP (the same header, aligned, then the
    re-coded data), or None when the slice has syntax the coder does not
    take: intra MBs or sub-8x8 partitions in a P slice, per-partition
    references, an I slice with a per-MB QP, or a parse failure."""
    if slice_type not in ("I", "P", "B"):
        raise ValueError(f"unknown slice type {slice_type!r}")
    payload = np.ascontiguousarray(payload, np.uint8)
    hdr = _header_bytes(payload, hdr_bits)
    if slice_type == "B":
        syn = native_parse.parse_b_slice(payload, hdr_bits, mbh, mbw, qp,
                                         transform_8x8=t8_mode)
        if syn is None:
            return None
        mode = syn["mode"].astype(np.int32)
        cdc, cac = syn["cdc"], syn["cac"]
        body = cn.encode_b_slice(
            qp, 0, mbh, mbw, (mode < 0).astype(np.uint8),
            np.maximum(mode, 0), syn["mvd0"], syn["mvd1"], syn["cbp_luma"],
            syn["cbp_chroma"], syn["lvl16"], cdc[:, 0], cdc[:, 1],
            cac[:, 0], cac[:, 1], t8_mode, syn["t8"])
        return hdr + body
    syn = native_parse.parse_slice(payload, hdr_bits,
                                   0 if slice_type == "P" else 2, mbh, mbw,
                                   qp, nref, t8_mode)
    if syn is None:
        return None
    kinds = syn["mb_kind"]
    cdc, cac = syn["cdc"], syn["cac"]
    if slice_type == "P":
        if (kinds >= 5).any() or (syn["flags"] & 1).any():
            return None             # intra MBs or sub-8x8 partitions
        refq = syn["refq"]
        if nref > 1 and (refq != refq[:, :1]).any():
            return None             # per-partition references
        body = cn.encode_p_slice(
            qp, 0, mbh, mbw, (kinds == 0).astype(np.uint8), syn["mvdq"],
            syn["cbp_luma"], syn["cbp_chroma"], syn["lvl16"], cdc[:, 0],
            cdc[:, 1], cac[:, 0], cac[:, 1], syn["qpd"],
            np.maximum(syn["part"].astype(np.int32), 0),
            refq[:, 0], nref, syn["t8"], t8_mode)
        return hdr + body

    # I slice (mixed I16 / I_NxN)
    if (syn["qpd"] != 0).any():
        return None                 # a per-MB QP in an I slice
    use_i4 = (kinds == 6).astype(np.uint8)
    i4 = None
    if use_i4.any():
        i4 = (use_i4, syn["i4prev"],
              np.maximum(syn["i4rem"].astype(np.int32), 0),
              syn["cbp_luma"], syn["lvl16"])
    body = cn.encode_i_slice(
        qp, mbh, mbw, syn["i16mode"], syn["cmode"],
        (syn["cbp_luma"] != 0).astype(np.uint8), syn["cbp_chroma"],
        syn["dc16"], syn["ac15"], cdc[:, 0], cdc[:, 1], cac[:, 0],
        cac[:, 1], i4=i4, t8_mode=t8_mode)
    return hdr + body
