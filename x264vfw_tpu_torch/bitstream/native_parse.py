"""ctypes loader for the host CAVLC slice parser (csrc/host/cavlc_parse.c).

Port of the parse_slice and parse_b_slice loaders of
x264vfw_tpu/decode/native_parse.py, for both of their callers: the CABAC
transcode (bitstream/cabac_transcode.py), which takes one CAVLC I, P or B
slice's data with the raw syntax elements it re-codes (mvd per quadrant
or per list, partition kind, B mode, I4x4 mode flags, mb_qp_delta,
transform_size_8x8_flag), and the decoder's device route
(decode/device_decode.py), which takes the syntax arrays alone
(parse_slice(..., want_raw=False)).  The library is built with gcc
into _build/ at first use (ops/kernels/build.py); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

_luts = None


def _lib():
    global _luts
    from ..ops.kernels import build
    lib = build.load_host("cavlcparse")
    if _luts is None:
        from .cavlc_luts import build_luts
        lib.cavlc_parse_slice.restype = ctypes.c_long
        lib.cavlc_parse_slice.argtypes = (
            [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * (1 + len(_OUT + _RAW)))
        lib.cavlc_parse_b_slice.restype = ctypes.c_long
        lib.cavlc_parse_b_slice.argtypes = (
            [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * (1 + len(_B_OUT))
            + [ctypes.c_int, ctypes.c_void_p])
        _luts = build_luts()
    return lib


_OUT = (("mb_kind", (), np.int32), ("qp_map", (), np.int32),
        ("i16mode", (), np.int32), ("cmode", (), np.int32),
        ("i4modes", (16,), np.int8), ("cbp_luma", (), np.int32),
        ("cbp_chroma", (), np.int32), ("dc16", (16,), np.int16),
        ("ac15", (16, 15), np.int16), ("lvl16", (16, 16), np.int16),
        ("cdc", (2, 4), np.int16), ("cac", (2, 4, 15), np.int16),
        ("mv4", (16, 2), np.int16), ("ref4", (16,), np.int8),
        ("flags", (), np.int32))
_RAW = (("mvdq", (4, 2), np.int16), ("refq", (4,), np.int8),
        ("part", (), np.int8), ("i4prev", (16,), np.uint8),
        ("i4rem", (16,), np.int8), ("qpd", (), np.int8),
        ("t8", (), np.uint8))
_B_OUT = (("mode", (), np.int8), ("mvd0", (2,), np.int16),
          ("mvd1", (2,), np.int16), ("cbp_luma", (), np.int32),
          ("cbp_chroma", (), np.int32), ("lvl16", (16, 16), np.int16),
          ("cdc", (2, 4), np.int16), ("cac", (2, 4, 15), np.int16),
          ("qpd", (), np.int8))


def parse_slice(rbsp: np.ndarray, bitpos: int, slice_type: int,
                mbh: int, mbw: int, qp_init: int, nref: int,
                transform_8x8: bool, want_raw: bool = True):
    """Parse one CAVLC slice's data from bit `bitpos` of the RBSP.
    slice_type: 0 = P, 2 = I.  Returns a dict of syntax arrays, or None
    when the slice is outside the parser's scope (B, I_PCM, a parse
    error).

    want_raw (the CABAC transcode's default) also returns the raw
    elements (mvdq, refq, part, i4prev, i4rem, qpd, t8) and lets the
    parser accept 8x8-transformed MBs, whose transform_size_8x8_flag it
    records in t8.  The decoder's device route passes want_raw=False:
    the raw outputs are null pointers, and a slice with an 8x8-transformed
    MB is refused (the device core has no 8x8 inverse transform), as in
    the JAX package's decode route."""
    lib = _lib()
    n = mbh * mbw
    rbsp = np.ascontiguousarray(rbsp, np.uint8)
    fields = _OUT + _RAW if want_raw else _OUT
    o = {k: np.zeros((n,) + shape, dt) for k, shape, dt in fields}
    args = [rbsp.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(rbsp.size),
            ctypes.c_long(bitpos), slice_type, mbh, mbw, qp_init, nref,
            int(transform_8x8), _luts.ctypes.data_as(ctypes.c_void_p)]
    args += [o[k].ctypes.data_as(ctypes.c_void_p) for k, _, _ in fields]
    args += [None] * (len(_OUT + _RAW) - len(fields))
    if lib.cavlc_parse_slice(*args) != n:
        return None
    return o


def parse_b_slice(rbsp: np.ndarray, bitpos: int, mbh: int, mbw: int,
                  qp_init: int, transform_8x8: bool = False):
    """Parse one CAVLC B slice's data (the encoder's B slices: 16x16
    modes, direct and skip) from bit `bitpos` of the RBSP.  Returns a
    dict of raw syntax arrays ('mode' -1 for B_Skip, else the mb_type
    0..3; 'mvd0'/'mvd1' per list; cbp, levels, chroma, 'qpd', 't8'), or
    None on a parse failure or syntax outside the parser's scope."""
    lib = _lib()
    n = mbh * mbw
    rbsp = np.ascontiguousarray(rbsp, np.uint8)
    o = {k: np.zeros((n,) + shape, dt) for k, shape, dt in _B_OUT}
    o["t8"] = np.zeros(n, np.uint8)
    args = [rbsp.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(rbsp.size),
            ctypes.c_long(bitpos), mbh, mbw, qp_init,
            _luts.ctypes.data_as(ctypes.c_void_p)]
    args += [o[k].ctypes.data_as(ctypes.c_void_p) for k, _, _ in _B_OUT]
    args += [int(transform_8x8), o["t8"].ctypes.data_as(ctypes.c_void_p)]
    if lib.cavlc_parse_b_slice(*args) != n:
        return None
    return o
