"""ctypes loader for the host CABAC slice coder (csrc/host/cabac_ext.c).

Port of x264vfw_tpu/bitstream/cabac_native.py (P, B and I slices): one
call codes a whole slice's data from its syntax arrays.  The library is
built with gcc into _build/ at first use (ops/kernels/build.py); a failed
build raises, and there is no Python fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np


_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_long


def _lib():
    from ..ops.kernels import build
    lib = build.load_host("cabac")
    lib.cabac_encode_p_slice.restype = _L
    lib.cabac_encode_p_slice.argtypes = (
        [_I] * 4 + [_P] * 4 + [_I] + [_P] * 9 + [_I, _P, _L])
    lib.cabac_encode_i_slice.restype = _L
    lib.cabac_encode_i_slice.argtypes = [_I] * 3 + [_P] * 15 + [_I, _P, _L]
    lib.cabac_encode_b_slice.restype = _L
    lib.cabac_encode_b_slice.argtypes = (
        [_I] * 4 + [_P] * 11 + [_I, _P, _P, _L])
    return lib


def _ptrs(holds: list, arrays) -> list:
    """Contiguous copies of (array, dtype) pairs, kept alive in `holds`,
    as ctypes pointers."""
    out = []
    for a, dt in arrays:
        arr = np.ascontiguousarray(a, dtype=dt)
        holds.append(arr)
        out.append(arr.ctypes.data_as(ctypes.c_void_p))
    return out


def _call(fn, cap: int, *args) -> bytes:
    out = np.zeros(cap, np.uint8)
    sz = fn(*args, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(cap))
    if sz < 0:
        raise RuntimeError(f"CABAC slice coder failed with code {sz}")
    return out[:sz].tobytes()


def encode_p_slice(qp, init_idc, mbh, mbw, skip, mvd, cbp_l, cbp_c,
                   levels, dc_u, dc_v, ac_u, ac_v, qpd, part, ref,
                   nref: int, t8, t8_mode: bool) -> bytes:
    """mvd: (n, 4, 2) quadrant-raster mvd slots with `part` (n,) in
    {0: 16x16, 1: 16x8, 2: 8x16, 3: P_8x8}; ref (n,) with nref > 1 codes
    ref_idx; t8 (n,) transform_size_8x8_flag when t8_mode."""
    n = mbh * mbw
    holds: list = []
    a = _ptrs(holds, ((skip, np.uint8), (part, np.int32), (mvd, np.int32),
                      (ref, np.int32)))
    b = _ptrs(holds, ((cbp_l, np.int32), (cbp_c, np.int32),
                      (levels, np.int32), (dc_u, np.int32), (dc_v, np.int32),
                      (ac_u, np.int32), (ac_v, np.int32), (qpd, np.int32),
                      (t8, np.uint8)))
    return _call(_lib().cabac_encode_p_slice, max(1 << 16, n * 800),
                 qp, init_idc, mbh, mbw, *a, ctypes.c_int(int(nref)), *b,
                 ctypes.c_int(int(t8_mode)))


def encode_b_slice(qp, init_idc, mbh, mbw, skip, mode, mvd0, mvd1,
                   cbp_l, cbp_c, levels, dc_u, dc_v, ac_u, ac_v,
                   t8_mode: bool, t8) -> bytes:
    """B slice of 16x16 modes: skip (n,) B_Skip flags; mode (n,) the
    mb_type 0..3 (0 = B_Direct_16x16); mvd0/mvd1 (n, 2) per list; the
    residual arrays cbp-masked; t8 (n,) transform_size_8x8_flag when
    t8_mode."""
    n = mbh * mbw
    holds: list = []
    a = _ptrs(holds, ((skip, np.uint8), (mode, np.int32), (mvd0, np.int32),
                      (mvd1, np.int32), (cbp_l, np.int32), (cbp_c, np.int32),
                      (levels, np.int32), (dc_u, np.int32), (dc_v, np.int32),
                      (ac_u, np.int32), (ac_v, np.int32)))
    t8p, = _ptrs(holds, ((t8, np.uint8),))
    return _call(_lib().cabac_encode_b_slice, max(1 << 16, n * 800),
                 qp, init_idc, mbh, mbw, *a, ctypes.c_int(int(t8_mode)), t8p)


def encode_i_slice(qp, mbh, mbw, i16mode, cmode, acflag, cbp_c,
                   dc, ac, dc_u, dc_v, ac_u, ac_v, i4=None,
                   t8_mode: bool = False) -> bytes:
    """Mixed I16/I_NxN slice.  i4: None (all I16) or the tuple (use_i4,
    i4_prev, i4_rem, cbp4, levels4), levels4 (n, 16, 16) zigzag
    decode-order blocks, cbp-masked."""
    n = mbh * mbw
    holds: list = []
    p4 = [None] * 5 if i4 is None else _ptrs(holds, zip(
        i4, (np.uint8, np.uint8, np.int32, np.int32, np.int32)))
    p16 = _ptrs(holds, ((i16mode, np.int32), (cmode, np.int32),
                        (acflag, np.uint8), (cbp_c, np.int32),
                        (dc, np.int32), (ac, np.int32), (dc_u, np.int32),
                        (dc_v, np.int32), (ac_u, np.int32),
                        (ac_v, np.int32)))
    return _call(_lib().cabac_encode_i_slice, max(1 << 16, n * 1200),
                 qp, mbh, mbw, *p4, *p16, ctypes.c_int(int(t8_mode)))
