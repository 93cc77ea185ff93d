"""16-bit-peek decode LUTs for the native CAVLC slice parser.

The C parser (csrc/host/cavlc_parse.c) decodes every VLC symbol with
one table lookup on the next 16 bits.  The LUTs are built here from the
same spec tables the Python coder uses (bitstream/cavlc_tables.py — the
single source of truth), and passed to C as one contiguous uint16 buffer:

  entry = (result << 5) | code_length      (0 = invalid code)

Layout (each table 65536 entries):
  [0..2]   coeff_token, ctx 0..2 (nC ranges <2, <4, <8); result =
           total_coeff * 4 + trailing_ones
  [3]      coeff_token, chroma DC (nC == -1), same result packing
  [4..18]  total_zeros for total_coeff 1..15; result = total_zeros
  [19..21] total_zeros chroma DC for total_coeff 1..3
  [22..28] run_before for min(zeros_left, 7) = 1..7; result = run
"""

from __future__ import annotations

import numpy as np

from .cavlc_tables import (COEFF_TOKEN, RUN_BEFORE, TOTAL_ZEROS,
                           TOTAL_ZEROS_CHROMA_DC)

N_TABLES = 29
_cached = None


def _fill(lut, entries):
    """entries: iterable of (value_bits, length, result)."""
    for v, ln, res in entries:
        if ln == 0 or ln > 16:
            raise ValueError((v, ln, res))
        base = v << (16 - ln)
        lut[base:base + (1 << (16 - ln))] = (res << 5) | ln


def build_luts() -> np.ndarray:
    """(N_TABLES, 65536) uint16, C-contiguous."""
    global _cached
    if _cached is not None:
        return _cached
    luts = np.zeros((N_TABLES, 1 << 16), np.uint16)
    # coeff_token: COEFF_TOKEN[ctx][(t1, tc)] = (value, length).  The
    # spec's chroma-DC table is the 4th entry when present; mirror
    # coeff_token_ctx()'s indexing.
    from .cavlc_tables import coeff_token_ctx
    ctx_cdc = coeff_token_ctx(-1)
    for ci in range(3):
        _fill(luts[ci], ((v, ln, tc * 4 + t1)
                         for (t1, tc), (v, ln) in COEFF_TOKEN[ci].items()))
    _fill(luts[3], ((v, ln, tc * 4 + t1)
                    for (t1, tc), (v, ln) in COEFF_TOKEN[ctx_cdc].items()))
    for tc in range(1, 16):
        _fill(luts[4 + tc - 1],
              ((v, ln, tz) for tz, (v, ln) in
               enumerate(TOTAL_ZEROS[tc]) if ln > 0))
    for tc in range(1, 4):
        _fill(luts[19 + tc - 1],
              ((v, ln, tz) for tz, (v, ln) in
               enumerate(TOTAL_ZEROS_CHROMA_DC[tc]) if ln > 0))
    for zl in range(1, 8):
        _fill(luts[22 + zl - 1],
              ((v, ln, run) for run, (v, ln) in
               enumerate(RUN_BEFORE[zl]) if ln > 0))
    _cached = np.ascontiguousarray(luts)
    return _cached
