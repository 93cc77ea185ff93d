"""Vectorized CAVLC residual coding (numpy, whole-frame batches).

Copy of x264vfw_tpu/bitstream/cavlc_vec.py.  The host finalisation stage
of TorchEncoder's host_entropy path: consumes (N, L) tensors of
zigzag-ordered quantized levels pulled from the device pipeline and
produces per-block codeword slot arrays with NO per-block Python loop —
the only loops are over the <=16 coefficient slots (numpy-vectorized over
all N blocks of a frame at once).  It is the numpy oracle the device
coder (cavlc_dev.py) is held against (tests/test_torch_host_entropy.py).

Slot layout per block (fixed S=33 slots, zero-length slots skipped by
the writer), in coding order:
  0       coeff_token
  1       trailing-one signs (combined, length=t1)
  2..17   up to 16 level codes
  18      total_zeros
  19..32  up to 14 run_before codes
"""

from __future__ import annotations

import numpy as np

from .cavlc_tables import (
    COEFF_TOKEN_LEN,
    COEFF_TOKEN_VAL,
    RUN_BEFORE_LEN,
    RUN_BEFORE_VAL,
    TOTAL_ZEROS_CDC_LEN,
    TOTAL_ZEROS_CDC_VAL,
    TOTAL_ZEROS_LEN,
    TOTAL_ZEROS_VAL,
)

SLOTS = 33


def _ctx_from_nc(nC: np.ndarray) -> np.ndarray:
    ctx = np.full(nC.shape, 4, dtype=np.int64)
    ctx = np.where(nC < 8, 2, ctx)
    ctx = np.where(nC < 4, 1, ctx)
    ctx = np.where(nC < 2, 0, ctx)
    ctx = np.where(nC < 0, 3, ctx)
    return ctx


def encode_blocks(levels: np.ndarray, nC: np.ndarray,
                  max_coeffs: int) -> tuple[np.ndarray, np.ndarray]:
    """CAVLC-encode N blocks at once.

    levels: (N, L) int32 zigzag levels (L == max_coeffs)
    nC:     (N,) int (-1 for chroma DC)
    Returns (vals, lens): (N, SLOTS) uint32 / int8 codeword arrays.
    """
    levels = np.asarray(levels, dtype=np.int64)
    N, L = levels.shape
    assert L == max_coeffs
    nC = np.asarray(nC, dtype=np.int64)
    vals = np.zeros((N, SLOTS), dtype=np.uint32)
    lens = np.zeros((N, SLOTS), dtype=np.int8)
    if N == 0:
        return vals, lens

    nz = levels != 0
    tc = nz.sum(-1).astype(np.int64)                      # (N,)
    # nonzero values & positions in scan order, packed to the left
    order = np.argsort(~nz, axis=-1, kind="stable")       # (N, L)
    v_sorted = np.take_along_axis(levels, order, axis=-1)  # nonzeros first
    p_sorted = order                                       # their positions

    # trailing ones (up to 3 consecutive |1| at the high-frequency end)
    t1 = np.zeros(N, dtype=np.int64)
    cond = np.ones(N, dtype=bool)
    for k in range(1, 4):
        idx = np.clip(tc - k, 0, L - 1)
        vk = np.take_along_axis(v_sorted, idx[:, None], axis=-1)[:, 0]
        cond = cond & (tc >= k) & (np.abs(vk) == 1)
        t1 += cond

    # ---- coeff_token ----
    ctx = _ctx_from_nc(nC)
    vals[:, 0] = COEFF_TOKEN_VAL[ctx, tc, t1]
    lens[:, 0] = COEFF_TOKEN_LEN[ctx, tc, t1]

    # ---- trailing one signs ----
    sign_val = np.zeros(N, dtype=np.uint32)
    for i in range(3):
        idx = np.clip(tc - 1 - i, 0, L - 1)
        vk = np.take_along_axis(v_sorted, idx[:, None], axis=-1)[:, 0]
        neg = (vk < 0) & (i < t1)
        sign_val = np.where(i < t1, (sign_val << 1) | neg.astype(np.uint32), sign_val)
    vals[:, 1] = sign_val
    lens[:, 1] = t1.astype(np.int8)

    # ---- levels ----
    sl = np.where((tc > 10) & (t1 < 3), 1, 0).astype(np.int64)
    for k in range(L):
        active = (k >= t1) & (k < tc)
        if not active.any():
            continue
        idx = np.clip(tc - 1 - k, 0, L - 1)
        lv = np.take_along_axis(v_sorted, idx[:, None], axis=-1)[:, 0]
        lv = np.where(active, lv, 1)
        lc = np.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        first = (k == t1) & (t1 < 3)
        lc = lc - 2 * first
        # --- encode (lc, sl) -> (prefix_len p, suffix, suffix_size) ---
        p = np.zeros(N, dtype=np.int64)
        suffix = np.zeros(N, dtype=np.int64)
        ssz = np.zeros(N, dtype=np.int64)
        # case A: sl == 0
        a1 = (sl == 0) & (lc < 14)
        p = np.where(a1, lc, p)
        a2 = (sl == 0) & (lc >= 14) & (lc < 30)
        p = np.where(a2, 14, p)
        suffix = np.where(a2, lc - 14, suffix)
        ssz = np.where(a2, 4, ssz)
        # case B: sl > 0, non-escape
        b1 = (sl > 0) & (lc < (15 << np.maximum(sl, 1)))
        p = np.where(b1, lc >> np.maximum(sl, 1), p)
        suffix = np.where(b1, lc & ((1 << np.maximum(sl, 1)) - 1), suffix)
        ssz = np.where(b1, sl, ssz)
        # case C: escape (p >= 15)
        esc = ((sl == 0) & (lc >= 30)) | ((sl > 0) & ~b1)
        base = np.where(sl == 0, 30, 15 << np.maximum(sl, 1))
        rem = np.maximum(lc - base, 0)
        # p = 15 + k, rem ranges [4096*(2^k - 1), 4096*(2^(k+1)-1))
        kk = np.frexp((rem / 4096.0) + 1.0)[1] - 1  # floor(log2(rem/4096+1))
        kk = kk.astype(np.int64)
        off = (np.int64(4096) << kk) - 4096
        p = np.where(esc, 15 + kk, p)
        suffix = np.where(esc, rem - off, suffix)
        ssz = np.where(esc, 12 + kk, ssz)
        code_val = ((np.uint64(1) << ssz.astype(np.uint64))
                    | suffix.astype(np.uint64))
        code_len = p + 1 + ssz
        vals[:, 2 + k] = np.where(active, code_val, 0).astype(np.uint32)
        lens[:, 2 + k] = np.where(active, code_len, 0).astype(np.int8)
        # suffix length adaptation
        new_sl = np.where(sl == 0, 1, sl)
        new_sl = new_sl + ((np.abs(lv) > (3 << np.maximum(new_sl - 1, 0)))
                           & (new_sl < 6))
        sl = np.where(active, new_sl, sl)

    # ---- total_zeros ----
    last_idx = np.clip(tc - 1, 0, L - 1)
    last_pos = np.take_along_axis(p_sorted, last_idx[:, None], axis=-1)[:, 0]
    tz = np.where(tc > 0, last_pos + 1 - tc, 0).astype(np.int64)
    need_tz = (tc > 0) & (tc < max_coeffs)
    tzc = np.clip(tz, 0, 15)
    tcc = np.clip(tc, 0, 15)
    if max_coeffs == 4:  # chroma DC
        tzv = TOTAL_ZEROS_CDC_VAL[np.clip(tcc, 0, 3), np.clip(tzc, 0, 3)]
        tzl = TOTAL_ZEROS_CDC_LEN[np.clip(tcc, 0, 3), np.clip(tzc, 0, 3)]
    else:
        tzv = TOTAL_ZEROS_VAL[tcc, tzc]
        tzl = TOTAL_ZEROS_LEN[tcc, tzc]
    vals[:, 18] = np.where(need_tz, tzv, 0)
    lens[:, 18] = np.where(need_tz, tzl, 0).astype(np.int8)

    # ---- run_before ----
    zl = np.where(need_tz | (tc == max_coeffs), tz, 0).astype(np.int64)
    for k in range(min(L - 1, 14)):
        active = (k < tc - 1) & (zl > 0)
        if not active.any():
            break
        hi_idx = np.clip(tc - 1 - k, 0, L - 1)
        lo_idx = np.clip(tc - 2 - k, 0, L - 1)
        hi = np.take_along_axis(p_sorted, hi_idx[:, None], axis=-1)[:, 0]
        lo = np.take_along_axis(p_sorted, lo_idx[:, None], axis=-1)[:, 0]
        run = np.clip(hi - lo - 1, 0, 14)
        zli = np.clip(zl, 1, 7)
        rv = RUN_BEFORE_VAL[zli, run]
        rl = RUN_BEFORE_LEN[zli, run]
        vals[:, 19 + k] = np.where(active, rv, 0)
        lens[:, 19 + k] = np.where(active, rl, 0).astype(np.int8)
        zl = np.where(active, zl - run, zl)
    return vals, lens
