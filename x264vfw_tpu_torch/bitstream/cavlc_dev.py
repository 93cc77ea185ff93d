"""CAVLC residual coding on tensors (PyTorch) — port of cavlc_jax.py.

CAVLC's table lookups and per-coefficient codes are data-parallel per
block; only the suffix-length adaptation is a short (<= 16 step) chain,
run as 16 table lookups over all blocks of a frame at once (its 7 states
make each step a table), after which every level code is formed in one
pass.  Together
with encode/device_pack.py this keeps the whole entropy stage on the
device; only packed bitstream bytes cross to the host.

Table lookups are plain gathers (the JAX code's one-hot select-sums exist
because gathers are slow on a TPU).  Code values are int64 tensors holding
the JAX package's uint32 values (<= 31 significant bits; longer codes
carry implicit leading zeros, the device_pack convention); lengths are
int32.  (vals, lens) equal cavlc_jax.encode_blocks's slot for slot.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import cavlc_tables as T

SLOTS = 34

_TABLES = {
    "ct": (T.COEFF_TOKEN_VAL, T.COEFF_TOKEN_LEN),       # (5, 17, 4)
    "tz": (T.TOTAL_ZEROS_VAL, T.TOTAL_ZEROS_LEN),       # (16, 16)
    "tzc": (T.TOTAL_ZEROS_CDC_VAL, T.TOTAL_ZEROS_CDC_LEN),  # (4, 4)
    "rb": (T.RUN_BEFORE_VAL, T.RUN_BEFORE_LEN),         # (8, 15)
}


@lru_cache(maxsize=None)
def _table(name: str, device: torch.device):
    """(flat values int64, flat lengths int32, row width) on `device`."""
    val, ln = _TABLES[name]
    return (torch.as_tensor(val.reshape(-1).astype("int64"), device=device),
            torch.as_tensor(ln.reshape(-1).astype("int32"), device=device),
            val.shape[-1])


def _lut2(name: str, i: torch.Tensor, j: torch.Tensor):
    """2D table lookup: (values int64, lengths int32)."""
    v, ln, C = _table(name, i.device)
    flat = (i * C + j).long()
    return v[flat], ln[flat]


def _ctx_from_nc(nC: torch.Tensor) -> torch.Tensor:
    ctx = torch.full_like(nC, 4)
    ctx = torch.where(nC < 8, 2, ctx)
    ctx = torch.where(nC < 4, 1, ctx)
    ctx = torch.where(nC < 2, 0, ctx)
    return torch.where(nC < 0, 3, ctx)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative integers below 2^53 (exact via the
    float64 exponent), as int32."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int32)


def encode_blocks(levels: torch.Tensor, nC: torch.Tensor, max_coeffs: int):
    """(N, L) zigzag levels + (N,) nC -> (vals int64, lens int32) (N, SLOTS).

    Position-indexed slot layout: the level code of the coefficient at
    zigzag position j lives in slot 2 + (L-1-j) and its run_before in
    slot 19 + (L-1-j); descending position order IS the CAVLC coding
    order, and zero-length slots vanish in the packer."""
    levels = levels.to(torch.int32)
    N, L = levels.shape
    if L != max_coeffs:
        raise ValueError(f"{L} coefficients per block, expected {max_coeffs}")
    dev = levels.device
    nC = nC.to(torch.int32)
    idx = torch.arange(L, dtype=torch.int32, device=dev)

    nz = levels != 0
    cum = torch.cumsum(nz.to(torch.int32), dim=-1, dtype=torch.int32)
    tc = cum[:, -1]
    snz = tc[:, None] - cum                         # nonzeros at pos > j

    # ---- trailing ones: the run of +-1 nonzeros at the end, capped at 3 ----
    m = nz & (levels.abs() == 1)
    ok = (~nz) | m
    # AND over strictly-higher positions
    rev_and = torch.flip(torch.cumprod(torch.flip(ok.to(torch.int32), [-1]),
                                       dim=-1), [-1])
    rev_and_excl = torch.cat([rev_and[:, 1:], rev_and.new_ones(N, 1)],
                             dim=-1).bool()
    is_t1 = nz & m & rev_and_excl & (snz < 3)
    t1 = is_t1.sum(-1, dtype=torch.int32)

    vals = torch.zeros(N, SLOTS, dtype=torch.int64, device=dev)
    lens = torch.zeros(N, SLOTS, dtype=torch.int32, device=dev)

    # ---- coeff_token ----
    ctv, ctl = _lut2("ct", _ctx_from_nc(nC) * 17 + tc, t1)
    vals[:, 0] = ctv
    lens[:, 0] = ctl

    # ---- trailing one signs (slot 1): i-th-from-end sign at bit t1-1-i ----
    neg = ((levels < 0) & is_t1).to(torch.int64)
    shift = (t1[:, None] - 1 - snz).clamp(0, 31)
    vals[:, 1] = (neg << shift).sum(-1)
    lens[:, 1] = t1

    # ---- levels: suffixLength is a chain in descending position order.
    # It has 7 states (0..6), so each position's step is a table of the
    # next state per state; the chain is 16 table lookups, and then every
    # level code is formed at once from the state it met.
    active = nz & (snz >= t1[:, None])              # coded as a level code
    lc_all = torch.where(levels > 0, 2 * levels - 2, -2 * levels - 1)
    lc_all = lc_all - 2 * ((snz == t1[:, None]) & (t1[:, None] < 3)
                           & active).to(torch.int32)
    states = torch.arange(7, dtype=torch.int32, device=dev)
    s1 = states.clamp(min=1)
    bump = (levels.abs()[:, :, None] > (3 << (s1 - 1))) & (s1 < 6)
    step = torch.where(active[:, :, None], s1 + bump.to(torch.int32),
                       states).to(torch.int64)      # (N, L, 7)
    sl = ((tc > 10) & (t1 < 3)).to(torch.int64)[:, None]
    met = torch.empty(N, L, dtype=torch.int64, device=dev)
    for j in range(L - 1, -1, -1):
        met[:, j] = sl[:, 0]
        sl = step[:, j].gather(1, sl)
    sl = met.to(torch.int32)                        # the state at position j
    sl1 = sl.clamp(min=1)
    lc = lc_all
    zero = torch.zeros_like(lc)
    a1 = (sl == 0) & (lc < 14)
    p = torch.where(a1, lc, zero)
    a2 = (sl == 0) & (lc >= 14) & (lc < 30)
    p = torch.where(a2, 14, p)
    suffix = torch.where(a2, lc - 14, zero)
    ssz = torch.where(a2, 4, zero)
    lim = 15 << sl1
    b1 = (sl > 0) & (lc < lim)
    p = torch.where(b1, lc >> sl1, p)
    suffix = torch.where(b1, lc & ((1 << sl1) - 1), suffix)
    ssz = torch.where(b1, sl, ssz)
    esc = ((sl == 0) & (lc >= 30)) | ((sl > 0) & (lc >= lim))
    base = torch.where(sl == 0, 30, lim)
    rem = (lc - base).clamp(min=0)
    # floor(log2(rem / 4096 + 1)), exactly as the float32 frexp of the
    # JAX code gives it for rem < 2^24
    kk = bit_length((rem + 4096) >> 12) - 1
    off = (4096 << kk) - 4096
    p = torch.where(esc, 15 + kk, p)
    suffix = torch.where(esc, rem - off, suffix)
    ssz = torch.where(esc, 12 + kk, ssz)
    code_val = (1 << ssz.to(torch.int64)) | suffix.to(torch.int64)
    # position j's code in slot 2 + (L - 1 - j)
    vals[:, 2:2 + L] = torch.where(active, code_val, 0).flip(-1)
    lens[:, 2:2 + L] = torch.where(active, p + 1 + ssz, 0).flip(-1)

    # ---- total_zeros (slot 18) ----
    last_pos = torch.where(nz, idx, -1).amax(dim=-1)
    tz = torch.where(tc > 0, last_pos + 1 - tc, 0)
    need = (tc > 0) & (tc < max_coeffs)
    if max_coeffs == 4:
        tzv, tzl = _lut2("tzc", tc.clamp(0, 3), tz.clamp(0, 3))
    else:
        tzv, tzl = _lut2("tz", tc.clamp(0, 15), tz.clamp(0, 15))
    vals[:, 18] = torch.where(need, tzv, 0)
    lens[:, 18] = torch.where(need, tzl, 0)

    # ---- run_before: coefficient at j (not the lowest nonzero), slot
    # 19 + (L-1-j); zerosLeft at j = zeros at positions < j ----
    prev_incl = torch.cummax(torch.where(nz, idx, -1), dim=1).values
    prev_below = torch.cat([torch.full_like(prev_incl[:, :1], -1),
                            prev_incl[:, :-1]], dim=-1)
    run = (idx - prev_below - 1).clamp(0, 14)
    zl = idx - cum + 1
    run_active = nz & (prev_below >= 0) & (zl > 0)
    rv, rl = _lut2("rb", zl.clamp(1, 7), run)
    # position 0 never carries a run: slots 19 .. 19+L-2 hold j = L-1 .. 1
    vals[:, 19:19 + L - 1] = torch.where(run_active, rv, 0)[:, 1:].flip(-1)
    lens[:, 19:19 + L - 1] = torch.where(run_active, rl, 0)[:, 1:].flip(-1)
    return vals, lens


def ue_codes_dev(v: torch.Tensor):
    """Unsigned exp-Golomb codes (vals int64, lens int32); counterpart of
    cavlc_jax.ue_codes_j."""
    x = v.to(torch.int64) + 1
    return x, 2 * bit_length(x) - 1


def se_codes_dev(v: torch.Tensor):
    """Signed exp-Golomb codes; counterpart of cavlc_jax.se_codes_j."""
    v = v.to(torch.int64)
    return ue_codes_dev(torch.where(v > 0, 2 * v - 1, -2 * v))
