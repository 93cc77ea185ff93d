# Frozen copy of x264vfw_tpu_torch/bitstream/cabac.py at commit 4a379f6, the benchmark's
# reference decoder: its imports are rewritten to this folder, and
# decode_ueg's suffix loop raises past 32 bits (a damaged slice raises
# instead of reading forever).
"""CABAC arithmetic coding engine (ITU-T Rec. H.264 §9.3.4) + slice coding.

Scalar reference implementation of the binary arithmetic encoder/decoder
(regular, bypass and terminate modes) over the 1024-context state array,
plus the slice-level syntax binarization for the feature set our encoder
emits (P_Skip / P_L0_16x16 P slices and I_16x16 I slices, 4:2:0 CAVLC-
equivalent residual categories).

Capability replaced: libx264's CABAC entropy coder (the --cabac/--no-cabac
surface, reference codec.c:865-866).  The encoder's arithmetic coder is a
host stage fed by the device's syntax tensors, its per-bin loop in C
(csrc/host/cabac_ext.c); this module is the behavioural model, and the
decoder's (decode/decoder.py through bitstream/cabac_slice.py).

Conformance oracle: streams must decode bit-exactly in stock libavcodec
(tests/oracle.py) and in our own decoder.
"""

from __future__ import annotations

import numpy as np

from .cabac_tables import CTX_INIT_I, CTX_INIT_PB, RANGE_LPS, TRANS_LPS, \
    TRANS_MPS

TERMINATE_CTX = 276


def init_contexts(slice_type_i: bool, qp: int, cabac_init_idc: int = 0):
    """(state, mps) arrays for ctxIdx 0..1023 (§9.3.1.1)."""
    t = CTX_INIT_I if slice_type_i else CTX_INIT_PB[cabac_init_idc]
    m, n = t[:, 0].astype(np.int64), t[:, 1].astype(np.int64)
    pre = np.clip(((m * np.clip(qp, 0, 51)) >> 4) + n, 1, 126)
    mps = (pre > 63).astype(np.int32)
    state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)
    return state, mps


class CabacEncoder:
    """§9.3.4 arithmetic encoder writing into a byte list (RBSP payload,
    starting byte-aligned after the cabac_alignment_one_bit)."""

    def __init__(self, state: np.ndarray, mps: np.ndarray):
        self.state = state
        self.mps = mps
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._bits: list[int] = []

    # --- §9.3.4.2 PutBit ---
    def _put(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self._bits.append(b)
        if self.bits_outstanding:
            self._bits.extend([1 - b] * self.bits_outstanding)
            self.bits_outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, binval: int) -> None:
        s = self.state[ctx]
        rlps = int(RANGE_LPS[s, (self.range >> 6) & 3])
        self.range -= rlps
        if binval != self.mps[ctx]:
            self.low += self.range
            self.range = rlps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = TRANS_LPS[s]
        else:
            self.state[ctx] = TRANS_MPS[s]
        self._renorm()

    def bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            # §9.3.4.5 EncodeFlush
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self._bits.extend([(self.low >> 8) & 1, 1])
        else:
            self._renorm()

    def bytes(self) -> bytes:
        """RBSP bytes after terminate(1) (already rbsp_stop_bit aligned:
        the flush emits the stop bit; pad with zeros)."""
        bits = self._bits
        out = bytearray()
        acc = 0
        n = 0
        for b in bits:
            acc = (acc << 1) | b
            n += 1
            if n == 8:
                out.append(acc)
                acc = n = 0
        if n:
            out.append(acc << (8 - n))
        return bytes(out)


class CabacDecoder:
    def __init__(self, state: np.ndarray, mps: np.ndarray, data: bytes):
        self.state = state
        self.mps = mps
        self.data = data
        self.pos = 0
        self.bitpos = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        if self.pos >= len(self.data):
            return 0
        b = (self.data[self.pos] >> (7 - self.bitpos)) & 1
        self.bitpos += 1
        if self.bitpos == 8:
            self.bitpos = 0
            self.pos += 1
        return b

    def decision(self, ctx: int) -> int:
        s = self.state[ctx]
        rlps = int(RANGE_LPS[s, (self.range >> 6) & 3])
        self.range -= rlps
        if self.offset >= self.range:
            binval = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = rlps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = TRANS_LPS[s]
        else:
            binval = int(self.mps[ctx])
            self.state[ctx] = TRANS_MPS[s]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return int(binval)

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


# ---------------------------------------------------------------------------
# binarizations (§9.3.2)
# ---------------------------------------------------------------------------

def encode_ueg(enc: CabacEncoder, value: int, ctxs: list[int], k: int,
               ucoff: int, sign: int | None = None) -> None:
    """UEGk binarization: TU prefix (context-coded, ctx per bin from `ctxs`,
    last entry reused) capped at ucoff, then EGk suffix in bypass, then
    optional sign in bypass."""
    prefix = min(value, ucoff)
    for i in range(prefix):
        enc.decision(ctxs[min(i, len(ctxs) - 1)], 1)
    if prefix < ucoff:
        enc.decision(ctxs[min(prefix, len(ctxs) - 1)], 0)
    else:
        # EGk suffix (§9.3.2.4), bypass-coded
        suf = value - ucoff
        kk = k
        while suf >= (1 << kk):
            enc.bypass(1)
            suf -= 1 << kk
            kk += 1
        enc.bypass(0)
        for i in range(kk - 1, -1, -1):
            enc.bypass((suf >> i) & 1)
    if sign is not None:
        enc.bypass(sign)


def decode_ueg(dec: CabacDecoder, ctxs: list[int], k: int, ucoff: int,
               with_sign: bool):
    value = 0
    while value < ucoff and dec.decision(ctxs[min(value, len(ctxs) - 1)]):
        value += 1
    if value == ucoff:
        kk = k
        while dec.bypass():
            value += 1 << kk
            kk += 1
            if kk > 32:
                raise ValueError("UEGk suffix past 32 bits")
        for i in range(kk - 1, -1, -1):
            value += dec.bypass() << i
    sign = dec.bypass() if (with_sign and value) else 0
    return value, sign
