# Frozen copy of x264vfw_tpu_torch/utils/bitstream.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""Bit-level writers/readers for H.264 syntax (host finalization stage).

This is the TPU-native framework's equivalent of the bitstream plumbing that
the reference delegates to libx264's internal `bs_t` writer (the reference
wrapper itself never touches bits; see SURVEY.md §2c).  Design goals:

* **Vectorized writing.** The entropy stage consumes *tensors* of
  (codeword, bitlength) pairs produced by the device pipeline or by
  numpy-vectorized CAVLC tables, and packs them into bytes with numpy —
  no per-bit Python loop on the hot path.
* **Exact NAL semantics.** RBSP trailing bits and emulation-prevention
  (00 00 0x -> 00 00 03 0x) escaping per ITU-T H.264 §7.4.1 / §B.1.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BitWriter",
    "BitReader",
    "pack_codes",
    "ue_code",
    "se_code",
    "ue_codes",
    "se_codes",
    "escape_ebsp",
    "unescape_ebsp",
]


def pack_codes(vals: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack MSB-first codewords into a byte array.

    vals:  uint64 array of codeword values (right-aligned).
    lens:  int array of bit lengths (0..57 supported; 0-length entries are
           allowed and skipped).
    Returns (bytes_array, total_bits). The final partial byte (if any) is
    zero-padded on the right.
    """
    vals = np.asarray(vals, dtype=np.uint64)
    lens = np.asarray(lens, dtype=np.int64)
    if vals.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    keep = lens > 0
    if not keep.all():
        vals = vals[keep]
        lens = lens[keep]
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), 0
    # Bit index of each output bit -> (symbol index, position within symbol)
    sym_idx = np.repeat(np.arange(vals.size, dtype=np.int64), lens)
    ends = np.cumsum(lens)
    starts = ends - lens
    pos_in_sym = np.arange(total, dtype=np.int64) - starts[sym_idx]
    shift = (lens[sym_idx] - 1 - pos_in_sym).astype(np.uint64)
    bits = ((vals[sym_idx] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits), total


def ue_code(v: int) -> tuple[int, int]:
    """Unsigned Exp-Golomb codeword (value, bitlength) per H.264 §9.1."""
    x = v + 1
    nbits = x.bit_length()
    return x, 2 * nbits - 1


def se_code(v: int) -> tuple[int, int]:
    """Signed Exp-Golomb codeword per H.264 §9.1.1 (codeNum mapping)."""
    code_num = 2 * v - 1 if v > 0 else -2 * v
    return ue_code(code_num)


def _bitlen_u32(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for positive int64 arrays."""
    # frexp on float64 is exact for values < 2^53
    return np.frexp(x.astype(np.float64))[1].astype(np.int64)


def ue_codes(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized unsigned Exp-Golomb: arrays of (codeword, bitlength)."""
    x = np.asarray(v, dtype=np.int64) + 1
    nb = _bitlen_u32(x)
    return x.astype(np.uint64), 2 * nb - 1


def se_codes(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized signed Exp-Golomb."""
    v = np.asarray(v, dtype=np.int64)
    code_num = np.where(v > 0, 2 * v - 1, -2 * v)
    return ue_codes(code_num)


def escape_ebsp(rbsp: np.ndarray | bytes) -> bytes:
    """RBSP -> EBSP: insert emulation_prevention_three_byte (H.264 §7.4.1.1).

    Within the payload, any of 00 00 {00,01,02,03} becomes 00 00 03 {..}.
    """
    b = np.frombuffer(bytes(rbsp) if not isinstance(rbsp, np.ndarray) else rbsp.tobytes(), dtype=np.uint8)
    if b.size < 3:
        return b.tobytes()
    z = b == 0
    cand = np.nonzero(z[:-2] & z[1:-1] & (b[2:] <= 3))[0] + 2
    if cand.size == 0:
        return b.tobytes()
    out = bytearray()
    prev = 0
    last_ins = -10  # position of last accepted insertion
    for i in cand.tolist():
        if i - 1 == last_ins:
            # an escape byte was just inserted between b[i-2] and b[i-1];
            # the zero run feeding this candidate is broken
            continue
        out += b[prev:i].tobytes()
        out.append(3)
        prev = i
        last_ins = i
    out += b[prev:].tobytes()
    return bytes(out)


def unescape_ebsp(ebsp: bytes | np.ndarray) -> np.ndarray:
    """EBSP -> RBSP: strip emulation_prevention_three_byte."""
    b = np.frombuffer(bytes(ebsp) if not isinstance(ebsp, np.ndarray) else ebsp.tobytes(), dtype=np.uint8)
    if b.size < 3:
        return b.copy()
    z = b == 0
    is3 = b == 3
    nxt_ok = np.ones(b.size, dtype=bool)
    nxt_ok[:-1] = b[1:] <= 3  # last byte of NAL: 03 after 00 00 also stripped
    cand = np.nonzero(z[:-2] & z[1:-1] & is3[2:] & nxt_ok[2:])[0] + 2
    if cand.size == 0:
        return b.copy()
    keep = np.ones(b.size, dtype=bool)
    keep[cand] = False
    return b[keep]


class BitWriter:
    """Accumulates codewords; packs with numpy at flush time.

    Scalar `.u/.ue/.se` calls are for headers (cheap, few per NAL).
    `write_codes` ingests whole numpy arrays for the residual hot path.
    """

    def __init__(self) -> None:
        self._vals: list[np.ndarray] = []
        self._lens: list[np.ndarray] = []
        self._nbits = 0

    # -- scalar syntax elements (headers) --
    def u(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._vals.append(np.array([value], dtype=np.uint64))
        self._lens.append(np.array([nbits], dtype=np.int64))
        self._nbits += nbits

    def ue(self, value: int) -> None:
        v, n = ue_code(value)
        self.u(n, v)

    def se(self, value: int) -> None:
        v, n = se_code(value)
        self.u(n, v)

    # -- vectorized hot path --
    def write_codes(self, vals: np.ndarray, lens: np.ndarray) -> None:
        vals = np.asarray(vals, dtype=np.uint64).ravel()
        lens = np.asarray(lens, dtype=np.int64).ravel()
        self._vals.append(vals)
        self._lens.append(lens)
        self._nbits += int(lens.sum())

    @property
    def bit_position(self) -> int:
        return self._nbits

    def to_slots(self, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(vals, lens) arrays, optionally zero-padded to a fixed size
        (for fixed-shape device finalization)."""
        vals = np.concatenate(self._vals) if self._vals else np.zeros(0, np.uint64)
        lens = np.concatenate(self._lens) if self._lens else np.zeros(0, np.int64)
        if pad_to is not None:
            assert vals.size <= pad_to, (vals.size, pad_to)
            vals = np.pad(vals, (0, pad_to - vals.size))
            lens = np.pad(lens, (0, pad_to - lens.size))
        return vals, lens

    def rbsp_trailing_bits(self) -> None:
        """stop bit + alignment zeros (H.264 §7.3.2.11)."""
        self.u(1, 1)
        pad = (-self._nbits) % 8
        if pad:
            self.u(pad, 0)

    def to_rbsp(self) -> np.ndarray:
        vals = np.concatenate(self._vals) if self._vals else np.zeros(0, np.uint64)
        lens = np.concatenate(self._lens) if self._lens else np.zeros(0, np.int64)
        data, total = pack_codes(vals, lens)
        assert total == self._nbits
        return data

    def to_ebsp_bytes(self) -> bytes:
        return escape_ebsp(self.to_rbsp())


class BitReader:
    """MSB-first bit reader over RBSP bytes (for the decode path / tests)."""

    def __init__(self, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            self._b = data.astype(np.uint8)
        else:
            self._b = np.frombuffer(bytes(data), dtype=np.uint8)
        self._pos = 0  # bit position

    @property
    def bit_position(self) -> int:
        return self._pos

    def bits_remaining(self) -> int:
        return self._b.size * 8 - self._pos

    def u(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self._b.size * 8:
            raise EOFError("bitstream exhausted")
        v = 0
        pos = self._pos
        b = self._b
        while nbits > 0:
            byte_i = pos >> 3
            bit_i = pos & 7
            avail = 8 - bit_i
            take = min(avail, nbits)
            chunk = (int(b[byte_i]) >> (avail - take)) & ((1 << take) - 1)
            v = (v << take) | chunk
            pos += take
            nbits -= take
        self._pos = pos
        return v

    def peek(self, nbits: int) -> int:
        pos = self._pos
        try:
            return self.u(nbits)
        finally:
            self._pos = pos

    def ue(self) -> int:
        # count leading zeros
        lz = 0
        while self.u(1) == 0:
            lz += 1
            if lz > 32:
                raise ValueError("invalid exp-golomb code")
        if lz == 0:
            return 0
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_aligned(self) -> bool:
        return (self._pos & 7) == 0

    def more_rbsp_data(self) -> bool:
        """True if there is data before the rbsp_stop_one_bit (§7.2)."""
        rem = self.bits_remaining()
        if rem <= 0:
            return False
        # find last set bit in the stream (the stop bit)
        b = self._b
        nz = np.nonzero(b)[0]
        if nz.size == 0:
            return False
        last_byte = int(nz[-1])
        v = int(b[last_byte])
        # position of lowest set bit in that byte
        low = (v & -v).bit_length() - 1
        stop_bit_pos = last_byte * 8 + (7 - low)
        return self._pos < stop_bit_pos
