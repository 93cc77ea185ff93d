# Frozen copy of x264vfw_tpu_torch/bitstream/nal.py at commit 4a379f6, the benchmark's
# reference decoder: only its imports are rewritten to this folder.
"""NAL unit framing (ITU-T H.264 §7.3.1 / Annex B).

Equivalent capability to the NAL handling the reference gets from libx264
(emission) and from its in-place size-prefixed->Annex-B rewrite on the decode
path (reference codec.c:2190-2221).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitstream import escape_ebsp, unescape_ebsp

# nal_unit_type values (§7.4.1, Table 7-1)
NAL_SLICE = 1
NAL_SLICE_DPA = 2
NAL_SLICE_DPB = 3
NAL_SLICE_DPC = 4
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_FILLER = 12

START_CODE_LONG = b"\x00\x00\x00\x01"
START_CODE_SHORT = b"\x00\x00\x01"


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: np.ndarray  # unescaped payload bytes

    @property
    def is_slice(self) -> bool:
        return self.nal_unit_type in (NAL_SLICE, NAL_SLICE_IDR)


def wrap_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: np.ndarray | bytes,
             long_start_code: bool = True) -> bytes:
    """RBSP payload -> Annex-B NAL unit bytes."""
    header = bytes([(nal_ref_idc << 5) | nal_unit_type])
    sc = START_CODE_LONG if long_start_code else START_CODE_SHORT
    return sc + header + escape_ebsp(rbsp)


def split_annexb(data: bytes | np.ndarray) -> list[NalUnit]:
    """Parse an Annex-B byte stream into NAL units (unescaped)."""
    b = np.frombuffer(bytes(data) if not isinstance(data, np.ndarray) else data.tobytes(),
                      dtype=np.uint8)
    if b.size < 4:
        return []
    # find all 00 00 01 positions
    sc = np.nonzero((b[:-2] == 0) & (b[1:-1] == 0) & (b[2:] == 1))[0]
    if sc.size == 0:
        return []
    units: list[NalUnit] = []
    starts = (sc + 3).tolist()
    # each NAL runs to the next start code (minus any trailing zeros that
    # belong to the next code's 00 00 [00] 01 prefix)
    bounds = sc.tolist()[1:] + [b.size]
    for s, e in zip(starts, bounds):
        # trim trailing zero bytes that are part of the next start code prefix
        while e > s and b[e - 1] == 0:
            e -= 1
        if e <= s:
            continue
        hdr = int(b[s])
        units.append(NalUnit(
            nal_ref_idc=(hdr >> 5) & 3,
            nal_unit_type=hdr & 0x1F,
            rbsp=unescape_ebsp(b[s + 1:e]),
        ))
    return units


def avcc_to_annexb(data: bytes, nal_length_size: int = 4) -> bytes:
    """Size-prefixed (avcC) NALs -> Annex-B (ref: codec.c:2190-2221)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i + nal_length_size <= n:
        size = int.from_bytes(data[i:i + nal_length_size], "big")
        i += nal_length_size
        if size == 0 or i + size > n:
            break
        out += START_CODE_LONG
        out += data[i:i + size]
        i += size
    return bytes(out)


def annexb_to_avcc(data: bytes, nal_length_size: int = 4) -> bytes:
    """Annex-B -> size-prefixed NAL stream (for MP4/MKV/FLV muxing)."""
    out = bytearray()
    for nal in iter_annexb_raw(data):
        out += len(nal).to_bytes(nal_length_size, "big")
        out += nal
    return bytes(out)


def iter_annexb_raw(data: bytes) -> list[bytes]:
    """Split Annex-B into raw (still-escaped) NAL byte strings."""
    b = np.frombuffer(data, dtype=np.uint8)
    if b.size < 4:
        return []
    sc = np.nonzero((b[:-2] == 0) & (b[1:-1] == 0) & (b[2:] == 1))[0]
    out = []
    starts = (sc + 3).tolist()
    bounds = sc.tolist()[1:] + [b.size]
    for s, e in zip(starts, bounds):
        while e > s and b[e - 1] == 0:
            e -= 1
        if e > s:
            out.append(b[s:e].tobytes())
    return out
