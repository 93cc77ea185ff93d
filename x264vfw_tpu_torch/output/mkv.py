"""Matroska muxer — native EBML writer.

Capability match for the reference's output/matroska.c + matroska_ebml.c:
avcC CodecPrivate, SAR-derived display size, millisecond timecodes,
cluster splitting when the int16 relative timecode would overflow or the
cluster exceeds ~1 MiB (matroska_ebml.c:413-415,447), duration backpatch on
close (matroska_ebml.c:492-509).
"""

from __future__ import annotations

import struct

from .base import Muxer, MuxParams
from ..bitstream.avcc import build_avcc
from ..bitstream.nal import annexb_to_avcc

# EBML element IDs (verbatim byte sequences)
ID_EBML = b"\x1a\x45\xdf\xa3"
ID_SEGMENT = b"\x18\x53\x80\x67"
ID_INFO = b"\x15\x49\xa9\x66"
ID_TRACKS = b"\x16\x54\xae\x6b"
ID_CLUSTER = b"\x1f\x43\xb6\x75"

CLUSTER_SIZE_LIMIT = 1 << 20
TIMECODE_SCALE = 1_000_000  # ns per tick -> ms ticks


def ebml_size(n: int) -> bytes:
    """EBML variable-length size."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            v = n | (1 << (7 * length))
            return v.to_bytes(length, "big")
    raise ValueError(n)


def elem(eid: bytes, payload: bytes) -> bytes:
    return eid + ebml_size(len(payload)) + payload


def uint_elem(eid: bytes, v: int) -> bytes:
    nb = max(1, (v.bit_length() + 7) // 8)
    return elem(eid, v.to_bytes(nb, "big"))


def float_elem(eid: bytes, v: float) -> bytes:
    return elem(eid, struct.pack(">d", v))


def str_elem(eid: bytes, s: str) -> bytes:
    return elem(eid, s.encode())


class MkvMuxer(Muxer):
    name = "mkv"

    def set_param(self, params: MuxParams) -> None:
        super().set_param(params)
        self._frames: list = []
        self._cluster: list = []
        self._cluster_tc = 0
        self._cluster_bytes = 0
        self._duration_pos = None
        self._largest_tc = 0

    def _ms(self, ts: int) -> int:
        p = self.params
        return (ts * p.timebase_num * 1000) // p.timebase_den

    def write_headers(self, sps: bytes, pps: bytes, sei: bytes = b"") -> int:
        p = self.params
        ebml_hdr = elem(ID_EBML, b"".join([
            uint_elem(b"\x42\x86", 1),       # EBMLVersion
            uint_elem(b"\x42\xf7", 1),       # EBMLReadVersion
            uint_elem(b"\x42\xf2", 4),       # EBMLMaxIDLength
            uint_elem(b"\x42\xf3", 8),       # EBMLMaxSizeLength
            str_elem(b"\x42\x82", "matroska"),
            uint_elem(b"\x42\x87", 2),       # DocTypeVersion
            uint_elem(b"\x42\x85", 2),       # DocTypeReadVersion
        ]))
        n = self._w(ebml_hdr)
        # Segment with unknown size (streamed; duration backpatched)
        n += self._w(ID_SEGMENT + b"\x01\xff\xff\xff\xff\xff\xff\xff")

        prefix = (uint_elem(b"\x2a\xd7\xb1", TIMECODE_SCALE)
                  + str_elem(b"\x4d\x80", "x264vfw_tpu")    # MuxingApp
                  + str_elem(b"\x57\x41", "x264vfw_tpu"))   # WritingApp
        dur = float_elem(b"\x44\x89", 0.0)  # placeholder, backpatched
        body = prefix + dur
        # file offset of the 8 float bytes: after Info ID+size, prefix,
        # and the Duration element's 2-byte ID + 1-byte size
        self._duration_pos = (self.f.tell() + len(ID_INFO)
                              + len(ebml_size(len(body))) + len(prefix) + 3)
        n += self._w(elem(ID_INFO, body))

        # display size from SAR (reference matroska.c:66-109)
        dw, dh = p.width, p.height
        if p.sar_width and p.sar_height:
            if p.sar_width > p.sar_height:
                dw = p.width * p.sar_width // p.sar_height
            else:
                dh = p.height * p.sar_height // p.sar_width
        video = elem(b"\xe0", b"".join([
            uint_elem(b"\xb0", p.width),
            uint_elem(b"\xba", p.height),
            uint_elem(b"\x54\xb0", dw),
            uint_elem(b"\x54\xba", dh),
        ]))
        avcc = build_avcc(sps, pps)
        track = elem(b"\xae", b"".join([
            uint_elem(b"\xd7", 1),                      # TrackNumber
            uint_elem(b"\x73\xc5", 1),                  # TrackUID
            uint_elem(b"\x83", 1),                      # TrackType video
            str_elem(b"\x86", "V_MPEG4/ISO/AVC"),
            elem(b"\x63\xa2", avcc),                    # CodecPrivate
            uint_elem(b"\x23\xe3\x83",
                      1_000_000_000 * p.fps_den // max(1, p.fps_num)),
            video,
        ]))
        n += self._w(elem(ID_TRACKS, track))
        return n

    def _flush_cluster(self) -> int:
        if not self._cluster:
            return 0
        body = uint_elem(b"\xe7", self._cluster_tc) + b"".join(self._cluster)
        n = self._w(elem(ID_CLUSTER, body))
        self._cluster = []
        self._cluster_bytes = 0
        return n

    def write_frame(self, nalus: bytes, pts: int, dts: int,
                    keyframe: bool) -> int:
        tc = self._ms(pts)
        self._largest_tc = max(self._largest_tc, tc)
        rel = tc - self._cluster_tc
        if self._cluster and (rel >= 32768 or rel < -32768
                              or self._cluster_bytes > CLUSTER_SIZE_LIMIT):
            self._flush_cluster()
        if not self._cluster:
            self._cluster_tc = tc
            rel = 0
        data = annexb_to_avcc(nalus)
        flags = 0x80 if keyframe else 0x00
        block = b"\x81" + struct.pack(">h", rel) + bytes([flags]) + data
        self._cluster.append(elem(b"\xa3", block))  # SimpleBlock
        self._cluster_bytes += len(block)
        return 0

    def close_file(self, largest_pts: int = 0, second_largest_pts: int = 0) -> None:
        if self.f is None:
            return
        self._flush_cluster()
        # duration = last pts + frame duration (reference semantics)
        if largest_pts or second_largest_pts:
            dur = self._ms(2 * largest_pts - second_largest_pts)
        else:
            dur = self._largest_tc
        if self._duration_pos is not None and self.f.seekable():
            end = self.f.tell()
            self.f.seek(self._duration_pos)
            self.f.write(struct.pack(">d", float(dur)))
            self.f.seek(end)
        super().close_file(largest_pts, second_largest_pts)
