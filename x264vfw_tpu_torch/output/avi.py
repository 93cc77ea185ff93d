"""AVI muxer — native RIFF writer (no libavformat dependency).

Capability match for the reference's output/avi.c, which leaned on
libavformat; per SURVEY.md §2c the rebuild writes RIFF directly:
hdrl (avih + strl/strh/strf with H264 fourcc), movi '00dc' chunks with
in-band Annex-B (repeat-headers mode is forced for AVI in the reference,
codec.c:1148-1149), and an idx1 index. VFR is rejected like the reference
(codec.c:1150-1153).
"""

from __future__ import annotations

import struct

from .base import Muxer, MuxParams


class AviMuxer(Muxer):
    name = "avi"
    needs_global_headers = False  # Annex-B in-band like raw

    def set_param(self, params: MuxParams) -> None:
        super().set_param(params)
        self._index: list[tuple[int, int, bool]] = []  # (offset, size, key)
        self._headers = b""

    def write_headers(self, sps: bytes, pps: bytes, sei: bytes = b"") -> int:
        # stash; AVI carries headers in-band with the first frame
        from ..bitstream.nal import START_CODE_LONG
        self._headers = (START_CODE_LONG + sps + START_CODE_LONG + pps + sei)
        p = self.params
        f = self.f
        # RIFF skeleton with placeholders; sizes patched on close
        f.write(b"RIFF" + b"\x00\x00\x00\x00" + b"AVI ")
        # hdrl
        us_per_frame = p.fps_den * 1_000_000 // max(1, p.fps_num)
        avih = struct.pack("<IIIIIIIIIIIIII",
                           us_per_frame, 0, 0, 0x10,  # HASINDEX
                           0,  # total frames (patched)
                           0, 1, 0,
                           p.width, p.height, 0, 0, 0, 0)
        strh = (b"vids" + b"H264"
                + struct.pack("<IHHIIIIIIII",
                              0, 0, 0, 0,           # flags, pri, lang, init
                              p.fps_den, p.fps_num,  # scale, rate
                              0, 0,                  # start, length (patched)
                              0, 0xFFFFFFFF, 0)      # sugbuf, quality, sampsize
                + struct.pack("<HHHH", 0, 0, p.width, p.height))
        strf = struct.pack("<IiiHHIIiiII",
                           40, p.width, p.height, 1, 24,
                           0x34363248,  # 'H264'
                           p.width * p.height * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        self._avih_frames_pos = 12 + 12 + 8 + 4 * 4  # within file, see below
        f.write(hdrl)
        # patch positions:
        # RIFF(12) + LIST hdrl hdr(12) + 'avih' chunk hdr(8) + 4 dwords
        self._avih_frames_pos = 12 + 12 + 8 + 16
        # dwLength sits 32 bytes into strh data:
        # fccType(4)+fccHandler(4)+flags(4)+pri(2)+lang(2)+init(4)
        # +scale(4)+rate(4)+start(4) = 32
        self._strh_len_pos = 12 + 12 + (8 + 56) + 12 + 8 + 32
        self._movi_pos = f.tell()
        f.write(b"LIST" + b"\x00\x00\x00\x00" + b"movi")
        return 0

    def write_frame(self, nalus: bytes, pts: int, dts: int,
                    keyframe: bool) -> int:
        data = (self._headers + nalus) if keyframe and self._headers else nalus
        off = self.f.tell() - (self._movi_pos + 8)  # offset from 'movi'
        self._index.append((off, len(data), keyframe))
        n = self._w(_chunk(b"00dc", data))
        return n

    def close_file(self, largest_pts: int = 0, second_largest_pts: int = 0) -> None:
        if self.f is None:
            return
        f = self.f
        movi_end = f.tell()
        # idx1
        idx = bytearray()
        for off, size, key in self._index:
            idx += b"00dc" + struct.pack("<III", 0x10 if key else 0, off + 4, size)
        f.write(_chunk(b"idx1", bytes(idx)))
        total = f.tell()
        if f.seekable():
            f.seek(4)
            f.write(struct.pack("<I", total - 8))
            f.seek(self._avih_frames_pos)
            f.write(struct.pack("<I", len(self._index)))
            f.seek(self._strh_len_pos)
            f.write(struct.pack("<I", len(self._index)))
            f.seek(self._movi_pos + 4)
            f.write(struct.pack("<I", movi_end - self._movi_pos - 8))
            f.seek(total)
        super().close_file(largest_pts, second_largest_pts)


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\x00" if len(data) & 1 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(fourcc: bytes, data: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(data) + 4) + fourcc + data
