"""FLV muxer — native bytestream writer.

Capability match for reference output/flv.c + flv_bytestream.c:
onMetaData AMF array with back-patched duration/filesize/framerate
(flv.c:106-164,315-344), AVC sequence header tag (flv.c:190-219),
per-frame millisecond DTS with CTS offset (flv.c:244-257).
"""

from __future__ import annotations

import struct

from .base import Muxer, MuxParams
from ..bitstream.avcc import build_avcc
from ..bitstream.nal import annexb_to_avcc

FLV_TAG_VIDEO = 9
FLV_TAG_SCRIPT = 18
FRAME_KEY = 1
FRAME_INTER = 2
CODEC_AVC = 7
AVC_SEQ_HEADER = 0
AVC_NALU = 1
AVC_EOS = 2


def amf_str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big") + b


def amf_double(v: float) -> bytes:
    return b"\x00" + struct.pack(">d", v)


class FlvMuxer(Muxer):
    name = "flv"

    def set_param(self, params: MuxParams) -> None:
        super().set_param(params)
        self._n_frames = 0
        self._patch = {}

    def _ms(self, ts: int) -> int:
        p = self.params
        return (ts * p.timebase_num * 1000) // p.timebase_den

    def _tag(self, ttype: int, timestamp_ms: int, payload: bytes) -> int:
        hdr = bytes([ttype]) + len(payload).to_bytes(3, "big")
        hdr += (timestamp_ms & 0xFFFFFF).to_bytes(3, "big")
        hdr += bytes([(timestamp_ms >> 24) & 0xFF])
        hdr += b"\x00\x00\x00"  # stream id
        n = self._w(hdr + payload)
        n += self._w((len(hdr) + len(payload)).to_bytes(4, "big"))
        return n

    def write_headers(self, sps: bytes, pps: bytes, sei: bytes = b"") -> int:
        p = self.params
        n = self._w(b"FLV\x01\x01\x00\x00\x00\x09")  # header, video-only
        n += self._w(b"\x00\x00\x00\x00")            # prev tag size 0

        # onMetaData with patchable doubles
        meta = b"\x02" + amf_str("onMetaData")
        meta += b"\x08" + (7).to_bytes(4, "big")  # ECMA array
        fps = p.fps_num / max(1, p.fps_den)
        fields = [("duration", 0.0), ("width", float(p.width)),
                  ("height", float(p.height)), ("framerate", fps),
                  ("videocodecid", float(CODEC_AVC)),
                  ("videodatarate", 0.0), ("filesize", 0.0)]
        body = bytearray(meta)
        patch_local = {}
        for name, v in fields:
            body += amf_str(name)
            if name in ("duration", "videodatarate", "filesize"):
                patch_local[name] = len(body) + 1  # skip AMF type byte
            body += amf_double(v)
        body += b"\x00\x00\x09"  # object end
        # compute absolute offsets: tag header is 11 bytes
        base = self.f.tell() + 11
        for k, off in patch_local.items():
            self._patch[k] = base + off
        n += self._tag(FLV_TAG_SCRIPT, 0, bytes(body))

        avcc = build_avcc(sps, pps)
        payload = bytes([(FRAME_KEY << 4) | CODEC_AVC, AVC_SEQ_HEADER,
                         0, 0, 0]) + avcc
        n += self._tag(FLV_TAG_VIDEO, 0, payload)
        return n

    def write_frame(self, nalus: bytes, pts: int, dts: int,
                    keyframe: bool) -> int:
        dts_ms = self._ms(dts)
        cts_ms = self._ms(pts) - dts_ms
        data = annexb_to_avcc(nalus)
        ft = FRAME_KEY if keyframe else FRAME_INTER
        payload = bytes([(ft << 4) | CODEC_AVC, AVC_NALU]) \
            + struct.pack(">i", cts_ms)[1:] + data
        self._n_frames += 1
        self._last_dts = dts_ms
        return self._tag(FLV_TAG_VIDEO, dts_ms, payload)

    def close_file(self, largest_pts: int = 0, second_largest_pts: int = 0) -> None:
        if self.f is None:
            return
        # end-of-seq tag
        self._tag(FLV_TAG_VIDEO, getattr(self, "_last_dts", 0),
                  bytes([(FRAME_KEY << 4) | CODEC_AVC, AVC_EOS, 0, 0, 0]))
        total = self.f.tell()
        if largest_pts or second_largest_pts:
            dur_s = self._ms(2 * largest_pts - second_largest_pts) / 1000.0
        else:
            dur_s = getattr(self, "_last_dts", 0) / 1000.0
        if self.f.seekable() and self._patch:
            for name, val in (("duration", dur_s), ("filesize", float(total)),
                              ("videodatarate",
                               total * 8 / 1000.0 / dur_s if dur_s else 0.0)):
                self.f.seek(self._patch[name])
                self.f.write(struct.pack(">d", val))
            self.f.seek(total)
        super().close_file(largest_pts, second_largest_pts)
