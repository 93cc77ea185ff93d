"""MP4 (ISO-BMFF) muxer — native minimal writer.

Covers the slice of L-SMASH the reference actually uses for muxing
(SURVEY.md §2b note): ftyp/mdat/moov with full sample tables (stts, stss,
ctts for reordering, stsc/stsz/stco), avc1+avcC sample description, SAR via
pasp, and an edit list expressing initial decode delay
(reference mp4_lsmash.c:146-169, 408-421).

Non-seekable targets (pipes/streams) switch to **fragmented** mode — the
reference forces L-SMASH fragments when the output is not a regular file
(mp4_lsmash.c:199,206-207,428-434): moov carries empty sample tables plus
mvex/trex, and each GOP is emitted as a self-contained moof+mdat pair so a
truncated stream stays playable up to the last complete fragment.
"""

from __future__ import annotations

import struct

from .base import Muxer, MuxParams
from ..bitstream.avcc import build_avcc
from ..bitstream.nal import annexb_to_avcc


def box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def fullbox(btype: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(btype, bytes([version]) + flags.to_bytes(3, "big") + payload)


SAMPLE_FLAGS_SYNC = 0x02000000      # sample_depends_on = 2 (I)
SAMPLE_FLAGS_NON_SYNC = 0x01010000  # depends_on = 1, is_non_sync


class Mp4Muxer(Muxer):
    name = "mp4"
    # None = auto: fragment when the target is not seekable (the reference
    # forces fragments for non-regular files, mp4_lsmash.c:199,206-207)
    fragmented: bool | None = None

    def set_param(self, params: MuxParams) -> None:
        super().set_param(params)
        self._samples: list[tuple[int, int, int, bool]] = []  # (off,size,pts,key)
        self._dts: list[int] = []
        self._avcc = b""
        self._frag: list[tuple[bytes, int, int, bool]] = []  # (data,pts,dts,key)
        self._frag_seq = 0

    def write_headers(self, sps: bytes, pps: bytes, sei: bytes = b"") -> int:
        self._avcc = build_avcc(sps, pps)
        if self.fragmented is None:
            self.fragmented = not self.f.seekable()
        if self.fragmented:
            n = self._w(box(b"ftyp", b"iso5" + struct.pack(">I", 0)
                            + b"iso5" + b"iso6" + b"mp42" + b"isom"))
            return n + self._w(self._moov_fragmented())
        n = self._w(box(b"ftyp", b"mp42" + struct.pack(">I", 0)
                        + b"mp42" + b"mp41" + b"isom"))
        self._mdat_pos = self.f.tell()
        n += self._w(struct.pack(">I", 8) + b"mdat")
        return n

    def write_frame(self, nalus: bytes, pts: int, dts: int,
                    keyframe: bool) -> int:
        data = annexb_to_avcc(nalus)
        if self.fragmented:
            n = 0
            if keyframe and self._frag:
                n = self._flush_fragment()
            self._frag.append((data, pts, dts, keyframe))
            return n
        off = self.f.tell()
        n = self._w(data)
        self._samples.append((off, len(data), pts, keyframe))
        self._dts.append(dts)
        return n

    def _stsd(self) -> bytes:
        p = self.params
        avc1_body = (b"\x00" * 6 + struct.pack(">H", 1)       # reserved+dri
                     + b"\x00" * 16
                     + struct.pack(">HH", p.width, p.height)
                     + struct.pack(">II", 0x480000, 0x480000)  # dpi
                     + struct.pack(">I", 0)
                     + struct.pack(">H", 1)                   # frame count
                     + b"\x00" * 32                           # compressor
                     + struct.pack(">H", 0x18)                # depth
                     + struct.pack(">h", -1))
        avc1_body += box(b"avcC", self._avcc)
        if p.sar_width and p.sar_height:
            avc1_body += box(b"pasp", struct.pack(">II", p.sar_width,
                                                  p.sar_height))
        return fullbox(b"stsd", 0, 0, struct.pack(">I", 1)
                       + box(b"avc1", avc1_body))

    def _moov_fragmented(self) -> bytes:
        """moov with empty sample tables + mvex/trex: all media arrives in
        moof+mdat fragments (mp4_lsmash.c:428-434 shape)."""
        p = self.params
        empty = struct.pack(">I", 0)
        stbl = box(b"stbl", self._stsd()
                   + fullbox(b"stts", 0, 0, empty)
                   + fullbox(b"stsc", 0, 0, empty)
                   + fullbox(b"stsz", 0, 0, struct.pack(">II", 0, 0))
                   + fullbox(b"stco", 0, 0, empty))
        vmhd = fullbox(b"vmhd", 0, 1, b"\x00" * 8)
        dinf = box(b"dinf", fullbox(b"dref", 0, 0, struct.pack(">I", 1)
                                    + fullbox(b"url ", 0, 1, b"")))
        minf = box(b"minf", vmhd + dinf + stbl)
        hdlr = fullbox(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide"
                       + b"\x00" * 12 + b"x264vfw_tpu video\x00")
        mdhd = fullbox(b"mdhd", 0, 0,
                       struct.pack(">IIII", 0, 0, p.timebase_den, 0)
                       + struct.pack(">HH", 0x55C4, 0))
        mdia = box(b"mdia", mdhd + hdlr + minf)
        mtx = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
        tkhd = fullbox(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0, 0)
                       + b"\x00" * 8 + struct.pack(">hhhh", 0, 0, 0, 0)
                       + mtx
                       + struct.pack(">II", p.width << 16, p.height << 16))
        trak = box(b"trak", tkhd + mdia)
        mvhd = fullbox(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 600, 0)
                       + struct.pack(">I", 0x10000) + struct.pack(">H", 0x100)
                       + b"\x00" * 10 + mtx + b"\x00" * 24
                       + struct.pack(">I", 2))
        trex = fullbox(b"trex", 0, 0, struct.pack(">IIIII", 1, 1, 0, 0, 0))
        return box(b"moov", mvhd + trak + box(b"mvex", trex))

    def _flush_fragment(self) -> int:
        """Emit buffered samples as one self-contained moof+mdat pair."""
        if not self._frag:
            return 0
        p = self.params
        delta = p.timebase_num
        self._frag_seq += 1
        mfhd = fullbox(b"mfhd", 0, 0, struct.pack(">I", self._frag_seq))
        # tfhd: default-base-is-moof | default-sample-flags present
        tfhd = fullbox(b"tfhd", 0, 0x020020,
                       struct.pack(">II", 1, SAMPLE_FLAGS_NON_SYNC))
        tfdt = fullbox(b"tfdt", 1,  0,
                       struct.pack(">q", self._frag[0][2] * delta))
        # trun v1 (signed cts): data-offset | first-sample-flags |
        # duration | size | composition offset
        first_flags = (SAMPLE_FLAGS_SYNC if self._frag[0][3]
                       else SAMPLE_FLAGS_NON_SYNC)
        rows = b"".join(
            struct.pack(">IIi", delta, len(d), (pts - dts) * delta)
            for d, pts, dts, _ in self._frag)
        trun_size = 12 + 4 + 8 + len(rows)
        moof_size = 8 + len(mfhd) + 8 + len(tfhd) + len(tfdt) + trun_size
        data = b"".join(d for d, *_ in self._frag)
        trun = fullbox(b"trun", 1, 0x000B05,
                       struct.pack(">I", len(self._frag))
                       + struct.pack(">iI", moof_size + 8, first_flags)
                       + rows)
        assert len(trun) == trun_size
        moof = box(b"moof", mfhd + box(b"traf", tfhd + tfdt + trun))
        self._frag.clear()
        return self._w(moof) + self._w(box(b"mdat", data))

    def close_file(self, largest_pts: int = 0, second_largest_pts: int = 0) -> None:
        if self.f is None:
            return
        if self.fragmented:
            self._flush_fragment()
            super().close_file(largest_pts, second_largest_pts)
            return
        p = self.params
        timescale = p.timebase_den
        delta = p.timebase_num
        ns = len(self._samples)
        dur_media = (2 * largest_pts - second_largest_pts) * delta if ns else 0
        if ns and not largest_pts:
            dur_media = ns * delta

        # ---- sample tables ----
        stts = fullbox(b"stts", 0, 0, struct.pack(">I", 1)
                       + struct.pack(">II", ns, delta))
        keys = [i + 1 for i, s in enumerate(self._samples) if s[3]]
        stss = fullbox(b"stss", 0, 0, struct.pack(">I", len(keys))
                       + b"".join(struct.pack(">I", k) for k in keys))
        # composition offsets: decode time is implicitly k*delta (stts), so
        # offset_k = (pts_k - k + delay)*delta with delay = max(k - pts_k)
        # >= 0; the edit list below skips the initial `delay` of media time
        # (the L-SMASH layout, mp4_lsmash.c:146-169,408-421)
        ctts = b""
        delay = max((k - s[2] for k, s in enumerate(self._samples)),
                    default=0)
        offs = [(s[2] - k + delay) * delta
                for k, s in enumerate(self._samples)]
        if any(o != 0 for o in offs):
            runs = []
            for o in offs:
                if runs and runs[-1][1] == o:
                    runs[-1][0] += 1
                else:
                    runs.append([1, o])
            ctts = fullbox(b"ctts", 0, 0, struct.pack(">I", len(runs))
                           + b"".join(struct.pack(">Ii", c, o) for c, o in runs))
        stsc = fullbox(b"stsc", 0, 0, struct.pack(">I", 1)
                       + struct.pack(">III", 1, 1, 1))
        stsz = fullbox(b"stsz", 0, 0, struct.pack(">II", 0, ns)
                       + b"".join(struct.pack(">I", s[1]) for s in self._samples))
        stco = fullbox(b"stco", 0, 0, struct.pack(">I", ns)
                       + b"".join(struct.pack(">I", s[0]) for s in self._samples))

        stsd = self._stsd()
        stbl = box(b"stbl", stsd + stts + (ctts or b"") + stss + stsc
                   + stsz + stco)
        vmhd = fullbox(b"vmhd", 0, 1, b"\x00" * 8)
        dinf = box(b"dinf", fullbox(b"dref", 0, 0, struct.pack(">I", 1)
                                    + fullbox(b"url ", 0, 1, b"")))
        minf = box(b"minf", vmhd + dinf + stbl)
        hdlr = fullbox(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide"
                       + b"\x00" * 12 + b"x264vfw_tpu video\x00")
        mdhd = fullbox(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, timescale,
                                                  max(0, dur_media))
                       + struct.pack(">HH", 0x55C4, 0))  # und language
        mdia = box(b"mdia", mdhd + hdlr + minf)

        mtx = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        movie_ts = 600
        dur_movie = dur_media * movie_ts // timescale if timescale else 0
        tkhd = fullbox(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0,
                                                  max(0, dur_movie))
                       + b"\x00" * 8 + struct.pack(">hhhh", 0, 0, 0, 0)
                       + mtx
                       + struct.pack(">II", p.width << 16, p.height << 16))
        # edit list skipping the initial reorder delay (mp4_lsmash.c:146-169)
        edts = b""
        if any(o for o in offs):
            media_time = (delay + min((s[2] for s in self._samples),
                                      default=0)) * delta
            elst = fullbox(b"elst", 0, 0, struct.pack(">I", 1)
                           + struct.pack(">IiHH", max(0, dur_movie),
                                         media_time, 1, 0))
            edts = box(b"edts", elst)
        trak = box(b"trak", tkhd + edts + mdia)
        mvhd = fullbox(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, movie_ts,
                                                  max(0, dur_movie))
                       + struct.pack(">I", 0x10000) + struct.pack(">H", 0x100)
                       + b"\x00" * 10 + mtx + b"\x00" * 24
                       + struct.pack(">I", 2))
        moov = box(b"moov", mvhd + trak)
        end = self.f.tell()
        self._w(moov)
        # backpatch mdat size
        if self.f.seekable():
            self.f.seek(self._mdat_pos)
            self.f.write(struct.pack(">I", end - self._mdat_pos))
            self.f.seek(0, 2)
        super().close_file(largest_pts, second_largest_pts)
