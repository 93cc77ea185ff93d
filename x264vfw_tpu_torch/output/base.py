"""Muxer interface — the cli_output_t vtable shape of the reference
(reference output/output.h:35-42): open_file / set_param /
write_headers / write_frame / close_file, driven by the session layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO


@dataclass
class MuxParams:
    """Stream parameters handed to set_param (reference passes x264_param_t)."""
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    timebase_num: int = 1
    timebase_den: int = 25
    sar_width: int = 0
    sar_height: int = 0
    b_frames: bool = False
    annexb_headers: bool = False  # raw/AVI want in-band headers


class Muxer:
    """Base: file-object lifecycle. Timestamps are in timebase units."""

    name = "?"
    needs_global_headers = True   # False => Annex-B in-band (raw)

    def __init__(self) -> None:
        self.f: BinaryIO | None = None
        self._owns = False

    def open_file(self, path_or_file) -> None:
        if hasattr(path_or_file, "write"):
            self.f = path_or_file
            self._owns = False
        else:
            self.f = open(path_or_file, "wb")
            self._owns = True

    def set_param(self, params: MuxParams) -> None:
        self.params = params

    def write_headers(self, sps: bytes, pps: bytes, sei: bytes = b"") -> int:
        """sps/pps are raw NAL payloads (no start codes)."""
        raise NotImplementedError

    def write_frame(self, nalus: bytes, pts: int, dts: int,
                    keyframe: bool) -> int:
        """nalus: Annex-B payload of one access unit."""
        raise NotImplementedError

    def close_file(self, largest_pts: int = 0, second_largest_pts: int = 0) -> None:
        if self.f and self._owns:
            self.f.close()
        self.f = None

    # -- helpers --
    def _w(self, data: bytes) -> int:
        self.f.write(data)
        return len(data)


def select_muxer(path: str, explicit: str | None = None) -> Muxer:
    """Extension-driven muxer selection (reference select_output,
    codec.c:1111-1164), the JAX package's: raw Annex-B for .264, .h264,
    .avc and any unknown extension."""
    from .raw import RawMuxer
    from .mkv import MkvMuxer
    from .flv import FlvMuxer
    from .mp4 import Mp4Muxer
    from .avi import AviMuxer
    kinds = {"264": RawMuxer, "h264": RawMuxer, "avc": RawMuxer,
             "mkv": MkvMuxer, "flv": FlvMuxer, "mp4": Mp4Muxer,
             "avi": AviMuxer}
    key = explicit or path.rsplit(".", 1)[-1].lower()
    cls = kinds.get(key, RawMuxer)
    return cls()
