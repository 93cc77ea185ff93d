"""Public session API (PyTorch port) — the x264vfw codec lifecycle.

Port of x264vfw_tpu/api.py :: CompressSession, per-frame and batched paths:
  compress_query/get_size  -> CompressSession.query / worst_case_size
  compress_begin           -> CompressSession.begin
  compress (per frame)     -> CompressSession.compress
  compress_end             -> CompressSession.end
  compress_frames_info     -> CompressSession.frames_info

The session owns config resolution (presets/flags), the encoder, the
muxer, pts/dts bookkeeping and error stickiness.  It runs on the CUDA
device unless built with device="cpu".

The port encodes I16x16 and I_NxN (--partitions i4x4; i8x8 is taken and
ignored, as in the JAX package), P16x16 from up to four references
(--ref, clamped to 4 as in the JAX package) or, with one reference, the
8x8-grid P partitions (--partitions p8x8), found by the hierarchical
search of --me dia/hex/umh or the exhaustive one of --me esa/tesa and
refined to half or quarter pel (--subme), non-reference B frames
(--bframes) with spatial direct and B_Skip and one reference per list,
the loop filter (--deblock), CABAC (a host transcode of the CAVLC
slice), the 8x8 transform, AQ, trellis (--trellis 1 and 2 alike),
weighted P prediction, scene cuts and MB-tree (--mbtree,
--rc-lookahead): x264's --preset ultrafast to slow, with or without
--tune zerolatency, CompressSession() with no options (x264's --preset
medium) among them.  A zero-latency session (no B frames, no MB-tree,
--tune zerolatency) or one with --threads 1 encodes frame by frame; any
other goes through the batched pipeline (encode/pipeline.py, windows of
12 frames), as in the JAX package.  Options outside it (--threads > 1,
--psnr/--ssim) raise NotImplementedError naming the ROADMAP queue; the
session never encodes something other than what was asked.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitstream.nal import iter_annexb_raw, START_CODE_LONG
from .config.params import EncoderParams
from .config.options import parse_cmdline
from .encode.ref_encoder import EncoderConfig
from .encode.ratecontrol import RateController
from .encode.torch_encoder import TorchEncoder
from .output.base import MuxParams, Muxer, select_muxer
from .utils.device import resolve_device
from .utils.logging import Logger

#: input formats compress() takes (colourspace conversion is not ported)
SUPPORTED_INPUT_FORMATS = ("i420",)

# x264-compatible colour signaling name -> H.273 code tables
_COLORPRIM = {"bt709": 1, "undef": 2, "bt470m": 4, "bt470bg": 5,
              "smpte170m": 6, "smpte240m": 7, "film": 8, "bt2020": 9,
              "smpte428": 10, "smpte431": 11, "smpte432": 12}
_TRANSFER = {"bt709": 1, "undef": 2, "bt470m": 4, "bt470bg": 5,
             "smpte170m": 6, "smpte240m": 7, "linear": 8, "log100": 9,
             "log316": 10, "iec61966-2-4": 11, "bt1361e": 12,
             "iec61966-2-1": 13, "bt2020-10": 14, "bt2020-12": 15,
             "smpte2084": 16, "smpte428": 17, "arib-std-b67": 18}
_COLMATRIX = {"GBR": 0, "bt709": 1, "undef": 2, "fcc": 4, "bt470bg": 5,
              "smpte170m": 6, "smpte240m": 7, "YCgCo": 8, "bt2020nc": 9,
              "bt2020c": 10, "smpte2085": 11, "chroma-derived-nc": 12,
              "chroma-derived-c": 13, "ICtCp": 14}


def worst_case_size(width: int, height: int) -> int:
    """Upper bound on one compressed frame (reference codec.c:620)."""
    return ((width + 15) & ~15) * ((height + 31) & ~31) * 3 + 4096


@dataclass
class FramesInfo:
    """compress_frames_info equivalent: encoder delay bookkeeping."""
    delay: int = 0


def _p_partitions(p: EncoderParams) -> bool:
    """P partitions are on unless the list is 'none' (any p8x8 or p4x4
    entry turns on the 8x8-grid split, as in the JAX package)."""
    return "none" not in p.partitions and any(
        k in p.partitions for k in ("p8x8", "p4x4"))


def _out_of_slice(p: EncoderParams) -> list[str]:
    """Requested options this port cannot encode yet."""
    return [name for name, on in (
        ("--threads > 1 (multi-device)", p.threads > 1),
        ("--psnr/--ssim", bool(p.psnr or p.ssim)),
    ) if on]


class CompressSession:
    def __init__(self, params: EncoderParams | None = None,
                 extra_cmdline: str = "", device=None) -> None:
        p = params.copy() if params else EncoderParams()
        self.warnings: list[str] = []
        if extra_cmdline:
            p, warns = parse_cmdline(extra_cmdline, base=p)
            self.warnings += warns
        self.params = p
        self.device = resolve_device(device)
        self.log = Logger(p.log_level)
        for w in self.warnings:
            self.log.warning(w)
        self.encoder: TorchEncoder | None = None
        self._pipe = None          # BatchPipeline when the session batches
        self.mbtree = None         # encode/lookahead.MBTree with --mbtree
        self.muxer: Muxer | None = None
        self.error = False         # sticky b_encoder_error
        self.frame_count = 0
        self._largest = self._second = 0
        self._bits_total = 0

    # ------------------------------------------------------------- query
    def query(self, width: int, height: int, fmt: str = "i420") -> bool:
        if width <= 0 or height <= 0 or width % 2 or height % 2:
            return False
        return fmt.lower() in SUPPORTED_INPUT_FORMATS

    # ------------------------------------------------------------- begin
    def begin(self, width: int, height: int, output=None,
              container: str | None = None) -> None:
        p = self.params
        p.width, p.height = width, height
        p.validate()
        if not self.query(width, height):
            raise ValueError(f"unsupported geometry {width}x{height}")
        missing = _out_of_slice(p)
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)} (ROADMAP.md, queue A)")
        self.rc = RateController(p)
        qp = self.rc.qp_for_frame(True)
        bframes = min(p.bframes, 16)
        if _p_partitions(p) and p.ref > 1:
            self.log.warning(
                "P partitions are searched per 8x8 block with a single "
                f"reference; --ref {p.ref} keeps P16x16 per MB")
        if bframes > 0 and p.ref > 1:
            self.log.info(
                f"--bframes {bframes} with --ref {p.ref}: P anchors use "
                f"{p.ref} references, B frames one per list")
        if p.nal_hrd in ("vbr", "cbr") and not (p.vbv_maxrate > 0
                                                and p.vbv_bufsize > 0):
            self.log.warning("--nal-hrd requires --vbv-maxrate and "
                             "--vbv-bufsize; not signaling HRD")
        self.encoder = TorchEncoder(EncoderConfig(
            width=width, height=height, qp=qp,
            keyint=min(p.keyint, 1 << 16),
            min_keyint=max(1, min(p.min_keyint, p.keyint)),
            scenecut=p.scenecut,
            num_ref_frames=max(1, min(p.ref, 4)),
            chroma_qp_offset=p.chroma_qp_offset,
            search_range=min(p.merange, 16),
            # --subme ladder: 0 = integer-pel, 1-3 = half, 4+ = quarter
            subpel=0 if p.subme == 0 else (1 if p.subme <= 3 else 2),
            bframes=bframes, cabac=p.cabac,
            aq_strength=float(p.aq_strength) if p.aq_mode else 0.0,
            trellis=p.trellis > 0,
            partitions=_p_partitions(p),
            # i4x4 is the intra side of --partitions; i8x8 has no encoder
            i4x4="none" not in p.partitions and "i4x4" in p.partitions,
            dct8x8=bool(p.dct8x8),
            weightp=p.weightp,
            deblock=p.deblock,
            deblock_alpha=p.deblock_alpha, deblock_beta=p.deblock_beta,
            fps_num=p.fps_num, fps_den=p.fps_den,
            nal_hrd=p.nal_hrd if p.nal_hrd in ("vbr", "cbr") else "none",
            vbv_maxrate=p.vbv_maxrate, vbv_bufsize=p.vbv_bufsize,
            sar_width=p.sar_width, sar_height=p.sar_height,
            fullrange=bool(p.fullrange),
            colorprim=_COLORPRIM.get(p.colorprim, 2),
            transfer=_TRANSFER.get(p.transfer, 2),
            colmatrix=_COLMATRIX.get(p.colmatrix, 2),
            # --me dia/hex/umh -> the hierarchical search, esa/tesa ->
            # the exhaustive one
            me_backend="auto" + (":hier" if p.me in ("dia", "hex", "umh")
                                 else ""),
        ), device=self.device)
        self._encode_idx = 0
        self._delay = 1 if bframes else 0
        # MB-tree (--mbtree, --rc-lookahead): holds rc_lookahead display-
        # order frames back and attaches per-MB QP offsets to each
        self.mbtree = None
        if p.mbtree and p.rc_lookahead > 0:
            from .encode.lookahead import MBTree
            self.mbtree = MBTree((width + 15) // 16, (height + 15) // 16,
                                 lookahead=min(p.rc_lookahead, 60),
                                 qcomp=p.qcomp)
        # the batched pipeline unless the session is zero-latency (no B
        # frames, no MB-tree, --tune zerolatency's sync_lookahead 0) or
        # --threads 1, which keep the per-frame path (--threads > 1 and
        # --psnr/--ssim are refused above)
        zero_latency = (p.bframes == 0 and not p.mbtree
                        and p.sync_lookahead == 0)
        if p.threads != 1 and not zero_latency:
            from .encode.pipeline import BatchPipeline
            self._pipe = BatchPipeline(self.encoder, self.rc,
                                       mbtree=self.mbtree, window=12)
        if output is not None:
            self.muxer = select_muxer(
                output if isinstance(output, str) else "", container)
            self.muxer.open_file(output)
            self.muxer.set_param(MuxParams(
                width=width, height=height,
                fps_num=p.fps_num, fps_den=p.fps_den,
                timebase_num=p.fps_den, timebase_den=p.fps_num,
                sar_width=p.sar_width, sar_height=p.sar_height))
            sps = b"\x67" + _ebsp(self.encoder.sps.to_rbsp())
            pps = b"\x68" + _ebsp(self.encoder.pps.to_rbsp())
            self.muxer.write_headers(sps, pps)
        self.frame_count = 0

    # ---------------------------------------------------------- compress
    def compress(self, frame, fmt: str = "i420") -> bytes:
        """frame: (y, u, v) uint8 planes.  Returns the Annex-B access units
        emitted for this input, in decode order: on the per-frame path one
        per frame, or with B frames b"" while a frame waits for its anchor
        (and while MB-tree fills its lookahead); on the batched path b""
        until the second window fills, then a whole window's
        (frames_info().delay)."""
        if self.error:
            raise RuntimeError("encoder in error state")
        if self.encoder is None:
            raise RuntimeError("begin() not called")
        if fmt.lower() != "i420":
            raise NotImplementedError(
                f"input format {fmt} needs colourspace conversion, which "
                "is not ported yet (ROADMAP.md, queue A)")
        if self._pipe is not None:
            try:
                outs = self._pipe.push(*frame)
            except Exception:
                self.error = True
                raise
            self.frame_count += 1
            return self._emit(outs)
        qps = {t: self.rc.qp_for_type(t) for t in "IPB"}
        try:
            y, u, v = frame
            if self.mbtree is not None:
                outs = []
                for (fy, fu, fv), off in self.mbtree.push((y, u, v), y):
                    outs += self.encoder.push_frame(
                        fy, fu, fv, qp_i=qps["I"], qp_p=qps["P"],
                        qp_b=qps["B"], qp_off=off)
            else:
                outs = self.encoder.push_frame(y, u, v, qp_i=qps["I"],
                                               qp_p=qps["P"], qp_b=qps["B"])
        except Exception:
            self.error = True
            raise
        self.frame_count += 1
        return self._emit(self._typed(outs, qps), rc_done=False)

    @staticmethod
    def _typed(outs, qps: dict) -> list:
        """(au, pts, ftype) from the per-frame encoder -> (au, pts, is_idr,
        ftype, the QP it was given)."""
        return [(au, pts, t == "I", t, qps[t]) for au, pts, t in outs]

    def _emit(self, outs, rc_done: bool = True) -> bytes:
        """outs: (au, pts, is_idr, ftype, qp) in decode order.  rc_done:
        the batched pipeline has fed rate control already; else each AU's
        size goes to it here, with the QP the encoder was given."""
        result = b""
        for au, pts, key, ftype, qp in outs:
            if self.params.aud:
                # access-unit delimiter, first NAL of the AU (§7.4.2.4);
                # primary_pic_type 0 = I, 1 = I/P, 2 = I/P/B
                ppt = {"I": 0, "P": 1, "B": 2}[ftype]
                au = (START_CODE_LONG + bytes([0x09, (ppt << 5) | 0x10])
                      + au)
            if not rc_done:
                self.rc.update(ftype, qp, len(au) * 8)
            if pts > self._largest:
                self._second = self._largest
                self._largest = pts
            elif pts > self._second:
                self._second = pts
            self._bits_total += len(au) * 8
            if self.muxer is not None:
                payload, k = _strip_parameter_sets(au)
                # B frames come out after their anchor: dts lags by one
                dts = max(0, self._encode_idx - self._delay)
                self.muxer.write_frame(payload, pts=pts, dts=dts, keyframe=k)
            self._encode_idx += 1
            result += au
        return result

    # --------------------------------------------------------------- end
    def end(self) -> dict:
        """Flush the batched pipeline's delayed frames and close; returns
        summary stats, the flushed AUs under 'tail'."""
        tail = b""
        if self._pipe is not None and not self.error:
            tail = self._emit(self._pipe.flush())
        elif self.encoder is not None and not self.error:
            if self.mbtree is not None:
                for (fy, fu, fv), off in self.mbtree.flush():
                    qps = {t: self.rc.qp_for_type(t) for t in "IPB"}
                    tail += self._emit(self._typed(self.encoder.push_frame(
                        fy, fu, fv, qp_i=qps["I"], qp_p=qps["P"],
                        qp_b=qps["B"], qp_off=off), qps), rc_done=False)
            qp_p = self.rc.qp_for_type("P")
            qp_b = self.rc.qp_for_type("B")
            tail += self._emit(self._typed(
                self.encoder.flush(qp_p=qp_p, qp_b=qp_b),
                {"I": qp_p, "P": qp_p, "B": qp_b}), rc_done=False)
        if self.muxer is not None:
            self.muxer.close_file(self._largest, self._second)
            self.muxer = None
        if getattr(self, "rc", None) is not None:
            self.rc.write_stats()
        p = self.params
        dur = self.frame_count * p.fps_den / max(1, p.fps_num)
        stats = {
            "frames": self.frame_count,
            "kbps": self._bits_total / 1000.0 / dur if dur else 0.0,
            "tail": tail,
        }
        if self.frame_count:
            self.log.info(f"encoded {self.frame_count} frames, "
                          f"{stats['kbps']:.2f} kb/s")
        return stats

    def frames_info(self) -> FramesInfo:
        """The most frames an input can wait before its AU comes out: the
        B frames, MB-tree's lookahead and, batched, the double-buffered
        windows (one full window in the queue plus one in flight)."""
        p = self.params
        look = (min(p.rc_lookahead, 60)
                if p.mbtree and p.rc_lookahead > 0 else 0)
        win = 0 if self._pipe is None else 2 * self._pipe.window - 1
        return FramesInfo(delay=min(p.bframes, 16) + look + win)


def _strip_parameter_sets(au: bytes) -> tuple[bytes, bool]:
    out = b""
    key = False
    for nal in iter_annexb_raw(au):
        t = nal[0] & 0x1F
        if t in (7, 8):
            continue
        if t == 5:
            key = True
        out += START_CODE_LONG + nal
    return out, key


def _ebsp(rbsp) -> bytes:
    from .utils.bitstream import escape_ebsp
    return escape_ebsp(rbsp)
