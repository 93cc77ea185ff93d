"""Public session API (PyTorch port) — the x264vfw codec lifecycle.

Port of x264vfw_tpu/api.py :: CompressSession, per-frame and batched paths:
  compress_query/get_size  -> CompressSession.query / worst_case_size
  compress_begin           -> CompressSession.begin
  compress (per frame)     -> CompressSession.compress
  compress_end             -> CompressSession.end
  compress_frames_info     -> CompressSession.frames_info
  decompress_begin         -> DecompressSession.begin
  decompress               -> DecompressSession.decompress
  decompress_end           -> DecompressSession.end

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
medium) among them.  compress() takes every input format of
SUPPORTED_INPUT_FORMATS: anything but I420 is converted on the session's
device (ops/csp.py).  The muxer follows the output's extension: raw
Annex-B, Matroska, MP4, FLV or AVI (output/).

A session routes as the JAX package does: with --threads N > 1 over
more than one device (devices=, by default every visible CUDA device of
a CUDA session and the session's own device on the CPU) and not
measuring, it encodes closed GOPs of min(keyint, 32) frames spread over
the devices (parallel/gop.py), after a loud downgrade to bframes 0,
ref 1, weightp 0, no MB-tree and no scene cuts; otherwise a zero-latency
session (no B frames, no MB-tree, --tune zerolatency), one with
--threads 1 or one that measures (--psnr/--ssim at log level 2 or more)
encodes frame by frame, and any other, --threads N > 1 on one device
among them, goes through the batched pipeline (encode/pipeline.py,
windows of 12 frames).  Measuring, the session keeps each source frame
until its AU comes out, then logs its PSNR/SSIM against the encoder's
reconstruction and sums them for end().
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bitstream.nal import iter_annexb_raw, START_CODE_LONG
from .config.params import EncoderParams
from .config.options import parse_cmdline
from .decode.decoder import H264Decoder
from .encode.ref_encoder import EncoderConfig
from .encode.ratecontrol import RateController
from .encode.torch_encoder import TorchEncoder
from .output.base import MuxParams, Muxer, select_muxer
from .utils.device import resolve_device, resolve_devices
from .utils.logging import Logger

#: input formats compress() takes
SUPPORTED_INPUT_FORMATS = ("i420", "yv12", "nv12", "nv21", "yuyv", "uyvy",
                           "rgb24", "bgr24", "bgra", "rgba")

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


class CompressSession:
    def __init__(self, params: EncoderParams | None = None,
                 extra_cmdline: str = "", device=None,
                 devices=None) -> None:
        """device: the session's device (CUDA unless named).  devices: the
        GOP-parallel route's device list for --threads N > 1, by default
        every visible CUDA device of a CUDA session, [device] on the
        CPU; the route is taken only when it holds more than one entry
        (the same device may repeat)."""
        p = params.copy() if params else EncoderParams()
        self.warnings: list[str] = []
        if extra_cmdline:
            p, warns = parse_cmdline(extra_cmdline, base=p)
            self.warnings += warns
        self.params = p
        self.device = resolve_device(device)
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        self.devices = resolve_devices(devices)
        self.log = Logger(p.log_level)
        for w in self.warnings:
            self.log.warning(w)
        self.encoder: TorchEncoder | None = None
        self._pipe = None          # BatchPipeline when the session batches
        self._shard = False        # GopShardPipeline in _pipe: GOPs over
        #                            several devices
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
        self.rc = RateController(p)
        qp = self.rc.qp_for_frame(True)
        bframes = min(p.bframes, 16)
        # PSNR/SSIM telemetry: as in the reference, measured only with the
        # flags AND log level >= info (codec.c:1558-1559); it pulls each
        # frame's recon to the host, so the session runs per frame
        self._measure = bool((p.psnr or p.ssim) and p.log_level >= 2)
        # --threads N > 1 over several devices: GOP data parallelism (the
        # reference's frame-threading knob, codec.c:933-943), whose
        # feature set is bframes 0, ref 1, weightp 0, no lookahead; more
        # is downgraded with a warning, not silently
        self._shard = (p.threads > 1 and len(self.devices) > 1
                       and not self._measure)
        if self._shard:
            for name, on in (("bframes", bframes > 0), ("ref", p.ref > 1),
                             ("weightp", p.weightp > 0),
                             ("mbtree", bool(p.mbtree)),
                             ("scenecut", p.scenecut > 0)):
                if on:
                    self.log.warning(
                        f"--threads {p.threads} (sharded GOP mode) does "
                        f"not support {name}; disabling it")
            bframes = 0
            p = p.copy()
            p.ref = 1
            p.weightp = 0
            p.mbtree = False
            p.scenecut = 0
            self.params = p
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
        self.encoder.measure = self._measure
        self._src_q: dict[int, tuple] = {}
        self._disp_idx = 0
        self._mse_sum = {"y": 0.0, "u": 0.0, "v": 0.0}
        self._psnr_sum = {"y": 0.0, "u": 0.0, "v": 0.0, "global": 0.0}
        self._ssim_sum = 0.0
        self._measured = 0
        # MB-tree (--mbtree, --rc-lookahead): holds rc_lookahead display-
        # order frames back and attaches per-MB QP offsets to each
        self.mbtree = None
        if p.mbtree and p.rc_lookahead > 0:
            from .encode.lookahead import MBTree
            self.mbtree = MBTree((width + 15) // 16, (height + 15) // 16,
                                 lookahead=min(p.rc_lookahead, 60),
                                 qcomp=p.qcomp)
        # the GOP-parallel pipeline when sharding; else the batched one
        # unless the session is zero-latency (no B frames, no MB-tree,
        # --tune zerolatency's sync_lookahead 0), --threads 1 or
        # measuring, which keep the per-frame path
        zero_latency = (p.bframes == 0 and not p.mbtree
                        and p.sync_lookahead == 0)
        if self._shard:
            from .parallel.gop import GopShardPipeline
            self._pipe = GopShardPipeline(self.encoder, self.rc,
                                          devices=self.devices,
                                          gop_len=min(p.keyint, 32))
        elif not self._measure and p.threads != 1 and not zero_latency:
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
        """frame: (y, u, v) uint8 planes for I420 and YV12 (y, v, u), (y,
        uv) for NV12/NV21, a packed (H, 2W) array for YUYV/UYVY, an (H, W,
        C) array for the RGB formats.  Returns the Annex-B access units
        emitted for this input, in decode order: on the per-frame path one
        per frame, or with B frames b"" while a frame waits for its anchor
        (and while MB-tree fills its lookahead); on the batched path b""
        until the second window fills, then a whole window's
        (frames_info().delay)."""
        if self.error:
            raise RuntimeError("encoder in error state")
        if self.encoder is None:
            raise RuntimeError("begin() not called")
        if self._pipe is not None:
            try:
                outs = self._pipe.push(*_to_i420(frame, fmt, self.device))
            except Exception:
                self.error = True
                raise
            self.frame_count += 1
            return self._emit(outs)
        qps = {t: self.rc.qp_for_type(t) for t in "IPB"}
        try:
            y, u, v = _to_i420(frame, fmt, self.device)
            if self._measure:
                self._src_q[self._disp_idx] = (y, u, v)
            self._disp_idx += 1
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
            if self._measure:
                self._frame_metrics(pts, ftype, qp, len(au) * 8)
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

    def _frame_metrics(self, pts: int, ftype: str, qp: int,
                       bits: int) -> None:
        """Per-frame PSNR/SSIM telemetry (the reference's b_psnr/b_ssim
        measurement plus x264's per-frame log line, codec.c:1555-1559),
        float64 numpy on the host."""
        src = self._src_q.pop(pts, None)
        rec = self.encoder.pop_recon(pts)
        if src is None or rec is None:
            return
        from .utils.metrics import frame_psnr_yuv, ssim
        p = self.params
        line = f"frame={pts:4d} type={ftype} qp={qp} bits={bits}"
        if p.psnr:
            ps = frame_psnr_yuv(src, rec)
            for name, s, r in zip("yuv", src, rec):
                s64 = np.asarray(s, np.float64)
                self._mse_sum[name] += ((s64 - np.asarray(r, np.float64))
                                        ** 2).mean()
            for k in ("y", "u", "v", "global"):
                self._psnr_sum[k] += ps[k]
            line += (f" psnr_y={ps['y']:.2f} psnr_u={ps['u']:.2f}"
                     f" psnr_v={ps['v']:.2f}")
        if p.ssim:
            sv = ssim(src[0], rec[0])
            self._ssim_sum += sv
            line += f" ssim_y={sv:.5f}"
        self._measured += 1
        self.log.info(line)

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
        if getattr(self, "_measured", 0):
            m = self._measured
            if p.psnr:
                # Mean = average of per-frame PSNR; Global = PSNR of the
                # average MSE (x264's end-of-encode PSNR report shape)
                mean = {k: self._psnr_sum[k] / m
                        for k in ("y", "u", "v", "global")}
                gm = (4 * self._mse_sum["y"] + self._mse_sum["u"]
                      + self._mse_sum["v"]) / (6 * m)
                glob = 99.0 if gm == 0 else float(10 * np.log10(255 ** 2 / gm))
                stats["psnr"] = {**mean, "global_all": glob}
                self.log.info(
                    f"PSNR Mean Y:{mean['y']:.3f} U:{mean['u']:.3f} "
                    f"V:{mean['v']:.3f} Avg:{mean['global']:.3f} "
                    f"Global:{glob:.3f}")
            if p.ssim:
                stats["ssim"] = self._ssim_sum / m
                self.log.info(f"SSIM Mean Y:{stats['ssim']:.7f}")
        if self.frame_count:
            self.log.info(f"encoded {self.frame_count} frames, "
                          f"{stats['kbps']:.2f} kb/s")
        return stats

    def frames_info(self) -> FramesInfo:
        """The most frames an input can wait before its AU comes out: the
        B frames, MB-tree's lookahead and, batched, the double-buffered
        windows (one full window in the queue plus one in flight); in
        the GOP-parallel route one GOP per device less one frame (the
        JAX package raises AttributeError there)."""
        if self._shard:
            return FramesInfo(delay=self._pipe.delay)
        p = self.params
        look = (min(p.rc_lookahead, 60)
                if p.mbtree and p.rc_lookahead > 0 else 0)
        win = 0 if self._pipe is None else 2 * self._pipe.window - 1
        return FramesInfo(delay=min(p.bframes, 16) + look + win)



class DecompressSession:
    """decompress_* lifecycle: the decoder and the output conversion.

    Port of x264vfw_tpu/api.py :: DecompressSession.  The decoder is
    decode/decoder.H264Decoder: with use_device=True (the default) its
    device route reconstructs the CAVLC I and P slices it takes on the
    session's device, and every other slice (CABAC, B, ...) takes the
    host route, as in the JAX package.  Missing or delayed output is
    masked with a black frame like the reference (codec.c:2250-2256).
    The output conversion (the reference's swscale stage, codec.c:
    2075-2152: ops/csp.py and ops/scale.py) runs on the session's device
    and returns numpy uint8 arrays; avcC and length-prefixed input
    framing (codec.c:2032-2044, 2190-2221) live at this layer.  The
    session runs on the CUDA device unless built with device="cpu"."""

    #: output formats decompress() can emit (the reference's
    #: choose_output_csp surface, codec.c:269-302)
    OUTPUT_FORMATS = ("i420", "yv12", "nv12", "nv21", "rgb24", "bgr24")

    def __init__(self, use_device: bool = True, device=None) -> None:
        self._use_device = use_device
        self.device = resolve_device(device)
        self.decoder = H264Decoder(use_device=use_device, device=self.device)
        self._consumed = 0
        self._reorder: list = []

    def begin(self, width: int = 0, height: int = 0, fmt: str = "i420",
              extradata: bytes | None = None,
              out_width: int = 0, out_height: int = 0) -> None:
        """fmt: output pixel format (OUTPUT_FORMATS).  extradata: avcC
        record; switches AU input framing to length-prefixed (MP4/MKV
        sample data) and primes the decoder with its SPS/PPS.  out_width/
        out_height: optional output scaling (ops/scale.py), default the
        coded size."""
        fmt = fmt.lower()
        if fmt not in self.OUTPUT_FORMATS:
            raise ValueError(f"unsupported output format {fmt!r}")
        self.decoder = H264Decoder(use_device=self._use_device,
                                   device=self.device)
        self._consumed = 0
        self._reorder = []
        self._wh = (width, height)
        self._fmt = fmt
        self._out_wh = (out_width, out_height)
        self._nls = 0
        if extradata:
            from .bitstream.avcc import parse_avcc
            sps_l, pps_l, self._nls = parse_avcc(extradata)
            prime = b"".join(START_CODE_LONG + n for n in sps_l + pps_l)
            self.decoder.decode(prime)

    def _pop_display(self):
        """Emit the earliest frame in display order (IDR epoch, POC)."""
        i = min(range(len(self._reorder)),
                key=lambda k: (getattr(self._reorder[k], "idr_epoch", 0),
                               self._reorder[k].poc))
        f = self._reorder.pop(i)
        return self._convert(np.asarray(f.y, np.uint8),
                             np.asarray(f.u, np.uint8),
                             np.asarray(f.v, np.uint8))

    def _vui_matrix(self, w: int) -> tuple:
        """(matrix, fullrange) from the stream's VUI like the reference's
        sws setup (codec.c:2113-2140); untagged streams guess by size."""
        sps = next(iter(self.decoder.sps.values()), None)
        mc = getattr(sps, "matrix_coefficients", 2) if sps else 2
        fr = bool(getattr(sps, "video_full_range_flag", 0)) if sps else False
        matrix = {1: "bt709", 4: "bt601", 5: "bt601", 6: "bt601",
                  9: "bt2020", 10: "bt2020"}.get(mc)
        if matrix is None:
            matrix = "bt709" if w >= 1280 else "bt601"
        return matrix, fr

    def _convert(self, y, u, v):
        """I420 uint8 planes -> the session's output format and size, as
        numpy uint8 arrays: I420 and YV12 at the coded size are the
        planes themselves; scaling, NV12/NV21 and RGB run on the session's
        device."""
        ow, oh = self._out_wh
        scale = ow and oh and (ow, oh) != (y.shape[1], y.shape[0])
        fmt = getattr(self, "_fmt", "i420")
        if not scale and fmt in ("i420", "yv12"):
            return (y, u, v) if fmt == "i420" else (y, v, u)
        from .ops import csp
        y, u, v = (torch.as_tensor(p, device=self.device) for p in (y, u, v))
        if scale:
            from .ops.scale import scale_i420
            y, u, v = scale_i420(y, u, v, ow, oh)
        if fmt in ("rgb24", "bgr24"):
            matrix, fr = self._vui_matrix(y.shape[1])
            rgb = csp.i420_to_rgb(y, u, v, matrix=matrix, fullrange=fr)
            if fmt == "bgr24":
                rgb = rgb.flip(-1)
            out = (rgb,)
        elif fmt in ("nv12", "nv21"):
            out = csp.i420_to_nv12(y, u if fmt == "nv12" else v,
                                   v if fmt == "nv12" else u)
        else:
            out = (y, u, v) if fmt == "i420" else (y, v, u)
        out = tuple(p.to(torch.uint8).cpu().numpy() for p in out)
        return out[0] if len(out) == 1 else out

    def _to_annexb(self, au: bytes) -> bytes:
        """Length-prefixed AU -> Annex-B (the reference rewrites in place,
        codec.c:2190-2221).  Annex-B input passes through untouched.

        An AU whose NAL lengths tile it exactly is length-prefixed, even
        when it starts like a start code: a first NAL of 256 to 511 bytes
        has a 4-byte length 00 00 01 xx.  The JAX package sniffs the start
        code first and passes such a sample on as Annex-B, which does not
        parse (ROADMAP C)."""
        if not self._nls:
            return au
        out = bytearray()
        pos = 0
        n = self._nls
        while pos + n <= len(au):
            ln = int.from_bytes(au[pos:pos + n], "big")
            pos += n
            if ln == 0 or pos + ln > len(au):
                break
            out += START_CODE_LONG + au[pos:pos + ln]
            pos += ln
        if pos != len(au) and (au[:3] == b"\x00\x00\x01"
                               or au[:4] == b"\x00\x00\x00\x01"):
            return au
        return bytes(out)

    def decompress(self, au: bytes):
        """Feed one access unit; returns the frame in DISPLAY order in the
        session's output format ((y, u, v) planes, (y, uv) for NV12/NV21,
        or an (H, W, 3) array for RGB), or a black frame if nothing is
        ready yet (delayed-frame masking like the reference,
        codec.c:2250-2256).  Feed b"" to drain at end of stream."""
        if au:
            frames = self.decoder.decode(self._to_annexb(au))
            self._reorder += frames[self._consumed:]
            self._consumed = len(frames)
        # reordering window: streams without B emit immediately; POC-type-0
        # streams hold 1 frame (non-ref B delay)
        delay = 0
        if self._reorder:
            sps = next(iter(self.decoder.sps.values()), None)
            if au and sps is not None and sps.pic_order_cnt_type == 0:
                delay = 1
        if len(self._reorder) > delay:
            return self._pop_display()
        w, h = self._wh
        if not w:
            return None
        return self._convert(
            np.full((h, w), 16, np.uint8),
            np.full((h // 2, w // 2), 128, np.uint8),
            np.full((h // 2, w // 2), 128, np.uint8))

    def end(self) -> None:
        self._reorder = []

def _to_i420(frame, fmt: str, device):
    """An input frame as (y, u, v) uint8 host planes: I420 as it comes,
    any other format converted on the session's device (ops/csp.py)."""
    fmt = fmt.lower()
    if fmt == "i420":
        return frame
    from .ops import csp
    return tuple(p.to(torch.uint8).cpu().numpy()
                 for p in csp.convert_to_i420(fmt, frame, device=device))


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
