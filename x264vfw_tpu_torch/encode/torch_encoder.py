"""Encoder session object: device pipeline + host NAL wrapping (PyTorch).

Port of the per-frame device CAVLC path of
x264vfw_tpu/encode/tpu_encoder.py :: TpuEncoder for I and P frames:
push_frame -> encode_frame -> one uint8 upload, the fused I or P phase 1
(encode/device_finalize.py, with the in-loop deblock when the config
asks for it), a pack sized from the slot lengths, one pull of the payload
bytes, and the NAL wrap on the host.  Reference frames (deblocked when
the slice filters) stay on the device between frames.  The batched
session (encode/pipeline.py) drives the same object: it reads and writes
display_idx, _last_idr_d, poc_base, poc, frame_num and frame_idx, writes
slice headers with _slice_header_codes and uploads a run of frames with
pack_batch_rows.

Header conventions (SPS profile/level/DPB size, PPS, slice headers,
version SEI) are the JAX package's, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.mb_syntax import SLICE_I, SLICE_P
from ..bitstream.nal import NAL_PPS, NAL_SLICE, NAL_SLICE_IDR, NAL_SPS, wrap_nal
from ..bitstream.params import PPS, SPS, PROFILE_BASELINE
from ..bitstream.slice import SliceHeader
from ..ops import tables
from ..utils.bitstream import BitWriter
from ..utils.device import resolve_device
from . import device_finalize
from .ref_encoder import EncoderConfig


def _unsupported(cfg: EncoderConfig) -> list[str]:
    """Options of cfg that this port does not carry yet."""
    out = []
    for name, on in (("bframes", cfg.bframes > 0), ("cabac", cfg.cabac),
                     ("i4x4", cfg.i4x4), ("dct8x8", cfg.dct8x8),
                     ("ref > 1", cfg.num_ref_frames > 1),
                     ("aq", cfg.aq_strength > 0), ("trellis", cfg.trellis),
                     ("weightp", cfg.weightp > 0),
                     ("scenecut", cfg.scenecut > 0)):
        if on:
            out.append(name)
    return out


class TorchEncoder:
    def __init__(self, cfg: EncoderConfig, device=None) -> None:
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)} (ROADMAP.md, queue A)")
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError(f"odd geometry {cfg.width}x{cfg.height}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mbw = (cfg.width + 15) // 16
        self.mbh = (cfg.height + 15) // 16
        # CAVLC, no B frames: Constrained Baseline, POC type 2
        self.sps = SPS(
            profile_idc=PROFILE_BASELINE,
            constraint_set0=1,
            constraint_set1=1,
            level_idc=_level_for(cfg.width, cfg.height, cfg.fps_num,
                                 cfg.fps_den),
            log2_max_frame_num_minus4=4,
            pic_order_cnt_type=2,
            log2_max_pic_order_cnt_lsb_minus4=4,
            # kept exactly as the JAX package writes it (tpu_encoder.py:62),
            # without clamping to the level's DPB: byte parity comes first
            max_num_ref_frames=max(1, min(cfg.num_ref_frames, 4)),
            pic_width_in_mbs_minus1=self.mbw - 1,
            pic_height_in_map_units_minus1=self.mbh - 1,
        )
        if cfg.width % 16 or cfg.height % 16:
            self.sps.frame_cropping_flag = 1
            self.sps.frame_crop_right_offset = (self.mbw * 16 - cfg.width) // 2
            self.sps.frame_crop_bottom_offset = (self.mbh * 16 - cfg.height) // 2
        _apply_vui(self.sps, cfg)
        self.pps = PPS(entropy_coding_mode_flag=0,
                       pic_init_qp_minus26=cfg.qp - 26,
                       weighted_pred_flag=0,
                       num_ref_idx_l0_default_active_minus1=0,
                       chroma_qp_index_offset=min(max(cfg.chroma_qp_offset,
                                                      -12), 12),
                       deblocking_filter_control_present_flag=1,
                       transform_8x8_mode_flag=0)
        self.frame_idx = 0
        self.frame_num = 0
        self.idr_id = 0
        self.poc = 0                  # pic_order_cnt_lsb of current frame
        self.display_idx = 0
        self.poc_base = 0             # display index of the last IDR
        self._last_idr_d: int | None = None
        self.ref: tuple | None = None  # device (y, u, v) int32 recon
        self.last_mv = None            # device (n, 2) mv field of last P
        self.last_mv8 = None           # its 8x8-grid field, with partitions
        self.qp = cfg.qp
        self.qpc = int(tables.chroma_qp(cfg.qp, self.pps.chroma_qp_index_offset))
        self._i_full = None            # I-frame phase 1 for this geometry

    # ------------------------------------------------------------------
    @property
    def last_recon(self) -> tuple:
        """Reconstruction of the last encoded frame (host copy, cropped to
        the configured geometry)."""
        w, h = self.cfg.width, self.cfg.height
        y, u, v = (p.cpu().numpy() for p in self.ref)
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]

    def load_state(self, state) -> None:
        """Resume from a convert.EncoderState, e.g. a JAX encoder's DPB
        and counters.  Without B frames the display index is frame_idx."""
        H, W = self.mbh * 16, self.mbw * 16
        if tuple(state.ref[0].shape) != (H, W):
            raise ValueError(f"reference is {tuple(state.ref[0].shape)}, "
                             f"the encoder codes {(H, W)}")
        self.ref = tuple(p.to(self.device, torch.int32) for p in state.ref)
        self.frame_idx = self.display_idx = state.frame_idx
        self.frame_num = state.frame_num
        self.idr_id = state.idr_id
        self.poc = state.poc
        self.poc_base = state.poc_base
        self._last_idr_d = state.last_idr

    def headers(self) -> bytes:
        from ..bitstream.sei import version_sei, buffering_period_sei
        opts = (f"qp={self.cfg.qp} keyint={self.cfg.keyint} "
                f"merange={self.cfg.search_range} cavlc=1")
        bs = (wrap_nal(3, NAL_SPS, self.sps.to_rbsp())
              + wrap_nal(3, NAL_PPS, self.pps.to_rbsp()))
        if self.sps.nal_hrd_present:
            # buffering period must be the first SEI of the AU (§D.1)
            bs += buffering_period_sei(self.sps)
        return bs + version_sei(opts)

    # ------------------------------------------------------------------
    def push_frame(self, y, u, v, qp_i: int | None = None,
                   qp_p: int | None = None) -> list[tuple[bytes, int, bool]]:
        """Submit one display-order frame.  Returns the encoded AUs as
        (annexb_bytes, display_index, is_keyframe) in decode order (one
        per frame: this slice has no B frames)."""
        cfg = self.cfg
        d = self.display_idx
        self.display_idx += 1
        since = d - self._last_idr_d if self._last_idr_d is not None else None
        is_idr = since is None or since >= cfg.keyint
        if is_idr:
            self._last_idr_d = d
        au = self.encode_frame(y, u, v, qp=qp_i if is_idr else qp_p,
                               force_idr=is_idr)
        return [(au, d, is_idr)]

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     qp: int | None = None,
                     force_idr: bool | None = None) -> bytes:
        cfg = self.cfg
        H, W = self.mbh * 16, self.mbw * 16
        is_idr = (self.frame_idx % cfg.keyint) == 0 or self.ref is None
        if force_idr is not None:
            is_idr = force_idr or self.ref is None
        if qp is not None:
            self.qp = int(min(max(qp, 0), 51))
            self.qpc = int(tables.chroma_qp(self.qp,
                                            self.pps.chroma_qp_index_offset))
        # one uint8 upload, one fused device phase, one pull
        src_d = torch.from_numpy(self.pack_batch_rows([(y, u, v)])[0]) \
            .to(self.device)
        if is_idr:
            self.frame_num = 0
            nal_type = NAL_SLICE_IDR
            hv, hl = self._header_slots(SLICE_I, nal_type)
            if self._i_full is None:
                self._i_full = device_finalize.encode_i_slots_fn(
                    H, W, cfg.deblock, cfg.deblock_alpha, cfg.deblock_beta,
                    qpc_offset=self.pps.chroma_qp_index_offset)
            sv_, sl_, ry, ru, rv = self._i_full(src_d, self.qp, self.qpc,
                                                hv, hl)
        else:
            nal_type = NAL_SLICE
            hv, hl = self._header_slots(SLICE_P, nal_type)
            sv_, sl_, ry, ru, rv, out = device_finalize.encode_p_slots(
                src_d, *self.ref, self.qp, self.qpc, hv, hl,
                cfg.search_range, cfg.subpel, cfg.me_backend,
                cfg.deblock, cfg.deblock_alpha, cfg.deblock_beta,
                qpc_offset=self.pps.chroma_qp_index_offset,
                partitions=cfg.partitions)
            self.last_mv = out["mv"]
            self.last_mv8 = out.get("mv8")
        data, nbits = device_finalize.pack_phase(sv_, sl_)
        payload = data[:(nbits + 7) // 8].cpu().numpy()
        self.ref = (ry, ru, rv)
        bs = b""
        if is_idr:
            bs += self.headers()
        bs += wrap_nal(3, nal_type, payload)
        self.frame_idx += 1
        self.frame_num = (self.frame_num + 1) % (
            1 << (self.sps.log2_max_frame_num_minus4 + 4))
        if is_idr:
            self.idr_id = (self.idr_id + 1) % 65536
        return bs

    def pack_batch_rows(self, batch: list) -> np.ndarray:
        """(y, u, v) frames -> the (G, H*W*3/2) uint8 rows the device
        phases ingest (each plane edge-padded to the MB-multiple size)."""
        H, W = self.mbh * 16, self.mbw * 16
        return np.stack([np.concatenate([
            np.ascontiguousarray(_pad(y, H, W), dtype=np.uint8).ravel(),
            np.ascontiguousarray(_pad(u, H // 2, W // 2),
                                 dtype=np.uint8).ravel(),
            np.ascontiguousarray(_pad(v, H // 2, W // 2),
                                 dtype=np.uint8).ravel()])
            for (y, u, v) in batch])

    # ------------------------------------------------------------------
    def _header_slots(self, slice_type: int, nal_type: int):
        """Slice-header codes as fixed-size device slot arrays."""
        hw = self._slice_header_codes(slice_type, nal_type)
        hv, hl = hw.to_slots(pad_to=device_finalize.MAX_HDR)
        return (torch.as_tensor(hv.astype(np.int64), device=self.device),
                torch.as_tensor(hl.astype(np.int32), device=self.device))

    def _slice_header_codes(self, slice_type: int, nal_type: int,
                            nal_ref_idc: int = 3) -> BitWriter:
        w = BitWriter()
        h = SliceHeader(slice_type=slice_type + 5,
                        frame_num=self.frame_num,
                        idr_pic_id=self.idr_id,
                        pic_order_cnt_lsb=self.poc & (
                            (1 << (self.sps.log2_max_pic_order_cnt_lsb_minus4
                                   + 4)) - 1),
                        slice_qp_delta=self.qp - (26 + self.pps.pic_init_qp_minus26),
                        disable_deblocking_filter_idc=0 if self.cfg.deblock
                        else 1,
                        slice_alpha_c0_offset_div2=self.cfg.deblock_alpha,
                        slice_beta_offset_div2=self.cfg.deblock_beta)
        h.write(w, self.sps, self.pps, nal_type, nal_ref_idc)
        return w


def _pad(a: np.ndarray, H: int, W: int) -> np.ndarray:
    a = np.asarray(a)
    if a.shape == (H, W):
        return a
    return np.pad(a, ((0, H - a.shape[0]), (0, W - a.shape[1])), mode="edge")


def _apply_vui(sps: SPS, cfg: EncoderConfig) -> None:
    """Wire encoder config into SPS VUI: SAR, video signal type + colour
    description, timing info (reference codec.c:973-979; fullrange/
    colmatrix fixup codec.c:1566-1577).  Timing uses the H.264 field-rate
    convention time_scale = 2*fps."""
    want_signal = (cfg.fullrange or cfg.colorprim != 2 or cfg.transfer != 2
                   or cfg.colmatrix != 2)
    want_sar = cfg.sar_width > 0 and cfg.sar_height > 0
    want_hrd = (cfg.nal_hrd in ("vbr", "cbr") and cfg.vbv_maxrate > 0
                and cfg.vbv_bufsize > 0)
    if not (want_signal or want_sar or cfg.vui_timing or want_hrd):
        return
    sps.vui_parameters_present_flag = 1
    if want_hrd:
        sps.nal_hrd_present = 1
        sps.hrd_bitrate = cfg.vbv_maxrate * 1000
        sps.hrd_cpb_size = cfg.vbv_bufsize * 1000
        sps.hrd_cbr = int(cfg.nal_hrd == "cbr")
    if want_sar:
        sps.sar_width, sps.sar_height = cfg.sar_width, cfg.sar_height
    if want_signal:
        sps.video_signal_type_present_flag = 1
        sps.video_format = 5
        sps.video_full_range_flag = int(cfg.fullrange)
        if cfg.colorprim != 2 or cfg.transfer != 2 or cfg.colmatrix != 2:
            sps.colour_description_present_flag = 1
            sps.colour_primaries = cfg.colorprim
            sps.transfer_characteristics = cfg.transfer
            sps.matrix_coefficients = cfg.colmatrix
    if cfg.vui_timing and cfg.fps_num > 0:
        sps.timing_info_present_flag = 1
        sps.num_units_in_tick = cfg.fps_den
        sps.time_scale = 2 * cfg.fps_num
        sps.fixed_frame_rate_flag = 1


def _level_for(w: int, h: int, fps_num: int, fps_den: int) -> int:
    """Minimal level_idc by MB count / MB rate (Table A-1 essentials)."""
    mbs = ((w + 15) // 16) * ((h + 15) // 16)
    mbps = mbs * fps_num / max(1, fps_den)
    for level, max_fs, max_mbps in (
            (10, 99, 1485), (11, 396, 3000), (12, 396, 6000), (13, 396, 11880),
            (20, 396, 11880), (21, 792, 19800), (22, 1620, 20250),
            (30, 1620, 40500), (31, 3600, 108000), (32, 5120, 216000),
            (40, 8192, 245760), (41, 8192, 245760), (42, 8704, 522240),
            (50, 22080, 589824), (51, 36864, 983040), (52, 36864, 2073600)):
        if mbs <= max_fs and mbps <= max_mbps:
            return level
    return 52
