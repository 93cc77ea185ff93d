"""Encoder session object: device pipeline + host NAL wrapping (PyTorch).

Port of the per-frame device path of x264vfw_tpu/encode/tpu_encoder.py ::
TpuEncoder: push_frame (the scene-cut IDR decision and, with --bframes,
the B-frame scheduler: display order in, decode order out) ->
encode_frame (I and P) or _encode_b -> one uint8 upload, the fused I, P
or B phase 1 (encode/device_finalize.py: I16x16 and I_NxN, P with AQ,
MB-tree QP offsets, weighted prediction, the 8x8 transform, trellis and,
with --ref N, a search over the DPB, B with the direct/skip flips, the
in-loop deblock of I and P when the config asks for it), a pack sized
from the slot lengths, one pull of the payload bytes, with --cabac the
host CABAC transcode of that CAVLC slice (bitstream/cabac_transcode.py),
and the NAL wrap on the host.  Reference frames (deblocked when the
slice filters) stay on the device between frames: the last one (ref)
and, with --ref N > 1, the DPB of the last N I and P frames (dpb, newest
first, reset at each IDR; a P frame uses as many as it holds,
_cur_nref).  B frames are non-reference and keep one reference per list,
the anchors on either side.  The batched session (encode/pipeline.py)
drives the same object: it reads and writes display_idx, _last_idr_d,
poc_base, poc, qp, frame_num, frame_idx, dpb and _cur_nref, writes slice
headers with _slice_header_codes, uploads a run of frames with
pack_batch_rows and encodes IDRs, the anchors that fill the DPB, tail
anchors and tail B frames with encode_frame and _encode_b.  With measure
on (the session's --psnr/--ssim) each frame's recon, a B frame's from
encode_b_slots(want_recon=True), stays on the device per display index
until the session takes it with pop_recon.

Header conventions (SPS profile/level/DPB size, PPS, slice headers,
version SEI) are the JAX package's, byte for byte.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bitstream.mb_syntax import SLICE_B, SLICE_I, SLICE_P
from ..bitstream.nal import NAL_PPS, NAL_SLICE, NAL_SLICE_IDR, NAL_SPS, wrap_nal
from ..bitstream.params import (PPS, SPS, PROFILE_BASELINE, PROFILE_HIGH,
                                PROFILE_MAIN)
from ..bitstream.slice import SliceHeader
from ..ops import tables
from ..utils.bitstream import BitWriter
from ..utils.device import resolve_device
from . import device_finalize
from .ref_encoder import EncoderConfig


class TorchEncoder:
    def __init__(self, cfg: EncoderConfig, device=None) -> None:
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError(f"odd geometry {cfg.width}x{cfg.height}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mbw = (cfg.width + 15) // 16
        self.mbh = (cfg.height + 15) // 16
        # High with the 8x8 transform, else Main with CABAC or B frames,
        # else Constrained Baseline; POC type 0 with B frames (the decoder
        # reorders by pic_order_cnt_lsb), else 2
        self.sps = SPS(
            profile_idc=PROFILE_HIGH if cfg.dct8x8
            else (PROFILE_MAIN if (cfg.cabac or cfg.bframes)
                  else PROFILE_BASELINE),
            constraint_set0=0 if (cfg.cabac or cfg.bframes or cfg.dct8x8)
            else 1,
            constraint_set1=1,
            level_idc=_level_for(cfg.width, cfg.height, cfg.fps_num,
                                 cfg.fps_den),
            log2_max_frame_num_minus4=4,
            pic_order_cnt_type=0 if cfg.bframes else 2,
            log2_max_pic_order_cnt_lsb_minus4=4,
            # kept exactly as the JAX package writes it (tpu_encoder.py:62,
            # two frames with B frames: both anchors of a B), without
            # clamping to the level's DPB: byte parity comes first
            max_num_ref_frames=(max(2, min(cfg.num_ref_frames, 4))
                                if cfg.bframes
                                else max(1, min(cfg.num_ref_frames, 4))),
            pic_width_in_mbs_minus1=self.mbw - 1,
            pic_height_in_map_units_minus1=self.mbh - 1,
        )
        if cfg.width % 16 or cfg.height % 16:
            self.sps.frame_cropping_flag = 1
            self.sps.frame_crop_right_offset = (self.mbw * 16 - cfg.width) // 2
            self.sps.frame_crop_bottom_offset = (self.mbh * 16 - cfg.height) // 2
        _apply_vui(self.sps, cfg)
        # --ref: the DPB's depth.  P frames search all of it; B frames keep
        # one reference per list (their slice headers override the active
        # counts to 1 and 1).  P partitions are searched with one
        # reference only: with several, P MBs stay 16x16.
        self.nref = max(1, min(cfg.num_ref_frames, 4))
        self.partitions = bool(cfg.partitions) and self.nref == 1
        self.pps = PPS(entropy_coding_mode_flag=1 if cfg.cabac else 0,
                       pic_init_qp_minus26=cfg.qp - 26,
                       weighted_pred_flag=1 if cfg.weightp > 0 else 0,
                       num_ref_idx_l0_default_active_minus1=self.nref - 1,
                       chroma_qp_index_offset=min(max(cfg.chroma_qp_offset,
                                                      -12), 12),
                       deblocking_filter_control_present_flag=1,
                       transform_8x8_mode_flag=1 if cfg.dct8x8 else 0)
        self._wp: tuple | None = None   # this P frame's (w, o) or None
        self._wp_prev = None            # pooled previous input luma
        # scene-cut lookahead (--scenecut / --min-keyint)
        from .lookahead import SceneCut
        self._scenecut = SceneCut(cfg.scenecut) if cfg.scenecut > 0 else None
        self.transcode_ms = 0.0   # the last frame's host CABAC transcode
        self.frame_idx = 0
        self.frame_num = 0
        self.idr_id = 0
        self.poc = 0                  # pic_order_cnt_lsb of current frame
        self.display_idx = 0
        self.poc_base = 0             # display index of the last IDR
        self._last_idr_d: int | None = None
        self.pending: list = []        # buffered B candidates (y, u, v, d)
        self.ref: tuple | None = None  # device (y, u, v) int32 recon
        self.dpb: list = []            # with nref > 1: the last nref
        #                                references (y, u, v), newest first
        self._cur_nref = 1             # references the last P frame used
        self.last_mv = None            # device (n, 2) colocated field of the
        #                                last P (device_finalize.colocated_mv)
        self.last_mv8 = None           # its 8x8-grid field, with partitions
        self.qp = cfg.qp
        self.qpc = int(tables.chroma_qp(cfg.qp, self.pps.chroma_qp_index_offset))
        self._i_full = None            # I-frame phase 1 for this geometry
        # PSNR/SSIM telemetry (the reference's b_psnr/b_ssim, codec.c:
        # 1558-1559): with measure on, each frame's recon is kept on the
        # device per display index until the session pops it; off, no
        # pixel leaves the device
        self.measure = False
        self._recon_q: dict[int, tuple] = {}
        self._last_b_recon: tuple | None = None

    # -- telemetry hooks (PSNR/SSIM): recon per display index -------------
    def _stash_recon(self, d: int, planes: tuple | None = None) -> None:
        if self.measure:
            self._recon_q[d] = planes if planes is not None else self.ref

    def pop_recon(self, d: int) -> tuple | None:
        """Reconstruction of display frame d, cropped to the configured
        geometry (host copy).  None when telemetry is off or it was not
        kept."""
        planes = self._recon_q.pop(d, None)
        if planes is None:
            return None
        w, h = self.cfg.width, self.cfg.height
        y, u, v = (p.cpu().numpy() for p in planes)
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]

    # ------------------------------------------------------------------
    @property
    def last_recon(self) -> tuple:
        """Reconstruction of the last encoded frame (host copy, cropped to
        the configured geometry)."""
        w, h = self.cfg.width, self.cfg.height
        y, u, v = (p.cpu().numpy() for p in self.ref)
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]

    def load_state(self, state) -> None:
        """Resume from a convert.EncoderState, e.g. a JAX encoder's last
        reference and DPB, counters, weight-analysis and scene-cut state,
        and with B frames the frames pending for the next anchor, the last
        anchor's colocated field and the display index.  Without B frames
        the display index is frame_idx unless the state says otherwise.
        A state without a DPB gives an encoder with --ref > 1 the last
        reference alone."""
        H, W = self.mbh * 16, self.mbw * 16
        if tuple(state.ref[0].shape) != (H, W):
            raise ValueError(f"reference is {tuple(state.ref[0].shape)}, "
                             f"the encoder codes {(H, W)}")
        self.ref = tuple(p.to(self.device, torch.int32) for p in state.ref)
        if self.nref > 1:
            self.dpb = ([tuple(p.to(self.device, torch.int32) for p in r)
                         for r in state.dpb[:self.nref]] if state.dpb
                        else [self.ref])
        self.frame_idx = state.frame_idx
        self.display_idx = (state.frame_idx if state.display_idx is None
                            else state.display_idx)
        self.frame_num = state.frame_num
        self.idr_id = state.idr_id
        self.poc = state.poc
        self.poc_base = state.poc_base
        self._last_idr_d = state.last_idr
        self._wp_prev = state.wp_prev
        self.pending = [tuple(f) for f in state.pending]
        self.last_mv = (None if state.last_mv is None else
                        torch.as_tensor(np.asarray(state.last_mv, np.int32),
                                        device=self.device))
        if self._scenecut is not None:
            self._scenecut.prev = state.scenecut_prev
            self._scenecut._ema = state.scenecut_ema

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
                   qp_p: int | None = None, qp_b: int | None = None,
                   qp_off: np.ndarray | None = None
                   ) -> list[tuple[bytes, int, str]]:
        """Submit one display-order frame.  Returns zero or more encoded AUs
        as (annexb_bytes, display_index, frame type "I", "P" or "B") in
        decode order; an I frame is an IDR.  Without B frames one per
        frame; with --bframes N a frame waits while fewer than N are
        pending, then comes out as the P anchor followed by the pending
        frames as B frames, and an IDR first drains the pending frames
        (_drain_pending_as_tail).  qp_off: the frame's MB-tree QP offsets
        (mbh, mbw), used when it is a P anchor."""
        cfg = self.cfg
        d = self.display_idx
        self.display_idx += 1
        cut = self._scenecut.is_cut(y) if self._scenecut is not None else False
        since = d - self._last_idr_d if self._last_idr_d is not None else None
        is_idr = (since is None or since >= cfg.keyint
                  or (cut and since >= max(cfg.min_keyint, 1)))
        if is_idr:
            self._last_idr_d = d
        if cfg.bframes == 0:
            au = self.encode_frame(y, u, v, qp=qp_i if is_idr else qp_p,
                                   force_idr=is_idr,
                                   qp_off=None if is_idr else qp_off)
            self._stash_recon(d)
            return [(au, d, "I" if is_idr else "P")]
        out: list[tuple[bytes, int, str]] = []
        if is_idr:
            out += self._drain_pending_as_tail(qp_p, qp_b)
            self.poc_base = d
            self.poc = 0
            out.append((self.encode_frame(y, u, v, qp=qp_i, force_idr=True),
                        d, "I"))
            self._stash_recon(d)
            return out
        if len(self.pending) < cfg.bframes:
            self.pending.append((y, u, v, d))
            return out
        # the anchor: the P frame first, then the pending frames as B's
        self.pending.append((y, u, v, d))
        return out + self._drain_pending_as_tail(qp_p, qp_b, qp_off)

    def flush(self, qp_p: int | None = None,
              qp_b: int | None = None) -> list[tuple[bytes, int, str]]:
        """End of stream: close the last mini-GOP (_drain_pending_as_tail)."""
        return self._drain_pending_as_tail(qp_p, qp_b)

    def _drain_pending_as_tail(self, qp_p, qp_b=None, qp_off=None):
        """Close a mini-GOP: the last pending frame becomes the P anchor
        (with the MB-tree offsets qp_off; the JAX package passes none at
        an IDR or the flush), the others B frames between the previous
        anchor and it.  Returns (au, display_index, frame type)."""
        if not self.pending:
            return []
        *bs, (py, pu, pv, pd) = self.pending
        self.pending = []
        old_ref = self.ref
        self.poc = 2 * (pd - self.poc_base)
        out = [(self.encode_frame(py, pu, pv, qp=qp_p, force_idr=False,
                                  qp_off=qp_off), pd, "P")]
        self._stash_recon(pd)
        mvcol = self.last_mv
        for (by, bu, bv, bd) in bs:
            out.append((self._encode_b(by, bu, bv, old_ref, self.ref, mvcol,
                                       2 * (bd - self.poc_base),
                                       qp_b if qp_b is not None else qp_p),
                        bd, "B"))
            self._stash_recon(bd, self._last_b_recon)
        return out

    def _encode_b(self, y, u, v, ref0, ref1, mvcol, poc: int,
                  qp: int | None) -> bytes:
        """Encode one non-reference B frame between the anchors ref0 and
        ref1 (mvcol: ref1's colocated field).  Its frame_num is the
        counter after the later anchor (PrevRefFrameNum + 1, §7.4.3),
        which it does not advance."""
        cfg = self.cfg
        if qp is not None:
            self.qp = int(min(max(qp, 0), 51))
            self.qpc = int(tables.chroma_qp(self.qp,
                                            self.pps.chroma_qp_index_offset))
        self.poc = poc
        src_d = torch.from_numpy(self.pack_batch_rows([(y, u, v)])[0]) \
            .to(self.device)
        hv, hl = self._header_slots(SLICE_B, NAL_SLICE, nal_ref_idc=0)
        sv_, sl_, *rec = device_finalize.encode_b_slots(
            src_d, *ref0, *ref1, mvcol, self.qp, self.qpc, hv, hl,
            cfg.search_range, cfg.subpel, cfg.me_backend, dct8x8=cfg.dct8x8,
            want_recon=self.measure)
        self._last_b_recon = tuple(rec) if self.measure else None
        data, nbits = device_finalize.pack_phase(sv_, sl_)
        payload = data[:(nbits + 7) // 8].cpu().numpy()
        if cfg.cabac:
            payload = self._transcode(payload, hl, "B")
        self.frame_idx += 1
        return wrap_nal(0, NAL_SLICE, payload)

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     qp: int | None = None,
                     force_idr: bool | None = None,
                     qp_off: np.ndarray | None = None) -> bytes:
        """Encode one I or P frame (an IDR when force_idr, or at keyint
        without it); qp_off: MB-tree's per-MB QP offsets of a P frame."""
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
            if cfg.weightp > 0:
                self._weight_analysis(y)    # refresh the pooled-prev state
            hv, hl = self._header_slots(SLICE_I, nal_type)
            if self._i_full is None:
                self._i_full = device_finalize.encode_i_slots_fn(
                    H, W, cfg.deblock, cfg.deblock_alpha, cfg.deblock_beta,
                    qpc_offset=self.pps.chroma_qp_index_offset,
                    i4x4=cfg.i4x4, dct8x8=cfg.dct8x8)
            sv_, sl_, ry, ru, rv = self._i_full(src_d, self.qp, self.qpc,
                                                hv, hl)
        else:
            nal_type = NAL_SLICE
            self._wp = (self._weight_analysis(y) if cfg.weightp > 0
                        else None)
            # the DPB's references, stacked, once it holds more than one
            self._cur_nref = (min(len(self.dpb), self.nref)
                              if self.nref > 1 and len(self.dpb) > 1 else 1)
            refs = (self.stacked_dpb() if self._cur_nref > 1 else self.ref)
            hv, hl = self._header_slots(SLICE_P, nal_type)
            sv_, sl_, ry, ru, rv, out = device_finalize.encode_p_slots(
                src_d, *refs, self.qp, self.qpc, hv, hl,
                cfg.search_range, cfg.subpel, cfg.me_backend,
                cfg.deblock, cfg.deblock_alpha, cfg.deblock_beta,
                qpc_offset=self.pps.chroma_qp_index_offset,
                partitions=self.partitions, aq_strength=cfg.aq_strength,
                wp=self._wp, dct8x8=cfg.dct8x8,
                qp_off=None if qp_off is None else torch.as_tensor(
                    np.asarray(qp_off, np.int32), device=self.device),
                trellis=cfg.trellis)
            self.last_mv = device_finalize.colocated_mv(
                out, self.mbh * self.mbw)
            self.last_mv8 = out.get("mv8")
        data, nbits = device_finalize.pack_phase(sv_, sl_)
        payload = data[:(nbits + 7) // 8].cpu().numpy()
        if cfg.cabac:
            payload = self._transcode(payload, hl, "I" if is_idr else "P")
        self.ref = (ry, ru, rv)
        if self.nref > 1:
            self.dpb = ([self.ref] + ([] if is_idr else self.dpb))[:self.nref]
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

    def stacked_dpb(self) -> tuple:
        """The DPB's first _cur_nref entries as (R, H, W) y, u and v
        stacks, ref_idx order."""
        return tuple(torch.stack([r[pl] for r in self.dpb[:self._cur_nref]])
                     for pl in range(3))

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
    def _transcode(self, payload: np.ndarray, hl: torch.Tensor,
                   slice_type: str) -> bytes:
        """Re-code the device's CAVLC slice as CABAC on the host.  A slice
        the coder does not take raises: the encoder never writes one."""
        from ..bitstream import cabac_transcode
        t0 = time.perf_counter()
        body = cabac_transcode.transcode_slice(
            payload, int(hl.sum()), slice_type, self.mbh, self.mbw, self.qp,
            nref=self._cur_nref,
            t8_mode=bool(self.pps.transform_8x8_mode_flag))
        if body is None:
            raise RuntimeError(f"the CABAC transcode rejected the encoder's "
                               f"own CAVLC {slice_type} slice")
        self.transcode_ms = (time.perf_counter() - t0) * 1e3
        return body

    def _weight_analysis(self, y: np.ndarray):
        """Per-frame explicit weighted-prediction decision (x264 --weightp
        'smart' role), host numpy as in the JAX package: least squares
        cur ~ a * prev + b on the 8x-pooled input luma; the weights are
        used only when they clearly beat identity (fades).  Returns
        (w, o) at denominator 6, or None."""
        p = np.asarray(y, np.float32)
        hh, ww = p.shape[0] - p.shape[0] % 8, p.shape[1] - p.shape[1] % 8
        cur = p[:hh, :ww].reshape(hh // 8, 8, ww // 8, 8).mean(axis=(1, 3))
        prev, self._wp_prev = self._wp_prev, cur
        if prev is None or prev.shape != cur.shape:
            return None
        vp = float(prev.var())
        if vp < 1.0:
            return None
        a = float(((cur * prev).mean() - cur.mean() * prev.mean()) / vp)
        b = float(cur.mean() - a * prev.mean())
        w_ = int(min(max(round(a * 64), -128), 127))
        o_ = int(min(max(round(b), -128), 127))
        if abs(w_ - 64) <= 1 and abs(o_) <= 1:
            return None
        sse_id = float(((cur - prev) ** 2).mean())
        wpred = np.clip(((prev * w_ + 32) // 64) + o_, 0, 255)
        sse_w = float(((cur - wpred) ** 2).mean())
        if sse_w > 0.75 * sse_id:
            return None
        return (w_, o_)

    def _header_slots(self, slice_type: int, nal_type: int,
                      nal_ref_idc: int = 3):
        """Slice-header codes as fixed-size device slot arrays."""
        hw = self._slice_header_codes(slice_type, nal_type, nal_ref_idc)
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
        if self.nref > 1 and slice_type == SLICE_P:
            # the active count: the references the DPB holds (fewer than
            # --ref right after an IDR)
            h.num_ref_idx_active_override_flag = 1
            h.num_ref_idx_l0_active_minus1 = self._cur_nref - 1
        if self.nref > 1 and slice_type == SLICE_B:
            h.num_ref_idx_active_override_flag = 1
            h.num_ref_idx_l0_active_minus1 = 0
            h.num_ref_idx_l1_active_minus1 = 0
        if self.pps.weighted_pred_flag and slice_type == SLICE_P:
            h.luma_log2_weight_denom = 6
            h.luma_weights_l0 = [self._wp] * self._cur_nref
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
