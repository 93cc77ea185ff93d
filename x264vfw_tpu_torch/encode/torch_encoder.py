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
until the session takes it with pop_recon.  With host_entropy on (the
JAX package's reference / debug path) encode_frame runs the I or P core
alone and pulls its syntax tensors: with CAVLC (no loop filter, no
weighted prediction) the numpy coder (bitstream/cavlc_vec.py) writes the
slice, _finalize_i and _finalize_p; with --cabac the C CABAC coder
(bitstream/cabac_native.py) writes the I, P and B slices from them, the
syntax-tensor CABAC route (_encode_frame_cabac, _encode_b_cabac), every
option of the config taken, the loop filter and the DPB as on the
device-entropy route.

Header conventions (SPS profile/level/DPB size, PPS, slice headers,
version SEI) are the JAX package's, byte for byte.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bitstream import cavlc_vec
from ..bitstream.mb_syntax import CBP_TO_CODE, SLICE_B, SLICE_I, SLICE_P
from ..bitstream.nal import NAL_PPS, NAL_SLICE, NAL_SLICE_IDR, NAL_SPS, wrap_nal
from ..bitstream.params import (PPS, SPS, PROFILE_BASELINE, PROFILE_HIGH,
                                PROFILE_MAIN)
from ..bitstream.slice import SliceHeader
from ..ops import tables
from ..utils.bitstream import BitWriter, se_codes, ue_codes
from ..utils.device import resolve_device
from . import device_finalize
from .device_finalize import BLK_X, BLK_Y
from .ref_encoder import EncoderConfig

S = cavlc_vec.SLOTS


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
        # the last slice's host CABAC ms: the transcode, or on the
        # syntax-tensor route the C coder's call
        self.transcode_ms = 0.0
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
        # host_entropy: the slice written on the host from the pulled
        # syntax tensors (reference / debug); off, the CAVLC stage stays on
        # the device
        self.host_entropy = False
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
        if cfg.cabac and self.host_entropy:
            return self._encode_b_cabac(y, u, v, ref0, ref1, mvcol)
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
        if cfg.cabac and self.host_entropy:
            return self._encode_frame_cabac(y, u, v, is_idr, qp_off)
        if self.host_entropy:
            assert not cfg.deblock, "host_entropy debug path has no deblock"
            assert cfg.weightp == 0, "host_entropy debug path has no weightp"
            return self._wrap_frame(*self._host_entropy_frame(y, u, v,
                                                              is_idr),
                                    is_idr)
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
            refs = self._p_references(y)
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
        return self._wrap_frame(payload, nal_type, is_idr)

    def _wrap_frame(self, payload, nal_type: int, is_idr: bool) -> bytes:
        """The I or P slice's AU (headers first at an IDR); advances the
        frame counters."""
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

    # -- host_entropy: the numpy finalisation -----------------------------
    def _host_entropy_frame(self, y, u, v, is_idr: bool):
        """The I or P core alone (P16x16 from the last reference, none of
        AQ, trellis, partitions or the 8x8 transform, as in the JAX
        package), its syntax tensors finalised on the host.  Returns
        (slice RBSP, NAL unit type)."""
        from .device import encode_i_frame_core, encode_p_frame_core
        cfg = self.cfg
        sy, su, sv = self._planes_i32(y, u, v)
        if is_idr:
            self.frame_num = 0
            out = encode_i_frame_core(sy, su, sv, self.qp, self.qpc)
            payload, nal_type = self._finalize_i(out), NAL_SLICE_IDR
        else:
            out = encode_p_frame_core(sy, su, sv, *self.ref, self.qp,
                                      self.qpc, rng=cfg.search_range,
                                      subpel=cfg.subpel,
                                      me_backend=cfg.me_backend)
            payload, nal_type = self._finalize_p(out), NAL_SLICE
        self.ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        return payload, nal_type

    def _planes_i32(self, y, u, v) -> tuple:
        """The frame's planes, edge-padded to the MB-multiple size, as int32
        tensors on the device."""
        H, W = self.mbh * 16, self.mbw * 16
        return tuple(torch.as_tensor(np.ascontiguousarray(
            _pad(p, H // k, W // k), dtype=np.int32), device=self.device)
            for p, k in ((y, 1), (u, 2), (v, 2)))

    # -- host_entropy with --cabac: the syntax-tensor CABAC route ----------
    def _cabac_header(self, slice_type: int, nal_type: int,
                      nal_ref_idc: int = 3) -> bytes:
        """The slice header's bytes, ended with cabac_alignment_one_bits
        (§7.3.4: CABAC slice data starts byte-aligned)."""
        hw = self._slice_header_codes(slice_type, nal_type, nal_ref_idc)
        pad = (-hw.bit_position) % 8
        if pad:
            hw.u(pad, (1 << pad) - 1)
        return hw.to_rbsp().tobytes()

    def _encode_frame_cabac(self, y, u, v, is_idr: bool, qp_off) -> bytes:
        """One I or P frame on the syntax-tensor CABAC route (host_entropy
        with --cabac): the I or P core alone, its syntax tensors pulled,
        the slice data written on the host by the C coder
        (bitstream/cabac_native.py), then, as on the device-entropy route,
        the loop filter, the DPB and the counters.  The P core takes every
        option of the config (weights, several references, partitions,
        AQ, MB-tree offsets, trellis, the 8x8 transform); the I core only
        the I4x4 candidate, as in the JAX package."""
        from ..bitstream import cabac_native as cn
        from .device import (apply_loop_filter, encode_i_frame_core,
                             encode_p_frame_core)
        cfg = self.cfg
        mbh, mbw = self.mbh, self.mbw
        sy, su, sv = self._planes_i32(y, u, v)
        if is_idr:
            self.frame_num = 0
            nal_type = NAL_SLICE_IDR
            if cfg.weightp > 0:
                self._weight_analysis(y)    # refresh the pooled-prev state
            outd = encode_i_frame_core(sy, su, sv, self.qp, self.qpc,
                                       i4x4=cfg.i4x4)
        else:
            nal_type = NAL_SLICE
            refs = self._p_references(y)
            outd = encode_p_frame_core(
                sy, su, sv, *refs, self.qp, self.qpc, rng=cfg.search_range,
                subpel=cfg.subpel, me_backend=cfg.me_backend,
                partitions=self.partitions, aq_strength=cfg.aq_strength,
                qpc_offset=self.pps.chroma_qp_index_offset, wp=self._wp,
                dct8x8=cfg.dct8x8,
                qp_off=None if qp_off is None else torch.as_tensor(
                    np.asarray(qp_off, np.int32), device=self.device),
                trellis=cfg.trellis)
            self.last_mv = device_finalize.colocated_mv(outd, mbh * mbw)
            self.last_mv8 = outd.get("mv8")
        syn = self._i_syntax(outd) if is_idr else self._p_syntax(outd)
        hdr = self._cabac_header(SLICE_I if is_idr else SLICE_P, nal_type)
        t8_mode = bool(self.pps.transform_8x8_mode_flag)
        t0 = time.perf_counter()
        if is_idr:
            body = cn.encode_i_slice(self.qp, mbh, mbw, *syn,
                                     t8_mode=t8_mode)
        else:
            t8 = outd.get("t8")
            body = cn.encode_p_slice(
                self.qp, 0, mbh, mbw, *syn, self._cur_nref,
                np.zeros(mbh * mbw, np.uint8) if t8 is None else _host(t8),
                t8_mode)
        self.transcode_ms = (time.perf_counter() - t0) * 1e3
        self.ref = (outd["recon_y"], outd["recon_u"], outd["recon_v"])
        if cfg.deblock:
            self.ref = apply_loop_filter(
                outd, self.qp, mbh, mbw, is_idr, offA=2 * cfg.deblock_alpha,
                offB=2 * cfg.deblock_beta,
                qpc_offset=self.pps.chroma_qp_index_offset)
        if self.nref > 1:
            self.dpb = ([self.ref] + ([] if is_idr else self.dpb))[:self.nref]
        return self._wrap_frame(hdr + body, nal_type, is_idr)

    def _encode_b_cabac(self, y, u, v, ref0, ref1, mvcol) -> bytes:
        """One B frame on the syntax-tensor CABAC route: the B core alone
        (no trellis, no 8x8 transform, as in the JAX package), the final
        per-list vectors and their predictions (device_finalize.
        b_mv_pred), the slice written by the C coder."""
        from ..bitstream import cabac_native as cn
        from .device import encode_b_frame_core
        cfg = self.cfg
        mbh, mbw = self.mbh, self.mbw
        n = mbh * mbw
        outd = encode_b_frame_core(
            *self._planes_i32(y, u, v), *ref0, *ref1, mvcol, self.qp,
            self.qpc, rng=cfg.search_range, subpel=cfg.subpel,
            me_backend=cfg.me_backend, want_recon=self.measure)
        self._last_b_recon = (tuple(outd[k] for k in ("recon_y", "recon_u",
                                                      "recon_v"))
                              if self.measure else None)
        mode_map = outd["mode"].reshape(mbh, mbw, 1)
        mvds = []
        for lst, on in (("0", (1, 3)), ("1", (2, 3))):
            mv = torch.where((mode_map == on[0]) | (mode_map == on[1]),
                             outd["mv" + lst].reshape(mbh, mbw, 2), 0)
            pmv = device_finalize.b_mv_pred(
                mv, outd["uses" + lst].reshape(mbh, mbw))
            mvds.append(_host(mv - pmv).reshape(n, 2))
        res = self._residual_syntax(outd)
        cbp_l, cbp_c = res[0], res[1]
        mode = _host(outd["mode"])
        skip = (mode == 0) & (cbp_l == 0) & (cbp_c == 0)
        hdr = self._cabac_header(SLICE_B, NAL_SLICE, nal_ref_idc=0)
        t0 = time.perf_counter()
        body = cn.encode_b_slice(self.qp, 0, mbh, mbw, skip, mode, *mvds,
                                 *res,
                                 bool(self.pps.transform_8x8_mode_flag),
                                 np.zeros(n, np.uint8))
        self.transcode_ms = (time.perf_counter() - t0) * 1e3
        self.frame_idx += 1
        return wrap_nal(0, NAL_SLICE, hdr + body)

    def _chroma_syntax(self, outd, cbp_c: np.ndarray) -> tuple:
        """Chroma DC u, v (n, 4) and AC u, v (n, 4, 15) as the C coder
        takes them, masked by cbp_chroma."""
        n = self.mbh * self.mbw
        dc = (cbp_c >= 1)[:, None]
        ac = (cbp_c == 2)[:, None, None]
        return (np.where(dc, _host(outd["dc_u"]).reshape(n, 4), 0),
                np.where(dc, _host(outd["dc_v"]).reshape(n, 4), 0),
                np.where(ac, _host(outd["ac_u"]), 0),
                np.where(ac, _host(outd["ac_v"]), 0))

    def _residual_syntax(self, outd) -> tuple:
        """An inter frame's residual as the C coder takes it: cbp_luma,
        cbp_chroma, the luma levels (n, 16, 16) masked by the coded
        quadrants, then _chroma_syntax."""
        cbp_l, cbp_c = _host(outd["cbp_luma"]), _host(outd["cbp_chroma"])
        quad = ((cbp_l[:, None] >> (np.arange(16) // 4)) & 1).astype(bool)
        return (cbp_l, cbp_c,
                np.where(quad[:, :, None], _host(outd["levels"]), 0),
                *self._chroma_syntax(outd, cbp_c))

    def _i_syntax(self, outd) -> tuple:
        """The I core's syntax in encode_i_slice's argument order (after qp,
        mbh, mbw): modes, the AC flag, cbp_chroma, luma DC and AC (masked
        by the flag), _chroma_syntax, and with I4x4 MBs their prediction
        modes, cbp and levels."""
        acf = _host(outd["cbp_luma_nz"]).astype(np.uint8)
        cbc = _host(outd["cbp_chroma"])
        use_i4 = outd.get("use_i4")
        i4 = None
        if use_i4 is not None and bool(use_i4.any()):
            i4 = tuple(_host(outd[k]) for k in ("use_i4", "i4_prev", "i4_rem",
                                                "cbp_luma4", "levels4"))
        return (_host(outd["i16_mode"]), _host(outd["cmode"]), acf, cbc,
                _host(outd["dc"]),
                np.where(acf[:, None, None].astype(bool),
                         _host(outd["ac"]), 0),
                *self._chroma_syntax(outd, cbc), i4)

    def _p_syntax(self, outd) -> tuple:
        """The P core's syntax in encode_p_slice's argument order (after
        qp, init_idc, mbh, mbw, up to nref): the P_Skip flags, the mvds per
        quadrant slot (n, 4, 2), the residual (_residual_syntax), the
        mb_qp_deltas, the partition shapes and the ref_idx.  P16x16
        vectors are predicted with p16_mv_pred over the ref_idx map,
        partitions with inter_partition.partition_mvds; an MB skips when
        it codes no residual, at refIdx 0 with the P_Skip vector (with
        partitions, a 16x16 MB at the zero vector where P_Skip's is
        zero)."""
        from .inter_partition import partition_mvds
        mbh, mbw = self.mbh, self.mbw
        n = mbh * mbw
        res = self._residual_syntax(outd)
        coded = (res[0] != 0) | (res[1] != 0)
        zeros = np.zeros(n, np.int32)
        qpd = _host(outd["qp_delta"]) if "qp_delta" in outd else zeros
        ref = _host(outd["ref_idx"]) if "ref_idx" in outd else zeros
        if "part" in outd:
            part = outd["part"]
            mvd8, _, skipz = partition_mvds(outd["mv8"],
                                            part.reshape(mbh, mbw))
            mv00 = _host(outd["mv8"][0::2, 0::2]).reshape(n, 2)
            part = _host(part)
            skip = (~coded & (part == 0) & (mv00 == 0).all(1)
                    & _host(skipz).reshape(n))
            mvd = _host(mvd8).reshape(mbh, 2, mbw, 2, 2) \
                .transpose(0, 2, 1, 3, 4).reshape(n, 4, 2)
        else:
            mv = outd["mv"].reshape(mbh, mbw, 2)
            pmv, skipz = device_finalize.p16_mv_pred(
                mv, outd["ref_idx"].reshape(mbh, mbw)
                if "ref_idx" in outd else None)
            mvf = _host(mv).reshape(n, 2)
            skip = (~coded & (mvf == 0).all(1) & _host(skipz).reshape(n)
                    & (ref == 0))
            part = zeros
            mvd = np.zeros((n, 4, 2), np.int32)
            mvd[:, 0] = mvf - _host(pmv).reshape(n, 2)
        return (skip, mvd, *res, qpd, part, ref)

    def _nc_luma_map(self, tc_blk: np.ndarray) -> np.ndarray:
        """tc_blk: (nMB, 16) total coeffs in block coding order ->
        nC per block (nMB, 16)."""
        mbh, mbw = self.mbh, self.mbw
        tcm = np.zeros((mbh * 4, mbw * 4), dtype=np.int64)
        gy = (np.arange(mbh * mbw) // mbw * 4)[:, None] + BLK_Y[None, :]
        gx = (np.arange(mbh * mbw) % mbw * 4)[:, None] + BLK_X[None, :]
        tcm[gy, gx] = tc_blk
        nc = _nc_from_map(tcm)
        return nc[gy, gx]

    def _nc_chroma_map(self, tc_c: np.ndarray) -> np.ndarray:
        """tc_c: (nMB, 4) per chroma sub-block (raster) -> nC (nMB, 4)."""
        mbh, mbw = self.mbh, self.mbw
        sbx = np.array([0, 1, 0, 1])
        sby = np.array([0, 0, 1, 1])
        tcm = np.zeros((mbh * 2, mbw * 2), dtype=np.int64)
        gy = (np.arange(mbh * mbw) // mbw * 2)[:, None] + sby[None, :]
        gx = (np.arange(mbh * mbw) % mbw * 2)[:, None] + sbx[None, :]
        tcm[gy, gx] = tc_c
        nc = _nc_from_map(tcm)
        return nc[gy, gx]

    def _chroma_codes(self, out, n: int, cbp_chroma: np.ndarray):
        """Chroma DC and AC slot arrays of n MBs, masked by cbp_chroma:
        (vals, lens) of DC u, DC v, AC u (n, 4*S), AC v."""
        dc_u, dc_v, ac_u, ac_v = (_host(out[k]) for k in ("dc_u", "dc_v",
                                                          "ac_u", "ac_v"))
        dc_u, dc_v = dc_u.reshape(n, 4), dc_v.reshape(n, 4)
        has_cdc = (cbp_chroma >= 1)[:, None]
        has_cac = (cbp_chroma == 2)[:, None, None]
        ac_u = np.where(has_cac, ac_u, 0)
        ac_v = np.where(has_cac, ac_v, 0)
        dc_u = np.where(has_cdc, dc_u, 0)
        dc_v = np.where(has_cdc, dc_v, 0)
        nc_cu = self._nc_chroma_map(np.count_nonzero(ac_u, axis=-1))
        nc_cv = self._nc_chroma_map(np.count_nonzero(ac_v, axis=-1))
        vcdu, lcdu = cavlc_vec.encode_blocks(dc_u, np.full(n, -1), 4)
        vcdv, lcdv = cavlc_vec.encode_blocks(dc_v, np.full(n, -1), 4)
        lcdu = np.where(has_cdc, lcdu, 0)
        lcdv = np.where(has_cdc, lcdv, 0)
        vcau, lcau = cavlc_vec.encode_blocks(ac_u.reshape(-1, 15),
                                             nc_cu.reshape(-1), 15)
        vcav, lcav = cavlc_vec.encode_blocks(ac_v.reshape(-1, 15),
                                             nc_cv.reshape(-1), 15)
        lcau = np.where(has_cac, lcau.reshape(n, 4, S), 0).reshape(n, -1)
        lcav = np.where(has_cac, lcav.reshape(n, 4, S), 0).reshape(n, -1)
        return ((vcdu, vcdv, vcau.reshape(n, -1), vcav.reshape(n, -1)),
                (lcdu, lcdv, lcau, lcav))

    def _finalize_i(self, out) -> np.ndarray:
        """I16x16 syntax tensors -> the IDR slice RBSP (host CAVLC)."""
        n = self.mbh * self.mbw
        dc = _host(out["dc"])                  # (n, 16)
        ac = _host(out["ac"])                  # (n, 16, 15)
        cbp_luma_nz = _host(out["cbp_luma_nz"])
        cbp_chroma = _host(out["cbp_chroma"])
        mb_type = (1 + _host(out["i16_mode"]) + 4 * cbp_chroma
                   + 12 * cbp_luma_nz)
        # AC only when cbp_luma != 0 (the device's levels are 0 there)
        ac = np.where(cbp_luma_nz[:, None, None], ac, 0)
        nc_l = self._nc_luma_map(np.count_nonzero(ac, axis=-1))
        vdc, ldc = cavlc_vec.encode_blocks(dc, nc_l[:, 0], 16)
        vac, lac = cavlc_vec.encode_blocks(ac.reshape(-1, 15),
                                           nc_l.reshape(-1), 15)
        lac = np.where(cbp_luma_nz[:, None, None], lac.reshape(n, 16, S), 0)
        cv, cl = self._chroma_codes(out, n, cbp_chroma)
        # MB header: mb_type ue, intra_chroma_pred_mode ue, mb_qp_delta
        # se(0)
        hv = np.zeros((n, 3), dtype=np.uint32)
        hl = np.zeros((n, 3), dtype=np.int8)
        hv[:, 0], hl[:, 0] = ue_codes(mb_type)
        hv[:, 1], hl[:, 1] = ue_codes(_host(out["cmode"]))
        hv[:, 2], hl[:, 2] = 1, 1
        vals = np.concatenate([hv, vdc, vac.reshape(n, -1), *cv], axis=1)
        lens = np.concatenate([hl, ldc, lac.reshape(n, -1), *cl], axis=1)
        w = self._slice_header_codes(SLICE_I, NAL_SLICE_IDR)
        w.write_codes(vals.astype(np.uint64).ravel(),
                      lens.astype(np.int64).ravel())
        w.rbsp_trailing_bits()
        return w.to_rbsp()

    def _finalize_p(self, out) -> np.ndarray:
        """P16x16 syntax tensors -> the P slice RBSP (host CAVLC): the
        median MV prediction and P_Skip decision, skip runs, the
        residual masked by the coded block pattern."""
        n = self.mbh * self.mbw
        mv = _host(out["mv"]).reshape(self.mbh, self.mbw, 2)   # quarter pel
        levels = _host(out["levels"])                          # (n, 16, 16)
        cbp_luma = _host(out["cbp_luma"])
        cbp_chroma = _host(out["cbp_chroma"])
        cbp = (cbp_luma | (cbp_chroma << 4)).astype(np.int64)
        pmv, pmv_skip_zero = _p16_mv_pred(mv)
        mv_flat = mv.reshape(n, 2)
        skip = ((cbp == 0) & (mv_flat == 0).all(axis=1)
                & pmv_skip_zero.reshape(n))
        mvd = mv_flat - pmv.reshape(n, 2)
        # skip runs: consecutive skips before each coded MB, then the
        # trailing run
        nonskip_idx = np.nonzero(~skip)[0]
        runs = np.zeros(n, dtype=np.int64)
        if nonskip_idx.size:
            prev = np.concatenate([[-1], nonskip_idx[:-1]])
            runs[nonskip_idx] = nonskip_idx - prev - 1
        trailing = n - 1 - (nonskip_idx[-1] if nonskip_idx.size else -1)
        quad_coded = ((cbp_luma[:, None] >> (np.arange(16) // 4)) & 1) \
            .astype(bool)
        levels = np.where(quad_coded[:, :, None], levels, 0)
        nc_l = self._nc_luma_map(np.count_nonzero(levels, axis=-1))
        vlu, llu = cavlc_vec.encode_blocks(levels.reshape(-1, 16),
                                           nc_l.reshape(-1), 16)
        llu = np.where(quad_coded[:, :, None], llu.reshape(n, 16, S), 0)
        cv, cl = self._chroma_codes(out, n, cbp_chroma)
        # MB header: mb_skip_run, mb_type P_L0_16x16 (ue 0), mvd x and y,
        # coded_block_pattern, mb_qp_delta se(0) when cbp != 0
        hv = np.zeros((n, 6), dtype=np.uint32)
        hl = np.zeros((n, 6), dtype=np.int8)
        hv[:, 0], hl[:, 0] = ue_codes(runs)
        hv[:, 1], hl[:, 1] = 1, 1
        hv[:, 2], hl[:, 2] = se_codes(mvd[:, 0])
        hv[:, 3], hl[:, 3] = se_codes(mvd[:, 1])
        hv[:, 4], hl[:, 4] = ue_codes(CBP_TO_CODE[0, cbp])
        hv[:, 5] = 1
        hl[:, 5] = np.where(cbp != 0, 1, 0)
        vals = np.concatenate([hv, vlu.reshape(n, -1), *cv], axis=1)
        lens = np.concatenate([hl, llu.reshape(n, -1), *cl], axis=1)
        lens = np.where(skip[:, None], 0, lens)
        w = self._slice_header_codes(SLICE_P, NAL_SLICE)
        w.write_codes(vals.astype(np.uint64).ravel(),
                      lens.astype(np.int64).ravel())
        if trailing > 0:
            w.ue(int(trailing))
        w.rbsp_trailing_bits()
        return w.to_rbsp()

    def _p_references(self, y) -> tuple:
        """A P frame's weights (self._wp, from the weight analysis with
        --weightp) and references: the DPB's, stacked, once it holds more
        than one (self._cur_nref of them), else the last reference."""
        self._wp = (self._weight_analysis(y) if self.cfg.weightp > 0
                    else None)
        self._cur_nref = (min(len(self.dpb), self.nref)
                          if self.nref > 1 and len(self.dpb) > 1 else 1)
        return self.stacked_dpb() if self._cur_nref > 1 else self.ref

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


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _nc_from_map(tcm: np.ndarray) -> np.ndarray:
    """Neighbour-averaged nC from a total-coeff map (availability = frame
    edge)."""
    tA = np.zeros_like(tcm)
    tA[:, 1:] = tcm[:, :-1]
    tB = np.zeros_like(tcm)
    tB[1:, :] = tcm[:-1, :]
    availA = np.zeros(tcm.shape, dtype=bool)
    availA[:, 1:] = True
    availB = np.zeros(tcm.shape, dtype=bool)
    availB[1:, :] = True
    return np.where(availA & availB, (tA + tB + 1) >> 1,
                    np.where(availA, tA, np.where(availB, tB, 0)))


def _p16_mv_pred(mv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Median MV prediction for an all-P16x16 frame (§8.4.1.3) and the
    'pmv_skip forces zero' flag (§8.4.1.1).

    mv: (mbh, mbw, 2).  Returns (pmv (mbh, mbw, 2), skip_zero (mbh, mbw)
    bool)."""
    mbh, mbw, _ = mv.shape
    zeros = np.zeros_like(mv)

    def shift(arr, dy, dx):
        out = np.zeros_like(arr)
        ys = slice(max(dy, 0), mbh + min(dy, 0))
        xs = slice(max(dx, 0), mbw + min(dx, 0))
        yd = slice(max(-dy, 0), mbh + min(-dy, 0))
        xd = slice(max(-dx, 0), mbw + min(-dx, 0))
        out[yd, xd] = arr[ys, xs]
        return out

    mvA = shift(mv, 0, -1)   # out[y, x] = mv[y, x - 1] (left)
    mvB = shift(mv, -1, 0)   # above
    mvC = shift(mv, -1, 1)   # above right
    mvD = shift(mv, -1, -1)  # above left
    yy, xx = np.mgrid[0:mbh, 0:mbw]
    availA = xx > 0
    availB = yy > 0
    availC_raw = (yy > 0) & (xx < mbw - 1)
    availD = (yy > 0) & (xx > 0)
    mvC_eff = np.where(availC_raw[..., None], mvC, mvD)
    availC = availC_raw | availD
    only_a = availA & ~availB & ~availC
    nmatch = availA.astype(int) + availB.astype(int) + availC.astype(int)
    mA = np.where(availA[..., None], mvA, zeros)
    mB = np.where(availB[..., None], mvB, zeros)
    mC = np.where(availC[..., None], mvC_eff, zeros)
    med = np.median(np.stack([mA, mB, mC]), axis=0).astype(np.int64)
    one = np.where(availA[..., None], mvA,
                   np.where(availB[..., None], mvB, mvC_eff))
    pmv = np.where(only_a[..., None], mvA,
                   np.where((nmatch == 1)[..., None], one, med)) \
        .astype(np.int64)
    zeroA = availA & (mvA == 0).all(-1)
    zeroB = availB & (mvB == 0).all(-1)
    skip_cond = (~availA) | (~availB) | zeroA | zeroB
    pmv_skip = np.where(skip_cond[..., None], 0, pmv)
    return pmv, (pmv_skip == 0).all(-1)


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
