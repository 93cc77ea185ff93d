"""GOP-parallel encoding over a list of devices.

Port of x264vfw_tpu/parallel/gop.py.  Closed GOPs (IDR-led) are
independent, so a clip's GOPs spread over devices with pure data
parallelism, the analogue of x264's frame threading (the reference's
option surface, codec.c:933-943).  Each device runs the complete
per-frame pipeline on its own GOPs: motion search, transform/quant,
reconstruction, the in-loop deblock, CAVLC slot generation and packing.
The output is finished slice-payload bytes per frame, exactly the bytes
the per-frame encoder emits.  The only statistic that crosses devices is
the real bit count (the JAX package's psum), a host sum here.

A list of devices takes the place of the JAX mesh's 'dp' axis: GOP g runs
on devices[g % len(devices)], JAX's round robin.  The list defaults to
every visible CUDA device (utils/device.resolve_devices) and may name a
device more than once, which is how one card or the CPU stands in for
several devices.  The GOPs run one after another in the calling thread,
each under torch.cuda.device of its card, so that its kernels launch
there.  The per-frame pipeline is bound by the host's kernel launches
(PERF.md section 5), and a host thread per card made four cards 5.5x
slower than one: every PyTorch call hands the GIL over (PERF.md,
section 6).

Differences by design: each frame's output is sized exactly (pack_slots),
so the JAX package's capacity bucket (bucket_words) has no counterpart;
the JAX lax.scan over a GOP's P frames is a Python loop; and the JAX
package pads the GOP batch with dummy GOPs (to a multiple of the mesh
size) and the tail GOP with repeats of its last frame, encodes them and
drops their access units, where the port encodes only the real frames.
No emitted byte depends on them: a P frame reads only the frames before
it in its GOP.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..bitstream.mb_syntax import SLICE_I, SLICE_P
from ..bitstream.nal import NAL_SLICE, NAL_SLICE_IDR, wrap_nal
from ..encode.device import encode_i_frame_core, encode_p_frame_core
from ..encode.device_finalize import (MAX_HDR, _finalize_i_core,
                                      _finalize_p_core, _maybe_deblock,
                                      _unpack_src)
from ..encode.device_pack import pack_slots
from ..ops import tables
from ..utils.device import resolve_devices


def encode_gop_packed_device(frames_yuv, qp: int, qpc: int, H: int, W: int,
                             hdr_vals, hdr_lens, rng: int, subpel: int = 1,
                             me_backend: str = "auto", deblock: bool = False,
                             dbA: int = 0, dbB: int = 0, qpc_offset: int = 0,
                             aq_strength: float = 0.0, trellis: bool = False,
                             partitions: bool = False, i4x4: bool = False,
                             qp_p: int | None = None,
                             qpc_p: int | None = None,
                             dct8x8: bool = False):
    """One GOP -> packed slice payload bytes, on the GOP's device.

    frames_yuv: (G, H*W*3//2) uint8 tensor; frame 0 is the IDR, the rest
    are P frames, each against the (deblocked when `deblock`) recon of the
    one before.  hdr_vals/hdr_lens: (G, MAX_HDR) slice-header codeword
    slots (host-built, frame-varying: frame_num/idr_pic_id), on the same
    device.  qp/qpc apply to the IDR; qp_p/qpc_p (default the same) to
    the P frames.

    Returns (data, nbits): G packed byte tensors (uint8, whole 32-bit
    words) and G bit counts (Python ints)."""
    mbh, mbw = H // 16, W // 16
    if qp_p is None:
        qp_p, qpc_p = qp, qpc
    i_out = encode_i_frame_core(*_unpack_src(frames_yuv[0], H, W), qp, qpc,
                                i4x4)
    d, nb = pack_slots(*_finalize_i_core(i_out, hdr_vals[0], hdr_lens[0],
                                         mbh, mbw, t8_mode=dct8x8))
    data, nbits = [d], [nb]
    ref = _maybe_deblock(i_out, qp, mbh, mbw, True, deblock, dbA, dbB,
                         qpc_offset=qpc_offset)
    for k in range(1, frames_yuv.shape[0]):
        out = encode_p_frame_core(*_unpack_src(frames_yuv[k], H, W), *ref,
                                  qp_p, qpc_p, rng, subpel, me_backend,
                                  qpc_offset=qpc_offset,
                                  aq_strength=aq_strength, trellis=trellis,
                                  partitions=partitions, dct8x8=dct8x8)
        d, nb = pack_slots(*_finalize_p_core(out, hdr_vals[k], hdr_lens[k],
                                             mbh, mbw, t8_mode=dct8x8))
        data.append(d)
        nbits.append(nb)
        ref = _maybe_deblock(out, qp_p, mbh, mbw, False, deblock, dbA, dbB,
                             qpc_offset=qpc_offset)
    return data, nbits


def _on(dev: torch.device):
    """The CUDA device context of dev (a no-op for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def encode_gops_sharded_packed(gops, qp: int, qpc: int, H: int, W: int,
                               hdr_vals, hdr_lens, devices=None,
                               rng: int = 4, subpel: int = 1,
                               me_backend: str = "auto",
                               deblock: bool = False, dbA: int = 0,
                               dbB: int = 0, qpc_offset: int = 0,
                               aq_strength: float = 0.0,
                               trellis: bool = False,
                               partitions: bool = False, i4x4: bool = False,
                               qp_p: int | None = None,
                               qpc_p: int | None = None,
                               dct8x8: bool = False):
    """Encode each GOP to packed slice payloads on its own device: GOP g
    on devices[g % len(devices)] (default: every visible CUDA device), in
    order.

    gops: a sequence of (G_g, H*W*3//2) uint8 frame rows (a tail GOP may
    be shorter); hdr_vals/hdr_lens: a sequence of (G_g, MAX_HDR) slot
    arrays to match.

    Returns (data, nbits, total_bits): per GOP a list of its frames'
    packed bytes (numpy uint8) and a list of their bit counts, and the
    sum of every bit count.  Callers slice data[g][k][:(nbits[g][k] + 7)
    // 8] and wrap it with wrap_nal to obtain the AU payloads."""
    devs = resolve_devices(devices)
    kw = dict(rng=rng, subpel=subpel, me_backend=me_backend,
              deblock=deblock, dbA=dbA, dbB=dbB, qpc_offset=qpc_offset,
              aq_strength=float(aq_strength), trellis=trellis,
              partitions=partitions, i4x4=i4x4, qp_p=qp_p, qpc_p=qpc_p,
              dct8x8=dct8x8)

    data, nbits = [], []
    for g in range(len(gops)):
        dev = devs[g % len(devs)]
        with _on(dev):
            d, nb = encode_gop_packed_device(
                torch.as_tensor(np.asarray(gops[g], np.uint8), device=dev),
                qp, qpc, H, W,
                torch.as_tensor(np.asarray(hdr_vals[g], np.int64),
                                device=dev),
                torch.as_tensor(np.asarray(hdr_lens[g], np.int32),
                                device=dev), **kw)
        data.append([x.cpu().numpy() for x in d])
        nbits.append(nb)
    return data, nbits, sum(sum(nb) for nb in nbits)


def _gop_header_slots(henc, n_frames: int, qp: int | None = None,
                      qp_p: int | None = None):
    """A GOP's slice-header slots as the per-frame encoder writes them:
    frame_num k from the IDR at henc.idr_id, with qp given the slice QP of
    the IDR (qp) and of the P frames (qp_p).  Returns (hdr_vals
    (n, MAX_HDR) int64, hdr_lens (n, MAX_HDR) int32)."""
    hv = np.zeros((n_frames, MAX_HDR), np.int64)
    hl = np.zeros((n_frames, MAX_HDR), np.int32)
    for k in range(n_frames):
        if qp is not None:
            henc.qp = qp if k == 0 else qp_p
        henc.frame_num = k % (1 << (henc.sps.log2_max_frame_num_minus4 + 4))
        w = henc._slice_header_codes(SLICE_I if k == 0 else SLICE_P,
                                     NAL_SLICE_IDR if k == 0 else NAL_SLICE)
        hv[k], hl[k] = w.to_slots(pad_to=MAX_HDR)
    return hv, hl


def _gop_kwargs(henc) -> dict:
    """encode_gops_sharded_packed's options from an encoder's config."""
    cfg = henc.cfg
    return dict(rng=cfg.search_range, subpel=cfg.subpel,
                me_backend=cfg.me_backend, deblock=cfg.deblock,
                dbA=cfg.deblock_alpha, dbB=cfg.deblock_beta,
                qpc_offset=henc.pps.chroma_qp_index_offset,
                aq_strength=cfg.aq_strength, trellis=cfg.trellis,
                partitions=bool(cfg.partitions), i4x4=cfg.i4x4,
                dct8x8=bool(henc.pps.transform_8x8_mode_flag))


class GopShardPipeline:
    """The session's path for --threads N > 1 over several devices: GOP
    data parallelism behind the same push/flush contract and output
    tuples as encode.pipeline.BatchPipeline ((annexb, display_idx,
    is_idr, ftype, qp) in decode order).

    Buffers display-order frames into len(devices) closed GOPs of gop_len
    frames (default min(keyint, 32)), encodes them with
    encode_gops_sharded_packed and emits their access units.  The
    feature set is bframes 0, ref 1, weightp 0, no MB-tree and no scene
    cuts: the session warns and downgrades before it builds this
    pipeline.  Rate control chooses one QP per frame type per batch and
    is fed each AU's real size.  With --cabac each slice gets the host
    CABAC transcode (one reference); its milliseconds per slice are in
    transcode_ms."""

    def __init__(self, enc, rc, devices=None, gop_len: int | None = None):
        self.enc = enc                    # header/SPS/PPS machinery + state
        self.rc = rc
        self.devices = resolve_devices(devices)
        self.n_dev = len(self.devices)
        # the latency is n_dev * gop_len frames: cap the GOP so that the
        # pipeline stays usable at long --keyint
        self.G = gop_len or min(enc.cfg.keyint, 32)
        self.buf: list = []
        self._disp = 0
        self.transcode_ms: list[float] = []

    @property
    def delay(self) -> int:
        """The most frames an input waits before its AU comes out."""
        return self.n_dev * self.G - 1

    def push(self, y, u, v) -> list:
        self.buf.append((y, u, v))
        if len(self.buf) >= self.n_dev * self.G:
            return self._run()
        return []

    def flush(self) -> list:
        out = []
        while self.buf:
            out += self._run()
        return out

    def _run(self) -> list:
        henc = self.enc
        G = self.G
        frames = self.buf[:self.n_dev * G]
        self.buf = self.buf[len(frames):]
        n_gops = (len(frames) + G - 1) // G
        H, W = henc.mbh * 16, henc.mbw * 16
        qp = int(min(max(self.rc.qp_for_type("I"), 1), 51))
        qp_p = int(min(max(self.rc.qp_for_type("P"), 1), 51))
        off = henc.pps.chroma_qp_index_offset
        qpc = int(tables.chroma_qp(qp, off))
        qpc_p = int(tables.chroma_qp(qp_p, off))
        gops = [henc.pack_batch_rows(frames[g * G:(g + 1) * G])
                for g in range(n_gops)]
        hdrs = []
        idr0 = henc.idr_id
        for g in range(n_gops):
            henc.idr_id = (idr0 + g) % 65536
            hdrs.append(_gop_header_slots(henc, len(gops[g]), qp, qp_p))
        henc.idr_id = (idr0 + n_gops) % 65536
        data, nbits, _total = encode_gops_sharded_packed(
            gops, qp, qpc, H, W, [h[0] for h in hdrs], [h[1] for h in hdrs],
            devices=self.devices, qp_p=qp_p, qpc_p=qpc_p,
            **_gop_kwargs(henc))
        out = []
        for g in range(n_gops):
            for k in range(len(gops[g])):
                payload = data[g][k][:(nbits[g][k] + 7) // 8]
                ftype = "I" if k == 0 else "P"
                qp_used = qp if k == 0 else qp_p
                if henc.cfg.cabac:
                    t0 = time.perf_counter()
                    payload = _cabac(henc, payload, hdrs[g][1][k], ftype,
                                     qp_used)
                    self.transcode_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                au = wrap_nal(3, NAL_SLICE_IDR if k == 0 else NAL_SLICE,
                              bytes(payload))
                if k == 0:
                    au = henc.headers() + au
                self.rc.update(ftype, qp_used, len(au) * 8)
                out.append((au, self._disp, k == 0, ftype, qp_used))
                self._disp += 1
        return out


def _cabac(henc, payload: np.ndarray, hdr_lens: np.ndarray, ftype: str,
           qp: int) -> bytes:
    """The host CABAC transcode of one GOP slice (one reference)."""
    from ..bitstream import cabac_transcode
    body = cabac_transcode.transcode_slice(
        payload, int(hdr_lens.sum()), ftype, henc.mbh, henc.mbw, qp,
        nref=1, t8_mode=bool(henc.pps.transform_8x8_mode_flag))
    if body is None:
        raise RuntimeError("CABAC transcode rejected a sharded-GOP slice")
    return body


def encode_clip_gop_parallel(frames: list, cfg, devices=None,
                             gop_len: int | None = None) -> bytes:
    """Encode a clip as closed GOPs spread over devices, returning a
    complete Annex-B stream byte-identical to the per-frame encoder at
    keyint == gop_len.

    frames: list of (y, u, v) uint8 planes; cfg: EncoderConfig.  The clip
    is split into ceil(n / gop_len) GOPs; device d of the list takes GOPs
    d, d + len(devices), ... (x264 frame threading's round robin,
    codec.c:933-943).  gop_len defaults to cfg.keyint; devices to every
    visible CUDA device."""
    from ..encode.torch_encoder import TorchEncoder

    # what the GOP program cannot carry is a loud error, not a silent drop
    if cfg.num_ref_frames > 1:
        raise NotImplementedError(
            "GOP-parallel encoding supports 1 reference per GOP; "
            "use --ref 1 with --threads > 1")
    if cfg.weightp > 0:
        raise NotImplementedError(
            "GOP-parallel encoding does not support explicit weightp; "
            "use --weightp 0 with --threads > 1")
    if cfg.bframes > 0:
        raise NotImplementedError(
            "GOP-parallel encoding does not support B-frames yet; "
            "use --bframes 0 with --threads > 1")
    devs = resolve_devices(devices)
    G = gop_len or cfg.keyint
    n = len(frames)
    n_gops = (n + G - 1) // G
    henc = TorchEncoder(cfg, device=devs[0])   # header/SPS/PPS machinery
    H, W = henc.mbh * 16, henc.mbw * 16
    gops = [henc.pack_batch_rows(frames[g * G:(g + 1) * G])
            for g in range(n_gops)]
    # per-frame slice headers as the per-frame session writes them:
    # frame_num restarts at each IDR, idr_pic_id counts the GOPs
    hdrs = []
    for g in range(n_gops):
        henc.idr_id = g % 65536
        hdrs.append(_gop_header_slots(henc, len(gops[g])))
    data, nbits, _total = encode_gops_sharded_packed(
        gops, henc.qp, henc.qpc, H, W, [h[0] for h in hdrs],
        [h[1] for h in hdrs], devices=devs, **_gop_kwargs(henc))
    stream = b""
    for g in range(n_gops):
        for k in range(len(gops[g])):
            payload = data[g][k][:(nbits[g][k] + 7) // 8]
            if cfg.cabac:
                payload = _cabac(henc, payload, hdrs[g][1][k],
                                 "I" if k == 0 else "P", henc.qp)
            if k == 0:
                stream += henc.headers()
                stream += wrap_nal(3, NAL_SLICE_IDR, payload)
            else:
                stream += wrap_nal(3, NAL_SLICE, payload)
    return stream
