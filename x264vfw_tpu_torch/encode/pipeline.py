"""Batched session pipeline: the session's path when it is not zero-latency.

Port of x264vfw_tpu/encode/pipeline.py :: BatchPipeline.  The session
buffers a window of display-order frames, then:

  * hands each frame through MB-tree first (--mbtree: encode/lookahead
    MBTree, which holds rc_lookahead frames back and attaches per-MB QP
    offsets to each);
  * decides the IDRs of the window (keyint, and scene cuts with
    --scenecut), runs the weight analysis over every frame of it (which
    moves its state only: batched P frames are encoded without weights,
    as in the JAX package, and their slice headers carry no weight table,
    where the JAX package's repeat the last per-frame P's), and encodes
    each IDR per frame
    (TorchEncoder.encode_frame), after draining the B candidates pending
    before it (_drain_pending);
  * encodes each run of frames between IDRs with one QP per frame type
    from rate control: without B frames as one batch of P frames
    (device_finalize.encode_pgop_slots); with --bframes N as mini-GOPs,
    an anchor after every N buffered B candidates, all anchors of the
    run as one batch (which keeps their recons and colocated fields),
    then every B frame of the run as one batch between its two anchors
    (encode_bgop_slots).  Candidates left over wait for the next run.
    With --ref N > 1 the anchors are encoded per frame (encode_frame)
    while the DPB holds fewer than N references, and the rest of the run
    as one batch over the sliding DPB, which the batch's last N recons
    then replace;
  * returns the run's access units as deferred handles (_Lazy), whose
    packing (which reads each frame's bit count) and, with --cabac, host
    transcode (a thread pool of 4; the C passes release the GIL) wait
    for _finalize.

Windows are double-buffered as in the JAX package: push() dispatches
window N+1, then finalizes window N (packs it, wraps its NAL units, feeds
rate control with its sizes).  So the QPs of window N+1 are chosen before
window N's sizes reach the rate control, in exactly the JAX package's
order, and on a CUDA device window N+1's queued work overlaps window N's
host work.  The cost is the JAX package's: one window of extra output
latency (frames_info().delay = bframes + lookahead + 2 * window - 1).

Output AUs come in decode order as (annexb, display_idx, is_idr, ftype,
qp).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..bitstream.mb_syntax import SLICE_B, SLICE_P
from ..bitstream.nal import NAL_SLICE, wrap_nal
from ..ops import tables
from . import device_finalize as F
from .torch_encoder import TorchEncoder


class _Lazy:
    """A deferred AU: (group, index).  group.materialize() produces the
    bytes of the whole batch."""

    __slots__ = ("group", "idx")

    def __init__(self, group, idx):
        self.group = group
        self.idx = idx

    def get(self) -> bytes:
        return self.group.materialize()[self.idx]


class _Group:
    """A dispatched batch of P or B frames: its slot rows on the device
    until the first AU of the batch is asked for, then its wrapped AUs."""

    def __init__(self, pipe, vs, ls, hdr_bits: list, slice_type: str,
                 qps: list, nal_ref_idc: int, nref: int = 1):
        self.pipe = pipe
        self.nref = nref
        self.vs = vs
        self.ls = ls
        self.hdr_bits = hdr_bits
        self.slice_type = slice_type
        self.qps = qps
        self.nal_ref_idc = nal_ref_idc
        self._aus = None

    def materialize(self) -> list:
        if self._aus is None:
            datas, nbits = F.pack_batch(self.vs, self.ls)
            nbytes = [(nb + 7) // 8 for nb in nbits]
            # one device-to-host copy for the batch's payloads
            blob = torch.cat([d[:n] for d, n in zip(datas, nbytes)]) \
                .cpu().numpy()
            ends = np.cumsum(nbytes)
            self._aus = self.pipe._wrap_all(
                [blob[e - n:e] for e, n in zip(ends, nbytes)], self.hdr_bits,
                self.slice_type, self.qps, self.nal_ref_idc, self.nref)
            self.vs = self.ls = None
        return self._aus


class BatchPipeline:
    def __init__(self, enc: TorchEncoder, rc, mbtree=None, window: int = 12):
        self.enc = enc
        self.rc = rc
        self.mbtree = mbtree
        self.window = max(2, window)
        self.q: list = []          # ready (y, u, v, qp_off) in display order
        self._pending_b: list = []  # B candidates (y, u, v, qp_off, d)
        self._inflight: list = []  # the previous window's items
        self._pool = ThreadPoolExecutor(max_workers=4) if enc.cfg.cabac \
            else None
        self.transcode_ms: list = []   # wall ms of each batch's transcodes

    # ------------------------------------------------------------- input
    def push(self, y, u, v) -> list:
        if self.mbtree is not None:
            self.q += [(*f, off) for f, off in self.mbtree.push((y, u, v), y)]
        else:
            self.q.append((y, u, v, None))
        if len(self.q) >= self.window:
            dispatched = self._run(final=False)
            done, self._inflight = self._inflight, dispatched
            return self._finalize(done)
        return []

    def flush(self) -> list:
        if self.mbtree is not None:
            self.q += [(*f, off) for f, off in self.mbtree.flush()]
        out = self._finalize(self._inflight)
        self._inflight = []
        out += self._finalize(self._run(final=True))
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        return out

    # ---------------------------------------------------------- finalize
    def _finalize(self, items: list) -> list:
        """Materialize deferred AUs and feed rate control with their
        sizes, in decode order."""
        out = []
        for (au, d, key, ftype, qp) in items:
            if isinstance(au, _Lazy):
                au = au.get()
            self.rc.update(ftype, qp, len(au) * 8)
            out.append((au, d, key, ftype, qp))
        return out

    # -------------------------------------------------------------- core
    def _run(self, final: bool) -> list:
        """Dispatch the buffered frames: IDR decisions and weight analysis
        over the window, then each IDR per frame and each run between
        them batched."""
        enc = self.enc
        cfg = enc.cfg
        frames, self.q = self.q, []
        if not frames:
            return self._drain_pending() if final else []
        plan = []                  # (y, u, v, qp_off, display_idx, is_idr)
        for (y, u, v, off) in frames:
            d = enc.display_idx
            enc.display_idx += 1
            cut = (enc._scenecut.is_cut(y) if enc._scenecut is not None
                   else False)
            since = (d - enc._last_idr_d if enc._last_idr_d is not None
                     else None)
            is_idr = (since is None or since >= cfg.keyint
                      or (cut and since >= max(cfg.min_keyint, 1)))
            if is_idr:
                enc._last_idr_d = d
            if cfg.weightp > 0:
                enc._weight_analysis(y)
            plan.append((y, u, v, off, d, is_idr))

        out: list = []
        i = 0
        while i < len(plan):
            y, u, v, off, d, is_idr = plan[i]
            if is_idr:
                out += self._drain_pending()
                enc.poc_base = d
                enc.poc = 0
                qp_i = self.rc.qp_for_type("I")
                au = enc.encode_frame(y, u, v, qp=qp_i, force_idr=True)
                out.append((au, d, True, "I", qp_i))
                i += 1
                continue
            j = i
            while j < len(plan) and not plan[j][5]:
                j += 1
            out += self._encode_run([it[:5] for it in plan[i:j]],
                                    final and j == len(plan))
            i = j
        if final:
            out += self._drain_pending()
        return out

    def _drain_pending(self) -> list:
        """B candidates with no later anchor: the last one becomes the
        closing P anchor (with its MB-tree offsets), the others B frames
        between the previous anchor and it (TorchEncoder.
        _drain_pending_as_tail)."""
        enc = self.enc
        pending, self._pending_b = self._pending_b, []
        if not pending:
            return []
        qp_p = self.rc.qp_for_type("P")
        qp_b = self.rc.qp_for_type("B")
        enc.pending = [(y, u, v, d) for (y, u, v, _, d) in pending]
        outs = enc._drain_pending_as_tail(qp_p, qp_b, qp_off=pending[-1][3])
        return [(au, d, False, t, qp_p if t == "P" else qp_b)
                for au, d, t in outs]

    def _encode_run(self, run: list, is_tail: bool) -> list:
        """Encode a run of non-IDR display frames (y, u, v, qp_off, d):
        P anchors and, with --bframes, the B frames between them."""
        enc = self.enc
        bf = enc.cfg.bframes
        if bf == 0:
            qp_p = self.rc.qp_for_type("P")
            aus = self._p_batch(run, [qp_p] * len(run))[0]
            return [(au, it[4], False, "P", qp_p) for au, it in zip(aus, run)]

        # mini-GOPs: an anchor after every bf buffered B candidates
        groups = []                 # (anchor item, [B items])
        pending, self._pending_b = self._pending_b, []
        for item in run:
            if len(pending) < bf:
                pending.append(item)
            else:
                groups.append((item, pending))
                pending = []
        self._pending_b = pending
        if not groups:
            return self._drain_pending() if is_tail else []

        qp_p = self.rc.qp_for_type("P")
        qp_b = self.rc.qp_for_type("B")
        prev_ref = enc.ref                  # the recon of the last anchor
        aus_p, recons, mvs, fn_after = self._p_batch(
            [g[0] for g in groups], [qp_p] * len(groups), want_bextras=True)
        # every B frame of the run in one batch, each between its anchors
        b_items, hdrs = [], []
        fn_final = enc.frame_num
        for gi, (_, bs) in enumerate(groups):
            r0 = prev_ref if gi == 0 else recons[gi - 1]
            for (by, bu, bv, _, bd) in bs:
                enc.poc = 2 * (bd - enc.poc_base)
                enc.qp = qp_b
                # non-reference B: frame_num = PrevRefFrameNum + 1, the
                # counter right after its later anchor advanced it (§7.4.3)
                enc.frame_num = fn_after[gi]
                hdrs.append(enc._slice_header_codes(
                    SLICE_B, NAL_SLICE, nal_ref_idc=0).to_slots(
                        pad_to=F.MAX_HDR))
                b_items.append((by, bu, bv, r0, recons[gi], mvs[gi]))
        enc.frame_num = fn_final
        aus_b = self._b_batch(b_items, hdrs, qp_b) if b_items else []
        # decode order: each anchor, then its B frames
        out, bi = [], 0
        for gi, (anchor, bs) in enumerate(groups):
            out.append((aus_p[gi], anchor[4], False, "P", qp_p))
            for b in bs:
                out.append((aus_b[bi], b[4], False, "B", qp_b))
                bi += 1
        if is_tail:
            out += self._drain_pending()
        return out

    def _p_batch(self, items: list, qps: list, want_bextras: bool = False):
        """Dispatch P display frames (y, u, v, qp_off, d) as one batch;
        with --ref N > 1 the first ones per frame while the DPB holds fewer
        than N references.  Returns (the AUs, those of the batch as _Lazy
        handles; the frames' recons (the B frames' references, only with
        want_bextras) and colocated fields; the frame_num counter after
        each frame)."""
        enc = self.enc
        cfg = enc.cfg
        aus, recons, mvs, fn_after = [], [], [], []
        while enc.nref > 1 and len(enc.dpb) < enc.nref and items:
            (y, u, v, off, d), *items = items
            enc.poc = 2 * (d - enc.poc_base)
            aus.append(enc.encode_frame(y, u, v, qp=qps[0], force_idr=False,
                                        qp_off=off))
            qps = qps[1:]
            fn_after.append(enc.frame_num)
            mvs.append(enc.last_mv)
            if want_bextras:
                # the recon as the encoder keeps it (int32 on the device):
                # the B phase takes any integer dtype, so no copy is made
                recons.append(enc.ref)
        if not items:
            return aus, recons, mvs, fn_after
        G = len(items)
        rows = torch.from_numpy(enc.pack_batch_rows(
            [it[:3] for it in items])).to(enc.device)
        hvs = np.zeros((G, F.MAX_HDR), np.int64)
        hls = np.zeros((G, F.MAX_HDR), np.int32)
        n = enc.mbh * enc.mbw
        has_off = any(it[3] is not None for it in items)
        qp_offs = np.zeros((G, n), np.int32) if has_off else None
        # the batched program predicts without weights, from the whole DPB
        enc._wp = None
        enc._cur_nref = min(len(enc.dpb), enc.nref) if enc.nref > 1 else 1
        for k, it in enumerate(items):
            enc.qp = int(min(max(qps[k], 0), 51))
            enc.poc = 2 * (it[4] - enc.poc_base)
            hvs[k], hls[k] = enc._slice_header_codes(
                SLICE_P, NAL_SLICE).to_slots(pad_to=F.MAX_HDR)
            if it[3] is not None:
                qp_offs[k] = np.asarray(it[3], np.int32).reshape(n)
            enc.frame_idx += 1
            enc.frame_num = (enc.frame_num + 1) % (
                1 << (enc.sps.log2_max_frame_num_minus4 + 4))
            fn_after.append(enc.frame_num)
        offset = enc.pps.chroma_qp_index_offset
        qpcs = [int(tables.chroma_qp(q, offset)) for q in qps]
        multi = enc.nref > 1
        res = F.encode_pgop_slots(
            rows, *(enc.stacked_dpb() if multi else enc.ref), qps, qpcs,
            torch.from_numpy(hvs).to(enc.device),
            torch.from_numpy(hls).to(enc.device),
            cfg.search_range, cfg.subpel, cfg.me_backend, cfg.deblock,
            cfg.deblock_alpha, cfg.deblock_beta, offset, enc.partitions,
            cfg.aq_strength, cfg.dct8x8,
            None if qp_offs is None
            else torch.from_numpy(qp_offs).to(enc.device),
            want_recons=want_bextras, trellis=cfg.trellis)
        vs, ls, ry, ru, rv, batch_mvs = res[:6]
        if multi:
            enc.dpb = [(ry[i], ru[i], rv[i]) for i in range(ry.shape[0])]
            enc.ref = enc.dpb[0]
        else:
            enc.ref = (ry, ru, rv)
        enc.last_mv = batch_mvs[-1]
        group = _Group(self, vs, ls, [int(h.sum()) for h in hls], "P",
                       list(qps), 3, enc._cur_nref)
        aus += [_Lazy(group, g) for g in range(G)]
        if want_bextras:
            recons += res[6]
        return aus, recons, mvs + list(batch_mvs), fn_after

    def _b_batch(self, b_items: list, hdrs: list, qp_b: int) -> list:
        """Dispatch B frames (y, u, v, ref0, ref1, mvcol) with their header
        slots as one batch; their AUs come back as _Lazy handles."""
        enc = self.enc
        cfg = enc.cfg
        Gb = len(b_items)
        rows = torch.from_numpy(enc.pack_batch_rows(
            [it[:3] for it in b_items])).to(enc.device)
        hvs = np.stack([h[0] for h in hdrs]).astype(np.int64)
        hls = np.stack([h[1] for h in hdrs]).astype(np.int32)
        qpc_b = int(tables.chroma_qp(qp_b, enc.pps.chroma_qp_index_offset))
        vs, ls = F.encode_bgop_slots(
            rows, [it[3] for it in b_items], [it[4] for it in b_items],
            [it[5] for it in b_items], [qp_b] * Gb, [qpc_b] * Gb,
            torch.from_numpy(hvs).to(enc.device),
            torch.from_numpy(hls).to(enc.device),
            cfg.search_range, cfg.subpel, cfg.me_backend, cfg.dct8x8)
        group = _Group(self, vs, ls, [int(h.sum()) for h in hls], "B",
                       [qp_b] * Gb, 0)
        return [_Lazy(group, g) for g in range(Gb)]

    # ------------------------------------------------------- entropy out
    def _wrap_all(self, payloads: list, hdr_bits: list, slice_type: str,
                  qps: list, nal_ref_idc: int, nref: int = 1) -> list:
        """Wrap a batch's CAVLC slices into AUs; with --cabac transcode
        each slice (of a P batch over nref references) first, in the
        thread pool, and return them in order.  A slice the transcoder
        rejects raises."""
        enc = self.enc
        if not enc.cfg.cabac:
            return [wrap_nal(nal_ref_idc, NAL_SLICE, p) for p in payloads]
        from ..bitstream import cabac_transcode
        t8_mode = bool(enc.pps.transform_8x8_mode_flag)

        def tx(args):
            p, hb, qp = args
            body = cabac_transcode.transcode_slice(
                p, int(hb), slice_type, enc.mbh, enc.mbw, int(qp),
                nref=nref, t8_mode=t8_mode)
            if body is None:
                raise RuntimeError(f"the CABAC transcode rejected the "
                                   f"encoder's own CAVLC {slice_type} slice")
            return body

        t0 = time.perf_counter()
        bodies = list(self._pool.map(tx, zip(payloads, hdr_bits, qps)))
        self.transcode_ms.append((time.perf_counter() - t0) * 1e3)
        return [wrap_nal(nal_ref_idc, NAL_SLICE, b) for b in bodies]
