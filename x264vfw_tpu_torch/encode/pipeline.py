"""Batched session pipeline: the session's path when it is not zero-latency.

Port of x264vfw_tpu/encode/pipeline.py :: BatchPipeline for P-only
streams (no B frames, one reference, no MB-tree, no weighted prediction,
CAVLC).  The session buffers a window of display-order frames, then:

  * decides the IDRs of the window (keyint; scene cuts are not ported),
    encoding each IDR per frame (TorchEncoder.encode_frame);
  * encodes each run of P frames between them with one QP from rate
    control, through device_finalize.encode_pgop_slots, which queues the
    whole run on the device without reading anything back;
  * returns the run's access units as deferred handles (_Lazy), whose
    packing (which reads each frame's bit count) waits for _finalize.

Windows are double-buffered as in the JAX package: push() dispatches
window N+1, then finalizes window N (packs it, wraps its NAL units, feeds
rate control with its sizes).  So the QPs of window N+1 are chosen before
window N's sizes reach the rate control, in exactly the JAX package's
order, and on a CUDA device window N+1's queued work overlaps window N's
host work.  The cost is the JAX package's: one window of extra output
latency (frames_info().delay = 2 * window - 1).

Output AUs come in decode order as (annexb, display_idx, is_idr, ftype,
qp).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.mb_syntax import SLICE_P
from ..bitstream.nal import NAL_SLICE, wrap_nal
from ..ops import tables
from . import device_finalize as F
from .torch_encoder import TorchEncoder


class _Lazy:
    """A deferred AU: (group, index).  group.materialize() produces the
    bytes of the whole run."""

    __slots__ = ("group", "idx")

    def __init__(self, group, idx):
        self.group = group
        self.idx = idx

    def get(self) -> bytes:
        return self.group.materialize()[self.idx]


class _PGroup:
    """A dispatched P run: its slot rows on the device until the first AU
    of the run is asked for, then the run's wrapped AUs."""

    def __init__(self, vs, ls):
        self.vs = vs
        self.ls = ls
        self._aus = None

    def materialize(self) -> list:
        if self._aus is None:
            datas, nbits = F.pack_batch(self.vs, self.ls)
            nbytes = [(nb + 7) // 8 for nb in nbits]
            # one device-to-host copy for the run's payloads
            blob = torch.cat([d[:n] for d, n in zip(datas, nbytes)]) \
                .cpu().numpy()
            ends = np.cumsum(nbytes)
            self._aus = [wrap_nal(3, NAL_SLICE, blob[e - n:e])
                         for e, n in zip(ends, nbytes)]
            self.vs = self.ls = None
        return self._aus


class BatchPipeline:
    def __init__(self, enc: TorchEncoder, rc, mbtree=None, window: int = 12):
        cfg = enc.cfg
        if (mbtree is not None or cfg.bframes or cfg.cabac or cfg.weightp
                or cfg.num_ref_frames > 1):
            raise NotImplementedError(
                "the batched session carries P-only CAVLC streams with one "
                "reference; B frames, MB-tree, weightp, multi-ref and CABAC "
                "are not ported yet (ROADMAP.md, queue A)")
        self.enc = enc
        self.rc = rc
        self.window = max(2, window)
        self.q: list = []          # buffered (y, u, v) in display order
        self._inflight: list = []  # the previous window's items

    # ------------------------------------------------------------- input
    def push(self, y, u, v) -> list:
        self.q.append((y, u, v))
        if len(self.q) >= self.window:
            dispatched = self._run()
            done, self._inflight = self._inflight, dispatched
            return self._finalize(done)
        return []

    def flush(self) -> list:
        out = self._finalize(self._inflight)
        self._inflight = []
        return out + self._finalize(self._run())

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
    def _run(self) -> list:
        """Dispatch the buffered frames: IDR decisions over the window,
        then each IDR per frame and each run of P frames in one batch."""
        enc = self.enc
        frames, self.q = self.q, []
        plan = []                  # (y, u, v, display_idx, is_idr)
        for (y, u, v) in frames:
            d = enc.display_idx
            enc.display_idx += 1
            since = (d - enc._last_idr_d if enc._last_idr_d is not None
                     else None)
            is_idr = since is None or since >= enc.cfg.keyint
            if is_idr:
                enc._last_idr_d = d
            plan.append((y, u, v, d, is_idr))

        out: list = []
        i = 0
        while i < len(plan):
            y, u, v, d, is_idr = plan[i]
            if is_idr:
                enc.poc_base = d
                enc.poc = 0
                qp_i = self.rc.qp_for_type("I")
                au = enc.encode_frame(y, u, v, qp=qp_i, force_idr=True)
                out.append((au, d, True, "I", qp_i))
                i += 1
                continue
            j = i
            while j < len(plan) and not plan[j][4]:
                j += 1
            qp_p = self.rc.qp_for_type("P")
            run = plan[i:j]
            aus = self._p_batch(run, [qp_p] * len(run))
            out += [(au, it[3], False, "P", qp_p) for au, it in zip(aus, run)]
            i = j
        return out

    def _p_batch(self, items: list, qps: list) -> list:
        """Dispatch a run of P display frames (y, u, v, d, _) as one
        batch; its AUs come back as _Lazy handles."""
        enc = self.enc
        cfg = enc.cfg
        G = len(items)
        rows = torch.from_numpy(enc.pack_batch_rows(
            [it[:3] for it in items])).to(enc.device)
        hvs = np.zeros((G, F.MAX_HDR), np.int64)
        hls = np.zeros((G, F.MAX_HDR), np.int32)
        for k, it in enumerate(items):
            enc.qp = int(min(max(qps[k], 0), 51))
            enc.poc = 2 * (it[3] - enc.poc_base)
            hv, hl = enc._slice_header_codes(SLICE_P, NAL_SLICE).to_slots(
                pad_to=F.MAX_HDR)
            hvs[k] = hv
            hls[k] = hl
            enc.frame_idx += 1
            enc.frame_num = (enc.frame_num + 1) % (
                1 << (enc.sps.log2_max_frame_num_minus4 + 4))
        offset = enc.pps.chroma_qp_index_offset
        qpcs = [int(tables.chroma_qp(q, offset)) for q in qps]
        vs, ls, ry, ru, rv, mvs = F.encode_pgop_slots(
            rows, *enc.ref, qps, qpcs,
            torch.from_numpy(hvs).to(enc.device),
            torch.from_numpy(hls).to(enc.device),
            cfg.search_range, cfg.subpel, cfg.me_backend, cfg.deblock,
            cfg.deblock_alpha, cfg.deblock_beta, offset, cfg.partitions)
        enc.ref = (ry, ru, rv)
        enc.last_mv = mvs[-1]
        group = _PGroup(vs, ls)
        return [_Lazy(group, g) for g in range(G)]
