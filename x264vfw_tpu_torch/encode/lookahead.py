"""Frame-type lookahead: scene-cut detection and MB-tree (host, numpy).

Copy of x264vfw_tpu/encode/lookahead.py: SceneCut and _pool8 (the
--scenecut / --min-keyint decision) and MBTree (--mbtree /
--rc-lookahead), with MBTree's float32 arithmetic and operation order
unchanged, so its offsets are the JAX package's bit for bit.  Both read
the input frames only, so the device pipeline stays asynchronous.
Frames are mean-pooled 8x on the host; two signals gate a cut:

  1. cost ratio: the best pooled SAD over a +-4 pool-pixel (+-32 full-res
     pixel) global motion set against the mean spatial gradient (what
     intra prediction exploits): inter > (1 - 0.006 * strength) * intra;
  2. temporal spike: the inter cost jumps above 1.5x its running average
     (steady fast or noisy motion keeps a high but flat inter cost and
     must not cut on every frame).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def _pool8(y: np.ndarray) -> np.ndarray:
    h, w = y.shape
    h8, w8 = h - h % 8, w - w % 8
    return (y[:h8, :w8].astype(np.float32)
            .reshape(h8 // 8, 8, w8 // 8, 8).mean(axis=(1, 3)))


class SceneCut:
    """Stateful detector: feed display-order luma planes, get cut
    decisions.  Its state between frames is `prev` (the last pooled
    frame) and `_ema` (the running inter cost)."""

    RANGE = 4          # pool-px search radius (32 full-res px)
    SPIKE = 1.5        # inter cost must exceed this multiple of its average

    def __init__(self, strength: int = 40) -> None:
        self.bias = max(0, strength) * 0.006
        self.prev: np.ndarray | None = None
        self._ema: float | None = None

    def _inter_cost(self, cur: np.ndarray, prev: np.ndarray) -> float:
        """Min mean-SAD over the (2R+1)^2 global offsets, edge-padded."""
        R = self.RANGE
        pp = np.pad(prev, R, mode="edge")
        win = np.lib.stride_tricks.sliding_window_view(pp, cur.shape)
        diff = np.abs(win.reshape(-1, *cur.shape) - cur[None])
        return float(diff.mean(axis=(1, 2)).min())

    def is_cut(self, y: np.ndarray) -> bool:
        """True when this frame starts a new scene: inter prediction from
        the previous input frame is no cheaper than intra, and the inter
        cost spiked against the recent past."""
        cur = _pool8(np.asarray(y))
        prev, self.prev = self.prev, cur
        if prev is None or self.bias <= 0:
            return False
        inter = self._inter_cost(cur, prev)
        gx = np.abs(np.diff(cur, axis=1)).mean() if cur.shape[1] > 1 else 0.0
        gy = np.abs(np.diff(cur, axis=0)).mean() if cur.shape[0] > 1 else 0.0
        intra = (gx + gy) / 2.0 + 1.0
        ratio_hit = inter > (1.0 - self.bias) * intra
        spike_hit = self._ema is None or inter > self.SPIKE * self._ema
        cut = ratio_hit and spike_hit
        if not cut:
            self._ema = inter if self._ema is None else (
                0.5 * self._ema + 0.5 * inter)
        return cut


# ---------------------------------------------------------------------------
# MB-tree: macroblock-tree rate control (the reference forwards x264's
# --mbtree/--rc-lookahead, codec.c:927-928/872).  x264 runs a lookahead
# encoder, then walks the frame window BACKWARDS, propagating each MB's
# predicted future cost to the reference MBs it draws from, and lowers QP
# where the propagated (future) importance is high.  SURVEY.md §5 maps this
# to "batched cost-propagation over a sliding frame window".
#
# This implementation estimates costs on 8x-pooled input planes (one MB =
# 2x2 pooled px): inter cost = best pooled SAD over a +-4 pool-px candidate
# grid (+-32 full-res px), intra cost = pooled gradient energy.  Both are
# cached per frame on entry, so the backward propagation per emitted frame
# is O(window) cheap numpy.
# ---------------------------------------------------------------------------

class MBTree:
    """Sliding-window MB-tree: push display-order frames, pop (frame,
    qp_offset-map) once the lookahead is full."""

    RANGE = 4          # pool-px search radius for the lookahead ME

    def __init__(self, mbw: int, mbh: int, lookahead: int = 20,
                 qcomp: float = 0.6) -> None:
        self.mbw, self.mbh = mbw, mbh
        self.look = max(1, lookahead)
        self.strength = 2.0 * max(0.0, 1.0 - qcomp)
        # queue entries: (frame_payload, pooled, intra (mbh,mbw),
        #                 inter vs prev (mbh,mbw), mv (mbh,mbw,2) pool-px)
        self.q: deque = deque()
        self._prev_pool: np.ndarray | None = None

    # -- per-frame cost model (pooled) --
    def _mb_cells(self, a: np.ndarray) -> np.ndarray:
        """(..., h8, w8) pooled plane(s) -> (..., mbh, mbw) per-MB sums
        over 2x2 cells (edge-replicated into partial MBs)."""
        mh, mw = self.mbh, self.mbw
        c = a[..., :2 * mh, :2 * mw]
        h2, w2 = c.shape[-2] // 2 * 2, c.shape[-1] // 2 * 2
        s = (c[..., :h2, :w2]
             .reshape(*c.shape[:-2], h2 // 2, 2, w2 // 2, 2)
             .sum(axis=(-3, -1)))
        ph, pw = mh - s.shape[-2], mw - s.shape[-1]
        if ph or pw:
            s = np.pad(s, [(0, 0)] * (s.ndim - 2) + [(0, ph), (0, pw)],
                       mode="edge")
        return s.astype(np.float32)

    def _costs(self, cur: np.ndarray, prev: np.ndarray | None):
        gx = np.abs(np.diff(cur, axis=1, append=cur[:, -1:]))
        gy = np.abs(np.diff(cur, axis=0, append=cur[-1:]))
        intra = self._mb_cells(gx + gy) + 4.0
        if prev is None:
            return intra, intra.copy(), np.zeros((self.mbh, self.mbw, 2),
                                                 np.int32)
        R = self.RANGE
        K = 2 * R + 1
        pp = np.pad(prev, R, mode="edge")
        # all K*K candidate offsets at once (a python loop of 81 plane
        # passes was ~30 ms/frame at 1080p — a real cap on the pipeline)
        win = np.lib.stride_tricks.sliding_window_view(pp, cur.shape)
        diff = np.abs(win - cur[None, None]).reshape(K * K, *cur.shape)
        sads = self._mb_cells(diff)
        k = np.argmin(sads, axis=0)
        best = np.take_along_axis(sads, k[None], axis=0)[0]
        bmv = np.stack([k // K - R, k % K - R], axis=-1).astype(np.int32)
        return intra, best, bmv

    # -- queue interface --
    def push(self, payload, y: np.ndarray) -> list:
        """Add a display-order frame; returns list of (payload, qp_offset)
        ready to encode (empty while the window fills)."""
        cur = _pool8(y)
        intra, inter, mv = self._costs(cur, self._prev_pool)
        self._prev_pool = cur
        self.q.append((payload, intra, inter, mv))
        if len(self.q) <= self.look:
            return []
        return [self._pop()]

    def flush(self) -> list:
        out = []
        while self.q:
            out.append(self._pop())
        self._prev_pool = None
        return out

    def _pop(self):
        """Propagate future costs backwards through the window, then emit
        the oldest frame with its per-MB QP offset map (<= 0)."""
        n = len(self.q)
        prop = np.zeros((self.mbh, self.mbw), np.float32)
        # walk from the newest frame towards the oldest: each frame's
        # (intra + propagate_in) * (1 - inter/intra) flows to the MBs of
        # its reference (the previous frame), split by the lookahead mv
        for i in range(n - 1, 0, -1):
            _, intra, inter, mv = self.q[i]
            frac = np.clip(1.0 - inter / np.maximum(intra, 1e-3), 0.0, 1.0)
            amount = (intra + prop if i < n - 1 else intra) * frac
            nxt = np.zeros_like(prop)
            # mv is in pool px; an MB spans 2 pool px -> the donor lands
            # on the MB grid shifted by mv/2 (nearest split to 2 cells)
            my, mx = mv[..., 0], mv[..., 1]
            ty = np.clip(np.arange(self.mbh)[:, None] + np.round(my / 2.0)
                         .astype(np.int64), 0, self.mbh - 1)
            tx = np.clip(np.arange(self.mbw)[None, :] + np.round(mx / 2.0)
                         .astype(np.int64), 0, self.mbw - 1)
            np.add.at(nxt, (ty, tx), amount)
            prop = nxt
        payload, intra0, _, _ = self.q.popleft()
        ratio = 1.0 + prop / np.maximum(intra0, 1e-3)
        off = -self.strength * np.log2(ratio)
        qp_off = np.clip(np.round(off), -6, 0).astype(np.int32)
        return payload, qp_off
