"""Frame-type lookahead: scene-cut detection (host, numpy).

Copy of SceneCut and _pool8 of x264vfw_tpu/encode/lookahead.py (the
--scenecut / --min-keyint decision; MB-tree is not ported).  The decision
reads the input frames only, so the device pipeline stays asynchronous.
Frames are mean-pooled 8x on the host; two signals gate a cut:

  1. cost ratio: the best pooled SAD over a +-4 pool-pixel (+-32 full-res
     pixel) global motion set against the mean spatial gradient (what
     intra prediction exploits): inter > (1 - 0.006 * strength) * intra;
  2. temporal spike: the inter cost jumps above 1.5x its running average
     (steady fast or noisy motion keeps a high but flat inter cost and
     must not cut on every frame).
"""

from __future__ import annotations

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
