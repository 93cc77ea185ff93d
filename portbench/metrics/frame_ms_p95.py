"""frame_ms_p95: the 95th percentile of the host time of every
compress() call counted in the window, each of which returned its own
frame's access unit (the per-frame path)."""

import numpy as np


def read(run):
    ms = [(te - ts) * 1e3 for ts, te, n, inside in run.calls
          if inside and n > 0]
    return float(np.percentile(ms, 95)) if ms else None
