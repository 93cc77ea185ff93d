# Frozen copy of psnr() from x264vfw_tpu_torch/utils/metrics.py at commit
# d01bfbf (unchanged at 4a379f6), with the squared error it is made of.
"""Luma error of a decoded picture against its source, float64 on the
host, as x264 reports it."""

from __future__ import annotations

import numpy as np


def mse(a, b) -> float:
    """Mean squared error of two planes, in float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(((a - b) ** 2).mean())


def psnr(a, b, max_val: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(max_val * max_val / mse)
