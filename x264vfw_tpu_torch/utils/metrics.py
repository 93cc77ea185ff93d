"""Quality metrics: PSNR / SSIM (the reference's quality oracles,
reference codec.c:1558-1559 b_psnr/b_ssim toggles).

Implemented with numpy on the host in float64, as in the JAX package, so
the port's stats equal its own; SSIM follows the standard 8x8-window
formulation x264 uses for its SSIM telemetry.
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, max_val: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(max_val * max_val / mse)


def ssim(a, b, max_val: float = 255.0) -> float:
    """Mean SSIM over non-overlapping 8x8 blocks (x264-style fast SSIM)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    H, W = a.shape[-2], a.shape[-1]
    h8, w8 = H // 8 * 8, W // 8 * 8
    a = a[..., :h8, :w8].reshape(*a.shape[:-2], h8 // 8, 8, w8 // 8, 8)
    b = b[..., :h8, :w8].reshape(*b.shape[:-2], h8 // 8, 8, w8 // 8, 8)
    mu_a = a.mean(axis=(-3, -1))
    mu_b = b.mean(axis=(-3, -1))
    var_a = a.var(axis=(-3, -1))
    var_b = b.var(axis=(-3, -1))
    cov = (a * b).mean(axis=(-3, -1)) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def frame_psnr_yuv(src_planes, rec_planes) -> dict:
    """Per-plane + global PSNR like x264's end-of-encode report."""
    out = {}
    num = 0.0
    den = 0.0
    for name, s, r in zip("yuv", src_planes, rec_planes):
        s = np.asarray(s, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        mse = ((s - r) ** 2).mean()
        out[name] = 99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse)
        num += mse * s.size
        den += s.size
    gmse = num / den
    out["global"] = 99.0 if gmse == 0 else 10 * np.log10(255 ** 2 / gmse)
    return out
