"""Frame scaling, the libswscale counterpart of the decode side.

Port of x264vfw_tpu/ops/scale.py (the reference scales with sws_scale on
its decompress side, codec.c:2292).  Separable bilinear and bicubic
(Catmull-Rom) resamplers as two float32 matrix products per plane,
out = Sv @ img @ Sh^T with the same banded matrices as the JAX package,
then round half to even and clip to 0..255.

The products run in full float32 on the plane's device (never TF32).
They sum in another order than XLA does, so a sample whose exact value
lies within a rounding step of .5 can round the other way: the port's
planes are within 1 of the JAX package's (tests/test_torch_decode_session.
py states the share of samples that differ).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _bilinear_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) row-resampling matrix, center-aligned like swscale."""
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), src - 1)
        b = min(max(x0 + 1, 0), src - 1)
        m[i, a] += 1.0 - f
        m[i, b] += f
    return m


def _cubic_w(t: float) -> float:
    # Catmull-Rom (a = -0.5)
    a = -0.5
    t = abs(t)
    if t < 1:
        return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
    if t < 2:
        return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
    return 0.0


@lru_cache(maxsize=64)
def _bicubic_matrix(dst: int, src: int) -> np.ndarray:
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        total = 0.0
        for k in range(-1, 3):
            w = _cubic_w(x - (x0 + k))
            j = min(max(x0 + k, 0), src - 1)
            m[i, j] += w
            total += w
        m[i] /= max(total, 1e-6)
    return m


@contextmanager
def _full_float32():
    """float32 products without TF32 for the duration of the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def scale_plane(plane: torch.Tensor, dst_h: int, dst_w: int,
                method: str = "bicubic") -> torch.Tensor:
    """(H, W) -> (dst_h, dst_w), uint8-range int32 output."""
    src_h, src_w = plane.shape
    if (src_h, src_w) == (dst_h, dst_w):
        return plane.to(torch.int32)
    mk = _bicubic_matrix if method == "bicubic" else _bilinear_matrix
    Sv = torch.as_tensor(mk(dst_h, src_h), device=plane.device)
    Sh = torch.as_tensor(mk(dst_w, src_w), device=plane.device)
    with _full_float32():
        out = Sv @ plane.to(torch.float32) @ Sh.T
    return torch.round(out).clamp(0, 255).to(torch.int32)


def scale_i420(y, u, v, dst_w: int, dst_h: int, method: str = "bicubic"):
    """Three I420 planes (tensors) scaled to (dst_h, dst_w) luma."""
    assert dst_w % 2 == 0 and dst_h % 2 == 0
    return (scale_plane(y, dst_h, dst_w, method),
            scale_plane(u, dst_h // 2, dst_w // 2, method),
            scale_plane(v, dst_h // 2, dst_w // 2, method))
