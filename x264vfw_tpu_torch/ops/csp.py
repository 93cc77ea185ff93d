"""Colourspace conversion front end (PyTorch).

Port of x264vfw_tpu/ops/csp.py, the reference's csp.c converter matrix
(csp.c:409-514): planar copies and subsampling, packed 4:2:2 deinterleave
(YUYV/UYVY), NV12/NV21 deinterleave, fixed-point RGB->YUV with BT.601,
BT.709 and BT.2020 matrices in TV or PC range (20-bit fixed point like
the reference's coefficient tables, csp.c:252-297), and the vertical
flip.  Every step is int32 tensor arithmetic on the device the planes
live on, so the card's planes equal the CPU's and the JAX package's.

Converters take channel-last uint8 or int32 tensors and return I420 int32
planes (y, u, v) unless noted.  convert_to_i420 also takes numpy arrays
and moves them to the device it is given.
"""

from __future__ import annotations

import numpy as np
import torch

FIX_BITS = 20
FIX_ROUND = 1 << (FIX_BITS - 1)


def _fix(x: float) -> int:
    return int(round(x * (1 << FIX_BITS)))


# matrix: (Kr, Kb)
_MATRICES = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
    "bt2020": (0.2627, 0.0593),
}


def _rgb_coeffs(matrix: str, fullrange: bool) -> dict:
    kr, kb = _MATRICES[matrix]
    kg = 1.0 - kr - kb
    if fullrange:
        ys, yo = 1.0, 0
        cs = 1.0
    else:
        ys, yo = 219.0 / 255.0, 16
        cs = 224.0 / 255.0
    cu = 0.5 / (1.0 - kb) * cs
    cv = 0.5 / (1.0 - kr) * cs
    return {
        "yr": _fix(kr * ys), "yg": _fix(kg * ys), "yb": _fix(kb * ys),
        "yo": yo,
        "ur": _fix(-kr * cu), "ug": _fix(-kg * cu), "ub": _fix((1 - kb) * cu),
        "vr": _fix((1 - kr) * cv), "vg": _fix(-kg * cv), "vb": _fix(-kb * cv),
    }


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def rgb_to_i420(rgb: torch.Tensor, matrix: str = "bt601",
                fullrange: bool = False, bgr: bool = False):
    """(H, W, 3) uint8 -> (y, u, v) I420 int32.  Even dims required."""
    rgb = _i32(rgb)
    if bgr:
        r, g, b = rgb[..., 2], rgb[..., 1], rgb[..., 0]
    else:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    c = _rgb_coeffs(matrix, fullrange)
    y = (c["yr"] * r + c["yg"] * g + c["yb"] * b + FIX_ROUND) >> FIX_BITS
    y = (y + c["yo"]).clamp(0, 255)
    # chroma on 2x2 averaged RGB (full-swing average like swscale default)
    r2, g2, b2 = _avg2x2(r), _avg2x2(g), _avg2x2(b)
    u = ((c["ur"] * r2 + c["ug"] * g2 + c["ub"] * b2 + FIX_ROUND)
         >> FIX_BITS) + 128
    v = ((c["vr"] * r2 + c["vg"] * g2 + c["vb"] * b2 + FIX_ROUND)
         >> FIX_BITS) + 128
    return y, u.clamp(0, 255), v.clamp(0, 255)


def i420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                matrix: str = "bt601", fullrange: bool = False
                ) -> torch.Tensor:
    """I420 -> (H, W, 3) int32 RGB (the decode path's output conversion,
    the swscale role on the reference's decompress side, codec.c:2292)."""
    kr, kb = _MATRICES[matrix]
    kg = 1.0 - kr - kb
    if fullrange:
        ys, yo, cs = 1.0, 0, 1.0
    else:
        ys, yo, cs = 255.0 / 219.0, 16, 255.0 / 224.0
    a_vr = _fix(2 * (1 - kr) * cs)
    a_ug = _fix(-2 * kb * (1 - kb) / kg * cs)
    a_vg = _fix(-2 * kr * (1 - kr) / kg * cs)
    a_ub = _fix(2 * (1 - kb) * cs)
    yf = _fix(ys)
    yv = (_i32(y) - yo) * yf
    uu = _upsample2(_i32(u) - 128)
    vv = _upsample2(_i32(v) - 128)
    r = (yv + a_vr * vv + FIX_ROUND) >> FIX_BITS
    g = (yv + a_ug * uu + a_vg * vv + FIX_ROUND) >> FIX_BITS
    b = (yv + a_ub * uu + FIX_ROUND) >> FIX_BITS
    return torch.stack([r, g, b], dim=-1).clamp(0, 255)


def _avg2x2(p: torch.Tensor) -> torch.Tensor:
    H, W = p.shape
    q = p.reshape(H // 2, 2, W // 2, 2)
    return (q.sum(dim=(1, 3), dtype=torch.int32) + 2) >> 2


def _upsample2(p: torch.Tensor) -> torch.Tensor:
    return p.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def yuyv_to_i420(packed: torch.Tensor):
    """(H, W*2) packed YUYV (4:2:2) -> I420 planes (chroma 2:1 vertical
    subsample averaging like the reference's YYUV_TO_I420)."""
    H = packed.shape[0]
    q = _i32(packed.reshape(H, -1, 4))
    y = torch.stack([q[..., 0], q[..., 2]], dim=-1).reshape(H, -1)
    u422 = q[..., 1]
    v422 = q[..., 3]
    u = (u422[0::2] + u422[1::2] + 1) >> 1
    v = (v422[0::2] + v422[1::2] + 1) >> 1
    return y, u, v


def uyvy_to_i420(packed: torch.Tensor):
    H = packed.shape[0]
    q = _i32(packed.reshape(H, -1, 4))
    y = torch.stack([q[..., 1], q[..., 3]], dim=-1).reshape(H, -1)
    u = (q[0::2, :, 0] + q[1::2, :, 0] + 1) >> 1
    v = (q[0::2, :, 2] + q[1::2, :, 2] + 1) >> 1
    return y, u, v


def yuyv_to_i422(packed: torch.Tensor):
    """Packed 4:2:2 -> planar 4:2:2 (no vertical subsample)."""
    H = packed.shape[0]
    q = _i32(packed.reshape(H, -1, 4))
    y = torch.stack([q[..., 0], q[..., 2]], dim=-1).reshape(H, -1)
    return y, q[..., 1], q[..., 3]


def nv12_to_i420(y: torch.Tensor, uv: torch.Tensor, swapped: bool = False):
    """NV12/NV21 interleaved chroma -> planar."""
    u = uv[:, 0::2]
    v = uv[:, 1::2]
    if swapped:
        u, v = v, u
    return _i32(y), _i32(u), _i32(v)


def i420_to_nv12(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    H2, W2 = u.shape
    uv = torch.stack([u, v], dim=-1).reshape(H2, W2 * 2)
    return y, uv


def yv12_to_i420(y, v, u):
    """YV12 is I420 with swapped chroma plane order."""
    return y, u, v


def vflip(*planes):
    return tuple(torch.flip(p, dims=(0,)) for p in planes)


def subsample_i420_from_i422(y, u422, v422):
    u = (_i32(u422[0::2]) + u422[1::2] + 1) >> 1
    v = (_i32(v422[0::2]) + v422[1::2] + 1) >> 1
    return y, u, v


def _on(a, device) -> torch.Tensor:
    """A tensor on `device` (numpy arrays copied there, tensors moved)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


# fourcc-style dispatch table (the reference's convert[X264VFW_CSP_MAX]
# function-pointer matrix, csp.h:46-53)
def convert_to_i420(fmt: str, data, matrix: str = "bt601",
                    fullrange: bool = False, flip: bool = False,
                    device=None):
    """data layout per fmt:
       'i420'/'yv12': (y, u, v) | 'nv12'/'nv21': (y, uv)
       'yuyv'/'uyvy': packed array | 'rgb24'/'bgr24'/'bgra'/'rgba': (H,W,C)
    device: where the conversion runs (default: the CPU, or the device of
    tensor inputs)."""
    fmt = fmt.lower()
    if fmt == "i420":
        out = tuple(_i32(_on(p, device)) for p in data)
    elif fmt == "yv12":
        out = yv12_to_i420(*(_i32(_on(p, device)) for p in data))
    elif fmt in ("nv12", "nv21"):
        out = nv12_to_i420(*(_on(p, device) for p in data),
                           swapped=(fmt == "nv21"))
    elif fmt == "yuyv":
        out = yuyv_to_i420(_on(data, device))
    elif fmt == "uyvy":
        out = uyvy_to_i420(_on(data, device))
    elif fmt in ("rgb24", "bgr24", "bgra", "rgba"):
        arr = _on(data, device)
        if fmt in ("bgra", "rgba"):
            arr = arr[..., :3]
        out = rgb_to_i420(arr, matrix=matrix, fullrange=fullrange,
                          bgr=fmt.startswith("bgr"))
    else:
        raise ValueError(f"unsupported input colorspace '{fmt}'")
    if flip:
        out = vflip(*out)
    return out
