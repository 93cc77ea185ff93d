"""Full-search SAD with in-kernel argmin per partition shape.

Port of x264vfw_tpu/ops/pallas/sad.py :: sad_partition_minima (and its
16x16 view sad16_argmin), and of sad_search_quad (and its 16x16 sum
sad_search) as a second output mode.  On a CUDA tensor the wrapper
launches the hand-written sm_90a kernels in csrc/sad.cu (minima: one CTA
per MB, each thread a tile of 5 x 4 candidate offsets; quad mode: the same
tiles over strips of 16 MBs, staged in shared memory and written as whole
plane row segments); on a CPU tensor it runs the plain PyTorch version
below, which the CPU tests hold against the JAX package and chip_smoke.py
holds the kernel against on the card.

Contract: src_y (H, W) uint8 and ref_pad (H + 2R, W + 2R) uint8 (the
reference, edge-padded by R).  cost_X = 4*SAD_X + scales[X]*(|dy|+|dx|)
for X in (16x16, 16x8, 8x16, 8x8); ties go to the smallest offset id
k = (dy+R)*K + (dx+R), K = 2R+1.  Returns int32 tensors
  v16/k16 (mbh, mbw), v168/k168 (mbh, mbw, 2 [top, bottom]),
  v816/k816 (mbh, mbw, 2 [left, right]), v8/k8 (2mbh, 2mbw).
Quad mode: the unreduced quadrant SADs (K^2, 2mbh, 2mbw) int32, entry
[k, qy, qx] the SAD of the 8x8 block at (8qy, 8qx) against the reference
displaced by (dy, dx) = (k // K - R, k % K - R).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

MAX_R = 32          # shared-memory window limit of the kernel
MAX_SCALE = 1 << 16  # keeps every cost below 2^23 (the kernel's 32-bit keys)
NAMES = ("v16", "k16", "v168", "k168", "v816", "k816", "v8", "k8")

_fns: dict = {}

# the most elements of shifted windows one window_sads step forms (the
# rest of the offsets wait for the next step): 128 MB of int16
_WINDOW_ELEMS = 1 << 26


def argmin_first(cost: torch.Tensor):
    """(N, ...) integer costs -> (index of the first minimum over dim 0,
    the minimum), from one int64 key cost * N + index: the tie-break of
    jnp.argmin, whatever order the device reduces in."""
    N = cost.shape[0]
    idx = torch.arange(N, device=cost.device).reshape(
        N, *([1] * (cost.dim() - 1)))
    key = (cost.to(torch.int64) * N + idx).amin(dim=0)
    return key % N, key // N


def window_sads(src: torch.Tensor, plane: torch.Tensor, ky: int, kx: int,
                bh: int, bw: int) -> torch.Tensor:
    """SAD of every bh x bw block of src (B, R, C) against plane
    (B, R + ky - 1, C + kx - 1) at every offset (oy, ox) in
    [0, ky) x [0, kx): (ky * kx, B, R // bh, C // bw) int32, offsets in
    row-major (oy, ox) order.  The shifted windows are strided views of
    plane, taken a few offset rows at a time."""
    plane = plane.contiguous()
    B, R, C = src.shape
    sb, sr, sc = plane.stride()
    step = max(1, _WINDOW_ELEMS // (kx * src.numel()))
    out = []
    for oy in range(0, ky, step):
        n = min(step, ky - oy)
        win = plane.as_strided((n, kx, B, R, C), (sr, sc, sb, sr, sc),
                               plane.storage_offset() + oy * sr)
        d = (src - win).abs_()
        out.append(d.reshape(n * kx, B, R // bh, bh, C // bw, bw)
                   .sum(dim=(3, 5), dtype=torch.int32))
    return torch.cat(out)


def _kernel(quad: bool = False):
    fn = _fns.get(quad)
    if fn is None:
        lib = build.load("sad")
        if quad:
            fn = lib.x264t_sad_search_quad
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 2)
        else:
            fn = lib.x264t_sad_partition_minima
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 9)
        fn.restype = ctypes.c_int
        _fns[quad] = fn
    return fn


def _out_shapes(mbh: int, mbw: int) -> dict:
    return {"v16": (mbh, mbw), "k16": (mbh, mbw),
            "v168": (mbh, mbw, 2), "k168": (mbh, mbw, 2),
            "v816": (mbh, mbw, 2), "k816": (mbh, mbw, 2),
            "v8": (2 * mbh, 2 * mbw), "k8": (2 * mbh, 2 * mbw)}


def _check(src_y: torch.Tensor, ref_pad: torch.Tensor, R: int,
           scales) -> None:
    if src_y.dtype != torch.uint8 or ref_pad.dtype != torch.uint8:
        raise TypeError(f"uint8 planes expected, got {src_y.dtype} and "
                        f"{ref_pad.dtype}")
    if src_y.device != ref_pad.device:
        raise ValueError(f"planes on {src_y.device} and {ref_pad.device}")
    if src_y.dim() != 2 or src_y.shape[0] % 16 or src_y.shape[1] % 16 \
            or min(src_y.shape) < 16:
        raise ValueError(f"src_y must be (H, W) in whole MBs, got "
                         f"{tuple(src_y.shape)}")
    if not 1 <= R <= MAX_R:
        raise ValueError(f"search radius {R} outside [1, {MAX_R}]")
    H, W = src_y.shape
    if tuple(ref_pad.shape) != (H + 2 * R, W + 2 * R):
        raise ValueError(f"ref_pad must be {(H + 2 * R, W + 2 * R)}, got "
                         f"{tuple(ref_pad.shape)}")
    if not (src_y.is_contiguous() and ref_pad.is_contiguous()):
        raise ValueError("planes must be contiguous")
    if len(scales) != 4 or any(int(s) != s or not 0 <= s <= MAX_SCALE
                               for s in scales):
        raise ValueError(f"scales must be 4 ints in [0, {MAX_SCALE}], got "
                         f"{scales}")


def sad_partition_minima(src_y: torch.Tensor, ref_pad: torch.Tensor, R: int,
                         scales: tuple = (4, 2, 2, 1)) -> dict:
    """Best (cost, offset id) per partition shape; see the module doc."""
    global LAUNCHES
    _check(src_y, ref_pad, R, scales)
    if src_y.device.type == "cpu":
        return sad_partition_minima_plain(src_y, ref_pad, R, scales)
    if src_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {src_y.device}")
    H, W = src_y.shape
    out = {k: torch.empty(s, dtype=torch.int32, device=src_y.device)
           for k, s in _out_shapes(H // 16, W // 16).items()}
    stream = torch.cuda.current_stream(src_y.device).cuda_stream
    rc = _kernel()(src_y.data_ptr(), ref_pad.data_ptr(), H, W, R,
                   *(int(s) for s in scales),
                   *(out[k].data_ptr() for k in NAMES), stream)
    if rc != 0:
        raise RuntimeError(f"sad_partition_minima launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out


def sad16_argmin(src_y: torch.Tensor, ref_pad: torch.Tensor,
                 R: int) -> torch.Tensor:
    """Best offset id per MB for cost = 4*SAD16 + (|dy|+|dx|): the
    scales=(1, 0, 0, 0) view.  Returns k16 (mbh, mbw) int32."""
    return sad_partition_minima(src_y, ref_pad, R, (1, 0, 0, 0))["k16"]


def sad_partition_minima_plain(src_y: torch.Tensor, ref_pad: torch.Tensor,
                               R: int, scales: tuple = (4, 2, 2, 1)) -> dict:
    """Plain PyTorch version (the counterpart of the JAX package's XLA
    search, device.py:352-363): the 8x8 SADs at every offset
    (window_sads), each partition shape's costs from them, and per block
    the least cost, ties to the smallest k (argmin_first)."""
    H, W = src_y.shape
    mbh, mbw = H // 16, W // 16
    K = 2 * R + 1
    s0, s1, s2, s3 = (int(s) for s in scales)
    i32 = torch.int32
    q = window_sads(src_y.to(torch.int16)[None],
                    ref_pad.to(torch.int16)[None], K, K, 8, 8)[:, 0]
    o = (torch.arange(K, device=src_y.device) - R).abs()
    pen = (o[:, None] + o[None, :]).reshape(K * K, 1, 1).to(i32)
    q4 = q.reshape(K * K, mbh, 2, mbw, 2)
    costs = {
        "16": 4 * q4.sum((2, 4), dtype=i32) + s0 * pen,
        "168": 4 * q4.sum(4, dtype=i32).transpose(2, 3) + s1 * pen[..., None],
        "816": 4 * q4.sum(2, dtype=i32) + s2 * pen[..., None],
        "8": 4 * q + s3 * pen,
    }
    out = {}
    for name, c in costs.items():
        k, v = argmin_first(c)
        out["k" + name], out["v" + name] = k.to(i32), v.to(i32)
    return {k: out[k].contiguous() for k in NAMES}


def sad_search_quad(src_y: torch.Tensor, ref_pad: torch.Tensor,
                    R: int) -> torch.Tensor:
    """Unreduced quadrant SADs (K^2, 2mbh, 2mbw) int32; see the module
    doc.  On a CUDA tensor: the kernel's quad mode."""
    global LAUNCHES
    _check(src_y, ref_pad, R, (0, 0, 0, 0))
    if src_y.device.type == "cpu":
        return sad_search_quad_plain(src_y, ref_pad, R)
    if src_y.device.type != "cuda":
        raise ValueError(f"no kernel for device {src_y.device}")
    H, W = src_y.shape
    K = 2 * R + 1
    out = torch.empty(K * K, H // 8, W // 8, dtype=torch.int32,
                      device=src_y.device)
    stream = torch.cuda.current_stream(src_y.device).cuda_stream
    rc = _kernel(quad=True)(src_y.data_ptr(), ref_pad.data_ptr(), H, W, R,
                            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sad_search_quad launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def sad_search(src_y: torch.Tensor, ref_pad: torch.Tensor,
               R: int) -> torch.Tensor:
    """16x16 SADs (K^2, mbh, mbw) int32: the sum of sad_search_quad's
    quadrants."""
    q = sad_search_quad(src_y, ref_pad, R)
    KK, qh, qw = q.shape
    return q.reshape(KK, qh // 2, 2, qw // 2, 2).sum((2, 4),
                                                     dtype=torch.int32)


def sad_search_quad_plain(src_y: torch.Tensor, ref_pad: torch.Tensor,
                          R: int) -> torch.Tensor:
    """Plain PyTorch version: one full-plane absolute difference and 8x8
    block sum per offset (the counterpart of the JAX package's XLA branch
    of inter_partition._quad_sads)."""
    H, W = src_y.shape
    K = 2 * R + 1
    src = src_y.to(torch.int32)
    ref = ref_pad.to(torch.int32)
    return torch.stack([
        (src - ref[oy:oy + H, ox:ox + W]).abs()
        .reshape(H // 8, 8, W // 8, 8).sum((1, 3), dtype=torch.int32)
        for oy in range(K) for ox in range(K)])
