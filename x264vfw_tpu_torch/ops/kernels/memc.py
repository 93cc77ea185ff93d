"""Quarter-pel refinement grouped by partition, plus luma motion
compensation, on the 8x8 partition grid.

Port of x264vfw_tpu/ops/pallas/memc.py :: partition_refine_mc, whose
golden model is x264vfw_tpu/encode/inter_partition.py ::
_refine_and_mc_xla.  On a CUDA tensor the wrapper launches the
hand-written sm_90a kernel in csrc/memc.cu; on a CPU tensor it runs the
plain PyTorch version below, which the CPU tests hold against the JAX
package and chip_smoke.py holds the kernel against on the card.

Contract: src (H, W) uint8; ref_pad (H + 2(R+8), W + 2(R+8)) uint8, the
reference edge-padded by R + 8; mv8i (2mbh, 2mbw, 2) int32 integer-pel
[x, y] per 8x8 block, each component in [-R, R]; part (mbh, mbw) int32 in
{0: 16x16, 1: 16x8, 2: 8x16, 3: 8x8}; sub_lv in {0, 1, 2} selects the
candidate grid of refine_deltas (1, 9 or 25 quarter-pel offsets (tx, ty),
ty outer).  Every block reads the spec's 6-tap half-pel samples
(§8.4.2.2.1) at its OWN integer vector; a candidate's prediction is the
rounded mean of its two _qpel_operands samples.  The SADs of the blocks
of one partition are summed, the partition keeps
argmin(4*SAD + |tx| + |ty|) with ties to the smallest candidate index,
and its blocks get mv8 = 4*mv8i + (tx, ty) and that candidate's
prediction.  Returns mv8 (2mbh, 2mbw, 2) int32 and pred_y (H, W) int32.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

MAX_R = 32

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("memc").x264t_partition_refine_mc
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def refine_deltas(sub_lv: int) -> list:
    """Candidate grid (tx, ty) in quarter pels around the integer best:
    [-2, 2]^2 at quarter precision, the even offsets at half, (0, 0) at
    integer precision."""
    if sub_lv >= 2:
        return [(tx, ty) for ty in range(-2, 3) for tx in range(-2, 3)]
    if sub_lv == 1:
        return [(tx, ty) for ty in (-2, 0, 2) for tx in (-2, 0, 2)]
    return [(0, 0)]


def _check(src, ref_pad, mv8i, part, R: int, sub_lv: int) -> None:
    if src.dtype != torch.uint8 or ref_pad.dtype != torch.uint8:
        raise TypeError(f"uint8 planes expected, got {src.dtype} and "
                        f"{ref_pad.dtype}")
    if mv8i.dtype != torch.int32 or part.dtype != torch.int32:
        raise TypeError(f"int32 mv8i and part expected, got {mv8i.dtype} "
                        f"and {part.dtype}")
    if src.dim() != 2 or src.shape[0] % 16 or src.shape[1] % 16 \
            or min(src.shape) < 16:
        raise ValueError(f"src must be (H, W) in whole MBs, got "
                         f"{tuple(src.shape)}")
    if not 1 <= R <= MAX_R:
        raise ValueError(f"search radius {R} outside [1, {MAX_R}]")
    if sub_lv not in (0, 1, 2):
        raise ValueError(f"sub_lv must be 0, 1 or 2, got {sub_lv}")
    H, W = src.shape
    P = R + 8
    for name, t, shape in (("ref_pad", ref_pad, (H + 2 * P, W + 2 * P)),
                           ("mv8i", mv8i, (H // 8, W // 8, 2)),
                           ("part", part, (H // 16, W // 16))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != src.device:
            raise ValueError(f"{name} on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")


def partition_refine_mc(src, ref_pad, mv8i, part, R: int, sub_lv: int = 2):
    """(mv8, pred_y); see the module doc."""
    global LAUNCHES
    _check(src, ref_pad, mv8i, part, R, sub_lv)
    if src.device.type == "cpu":
        return partition_refine_mc_plain(src, ref_pad, mv8i, part, R, sub_lv)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    H, W = src.shape
    mv8 = torch.empty(H // 8, W // 8, 2, dtype=torch.int32,
                      device=src.device)
    pred = torch.empty(H, W, dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = _kernel()(src.data_ptr(), ref_pad.data_ptr(), mv8i.data_ptr(),
                   part.data_ptr(), H, W, R, sub_lv, mv8.data_ptr(),
                   pred.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"partition_refine_mc launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return mv8, pred


def partition_refine_mc_plain(src, ref_pad, mv8i, part, R: int,
                              sub_lv: int = 2):
    """Plain PyTorch version: each 8x8 block's 10x10 sample window of the
    integer and b/h/j planes gathered at its own vector, the candidates'
    SADs summed per partition, a running minimum, and a select of the
    winner's prediction."""
    from ...encode.device import _halfpel_planes, _qpel_operands
    H, W = src.shape
    qh, qw = H // 8, W // 8
    mbh, mbw = qh // 2, qw // 2
    P = R + 8
    dev = src.device
    ref = ref_pad.to(torch.int32)
    planes = (ref, *_halfpel_planes(ref)) if sub_lv else (ref,)
    # window rows/cols: samples at offsets -1 .. 8 from the block origin
    a10 = torch.arange(10, device=dev) - 1
    ys = (P + 8 * torch.arange(qh, device=dev))[:, None, None] \
        + mv8i[..., 1].long()[:, :, None] + a10           # (qh, qw, 10)
    xs = (P + 8 * torch.arange(qw, device=dev))[None, :, None] \
        + mv8i[..., 0].long()[:, :, None] + a10
    win = [p[ys[..., :, None], xs[..., None, :]]
           for p in planes]                               # (qh, qw, 10, 10)
    blk = src.to(torch.int32).reshape(qh, 8, qw, 8).permute(0, 2, 1, 3)

    deltas = refine_deltas(sub_lv)

    def cand(tx, ty):
        (p1, x1, y1), (p2, x2, y2) = _qpel_operands(tx, ty)
        a = win[p1][..., 1 + y1:9 + y1, 1 + x1:9 + x1]
        b = win[p2][..., 1 + y2:9 + y2, 1 + x2:9 + x2]
        return (a + b + 1) >> 1

    sads = torch.stack([(blk - cand(tx, ty)).abs().sum((-2, -1))
                        for tx, ty in deltas])            # (nc, qh, qw)
    h5 = sads.reshape(-1, mbh, 2, mbw, 2)
    rep = torch.repeat_interleave
    g16 = rep(rep(h5.sum((2, 4)), 2, 1), 2, 2)
    g168 = rep(h5.sum(4).reshape(-1, qh, mbw), 2, 2)
    g816 = rep(h5.sum(2).reshape(-1, mbh, qw), 2, 1)
    p8 = rep(rep(part, 2, 0), 2, 1)[None]
    gsel = torch.where(p8 == 0, g16, torch.where(
        p8 == 1, g168, torch.where(p8 == 2, g816, sads)))
    # running minimum in candidate order: only a strictly smaller cost
    # replaces the best, so ties keep the smallest index
    best = torch.zeros(qh, qw, dtype=torch.long, device=dev)
    best_cost = gsel[0] * 4 + sum(map(abs, deltas[0]))
    for c in range(1, len(deltas)):
        cost = gsel[c] * 4 + sum(map(abs, deltas[c]))
        best = torch.where(cost < best_cost, c, best)
        best_cost = torch.minimum(cost, best_cost)
    t = torch.tensor(deltas, dtype=torch.int32, device=dev)[best]
    mv8 = (mv8i * 4 + t).to(torch.int32)

    pred = torch.zeros(qh, qw, 8, 8, dtype=torch.int32, device=dev)
    for c, (tx, ty) in enumerate(deltas):
        pred = torch.where((best == c)[..., None, None], cand(tx, ty), pred)
    return mv8.contiguous(), pred.permute(0, 2, 1, 3).reshape(H, W)
